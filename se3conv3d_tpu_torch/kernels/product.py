"""The conv's shared product alone: its Hopper kernel's wrapper
(``csrc/product.cu`` over ``csrc/wg_product.cuh``), its plain version and a
pure-Python mirror of its tile and split plan.

The conv forward and backward (``kernels/fused_equiv.py``) launch the same
kernel, ``wg_product``, from their own sources at three call sites, each a
2-D product with W shared over the out-frames g (rows: the ``L*G`` live
scratch rows, depth ``C*Q``)::

    forward  out    = basis [rows, C*Q] . W [C*Q, O]        (layout "fwd")
    d_w      d_w    = basis^T . gl [rows, O]                (layout "dw")
    dbasis   dbasis = gl . W^T                              (layout "dbasis")

which is what the TPU kernels compute in their bodies
(``se3conv3d_tpu/ops/pallas/fused_equiv.py``: ``_fwd_kernel``'s ``per_gq``
summed over q, ``_bwd_kernel``'s ``dw2`` summed over g by
``_unfold_param_grads``, and ``dbasis_b``).  :func:`product` runs one
product alone, for the card tests and ``chip_smoke.py``; nothing on the main
path calls it.

The kernel (the design note is in ``csrc/wg_product.cuh``): a persistent
grid of one block an SM walks the items (depth split, row tile of
:data:`TILE_ROWS`, column tile of :func:`tile_cols`) in a fixed order
(:func:`items`); one producer warp fills a ring of :func:`ring_stages`
shared-memory stages of 128 depth bytes by TMA (2-D tensor maps, W from
its image by ``cp.async.bulk``), and two
consumer warpgroups run ``wgmma`` (3xTF32 for float32: A split hi / lo in
registers, B from an image of K-major hi and lo tiles, :func:`image_bytes`),
each 16-deep slice summed into a zeroed accumulator and added to the
running sum by a rounded float32 add.  Depth splits (:func:`splits`) are
added in split order, so two calls give the same bits.  The functions
below mirror the C plans (``se3_product_plan``, ``se3_fused_equiv_fwd_plan``,
``se3_fused_equiv_bwd_plan``); the card tests hold them equal.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import library

__all__ = ["LAYOUTS", "product", "product_reference", "product_plan", "fwd_plan", "bwd_plan", "items",
           "splits", "split_depth", "tile_cols", "stage_depth", "image_bytes", "ring_stages"]

# the layouts by their codes in csrc/product.cu
LAYOUTS = {"fwd": 0, "dw": 1, "dbasis": 2}
TILE_ROWS = 128         # kPM: two consumer warpgroups of 64 rows
DEPTH_BYTES = 128       # kPDepthBytes: a stage's depth, 32 float32 or 64 bfloat16 values
SLOTS = 132             # kPSlots: the plans' persistent blocks, one an SM of an H100
MIN_SPLIT_DEPTH = 256   # kPMinSplitDepth
MAX_SPLITS = 64         # kPMaxSplits
MAX_STAGES = 8          # kPMaxStages
SMEM_MAX = 232448       # kSmemMax: one block's shared memory on an H100
EDGE_GRID = SLOTS * 4   # kEGrid: the conv backward's per-edge walk, 4 blocks an SM
OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def tile_cols(j: int) -> int:
    """Columns of an output tile (wgmma's N) for ``j`` output columns."""
    return 64 if j <= 64 else 128


def stage_depth(elem_bytes: int) -> int:
    """Depth of a ring stage for operands of ``elem_bytes``."""
    return DEPTH_BYTES // elem_bytes


def tiles(i: int, j: int) -> int:
    bn = tile_cols(j)
    return -(-i // TILE_ROWS) * -(-j // bn)


def round16(x: int) -> int:
    return (x + 15) // 16 * 16


def image_bytes(j: int, k: int, elem_bytes: int) -> int:
    """Bytes of B's image (``J x K``): per column tile and stage, ``BN``
    rows of 128 depth bytes, twice (hi and lo) for float32."""
    bn, ks = tile_cols(j), stage_depth(elem_bytes)
    return -(-j // bn) * -(-k // ks) * bn * DEPTH_BYTES * (2 if elem_bytes == 4 else 1)


def splits(n_tiles: int, depth: int, width: int, room: int) -> int:
    """Depth splits of a product of ``n_tiles`` tiles over ``depth``
    (``product_splits``): the ``s`` with the least ``ceil(n_tiles*s /
    SLOTS) / s`` (the fullest block's items) ``+ 2 s width / depth * n_tiles
    / SLOTS`` (the partials' traffic), at most ``room``, ``MAX_SPLITS`` and
    one split per ``MIN_SPLIT_DEPTH`` of depth."""
    s_max = min(-(-depth // MIN_SPLIT_DEPTH), room, MAX_SPLITS)
    s, best = 1, float(-(-n_tiles // SLOTS))
    for t in range(2, s_max + 1):
        cost = float(-(-(n_tiles * t) // SLOTS)) / t + 2.0 * t * width / depth * n_tiles / SLOTS
        if cost < best:
            best, s = cost, t
    return s


def split_depth(depth: int, n_splits: int, elem_bytes: int) -> int:
    """Depth of each split, a multiple of the stage depth (the last ones
    may be short or empty)."""
    ks, per = stage_depth(elem_bytes), -(-depth // n_splits)
    return -(-per // ks) * ks


def items(i: int, j: int, k: int, n_splits: int, elem_bytes: int) -> list:
    """The kernel's items in their fixed order, item ``t`` taken by block
    ``t % grid``: ``(split, row tile, column tile, first depth, end depth)``,
    the column tile fastest, then the row tile, then the split; a split
    whose first depth is not below its end is empty (its tile is zeros)."""
    per = split_depth(k, n_splits, elem_bytes)
    tj = -(-j // tile_cols(j))
    n = tiles(i, j)
    out = []
    for t in range(n * n_splits):
        z, r = divmod(t, n)
        ti, c = divmod(r, tj)
        out.append((z, ti, c, z * per, min(k, z * per + per)))
    return out


def ring_stages(elem_bytes: int, a_mn: bool, b_rows: bool, bn: int) -> tuple:
    """``(stages, shared-memory bytes)`` of one block (``Prod``): a_mn, A
    M-contiguous (d_w); b_rows, B from gl's rows (d_w: laid out by the
    consumers in float32, read as they land in bfloat16), else from the
    image."""
    ks = DEPTH_BYTES // elem_bytes
    a_bytes = TILE_ROWS * DEPTH_BYTES  # a_mn or not: 128 x 128 bytes of A a stage
    b_bytes = (2 if elem_bytes == 4 else 1) * bn * DEPTH_BYTES
    raw = ks * bn * elem_bytes if b_rows else 0
    fixed = 2 * b_bytes if b_rows and elem_bytes == 4 else 0  # float32 d_w's converted B buffers
    per_stage = (0 if b_rows else b_bytes) + a_bytes + raw
    room = SMEM_MAX - 1024 - 2 * MAX_STAGES * 8
    n = min((room - fixed) // per_stage, MAX_STAGES)
    return n, fixed + n * per_stage + 2 * n * 8 + 1024


def product_plan(layout: str, i: int, j: int, k: int, elem_bytes: int) -> tuple:
    """``(splits, scratch bytes)`` of :func:`product` (``se3_product_plan``)."""
    s = 1 if layout == "dbasis" else splits(tiles(i, j), k, j, MAX_SPLITS)
    scratch = 0 if layout == "dw" else round16(image_bytes(j, k, elem_bytes))
    return s, scratch + (s * i * j * 4 if s > 1 else 0)


def fwd_plan(n_live: int, g: int, q: int, c: int, o: int, cap_bytes: int, elem_bytes: int) -> tuple:
    """``(rows a chunk, splits, scratch bytes)`` of the conv forward
    (``se3_fused_equiv_fwd_plan``): chunks whose basis rows fill 7/8 of
    ``cap_bytes``, the rest kept for the split partials; W's image outside
    the cap."""
    cq = c * q
    part_cap = cap_bytes // 8
    lc = max(1, (cap_bytes - part_cap) // (g * cq * elem_bytes))
    if lc > n_live:
        lc = max(n_live, 1)
    n = -(-n_live // lc)
    lc = -(-n_live // n)
    rows = lc * g
    s = splits(tiles(rows, o), cq, o, part_cap // (rows * o * 4))
    scratch = round16(image_bytes(o, cq, elem_bytes)) + round16(rows * cq * elem_bytes)
    return lc, s, scratch + (s * rows * o * 4 if s > 1 else 0)


def bwd_plan(n_live: int, g: int, q: int, c: int, o: int, elem_bytes: int) -> tuple:
    """``(scratch bytes, d_w splits, d_proj blocks)`` of the conv backward
    (``se3_fused_equiv_bwd_plan``): basis and compact gout rows and W^T's
    image; the d_w splits along the rows; one d_proj partial a block of the
    per-edge pass's walk, a block a live row up to ``EDGE_GRID`` (4 an SM,
    ``kernels.fused_equiv.EDGE_GRID``)."""
    rows, cq = n_live * g, c * q
    scratch = round16(rows * cq * elem_bytes) + round16(rows * o * elem_bytes) + round16(
        image_bytes(cq, o, elem_bytes))
    return scratch, splits(tiles(cq, o), rows, o, MAX_SPLITS), min(max(n_live, 1), EDGE_GRID)


def _round_weights(w: torch.Tensor, dtype) -> torch.Tensor:
    """W as the image holds it: float32, or rounded to bfloat16."""
    return w.to(dtype).double()


def product_reference(layout: str, a: torch.Tensor, b: torch.Tensor, rowmap: Optional[torch.Tensor] = None,
                      g: int = 1, map_rows: int = 0) -> torch.Tensor:
    """Plain version of :func:`product` (the einsums of
    ``fused_equiv_fwd_reference`` / ``fused_equiv_bwd_reference``), in
    float64 from the operands as given (W rounded to the operands' dtype, as
    the image holds it), rounded once to the output's dtype."""
    if layout == "fwd":
        res = (a.double() @ _round_weights(b, a.dtype)).float()
        if rowmap is None:
            return res
        out = res.new_zeros(map_rows * g, res.shape[1])
        rows = torch.arange(res.shape[0], device=res.device)
        entry = rowmap.long()[rows // g]
        keep = (entry >= 0) & (entry < map_rows)
        out[(entry * g + rows % g)[keep]] = res[keep]
        return out
    if layout == "dw":
        return (a.double().t() @ b.double()).float()
    if layout == "dbasis":
        return (a.double() @ _round_weights(b, a.dtype).t()).to(a.dtype)
    raise ValueError(f"layout must be one of {tuple(LAYOUTS)}, got {layout!r}")


def _rows(name: str, x: torch.Tensor, width: int) -> int:
    """The row stride of a 2-D operand whose rows hold ``width`` values
    one apart (a column slice of a wider tensor is taken)."""
    if x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"{name} must be 2-D with {width} columns, got {tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1 or x.stride(0) < width:
        raise ValueError(f"{name} must have unit column stride and rows at least {width} apart, "
                         f"got strides {x.stride()}")
    return x.stride(0)


def product(layout: str, a: torch.Tensor, b: torch.Tensor, rowmap: Optional[torch.Tensor] = None,
            g: int = 1, map_rows: int = 0) -> torch.Tensor:
    """The conv's product alone at ``layout``:

    * ``"fwd"``: ``a [I, K] . b`` with ``b = W [K, J]`` float32, float32
      ``[I, J]``; with ``rowmap`` (int32 ``[I / g]``) row ``i`` goes to row
      ``rowmap[i // g] * g + i % g`` of a zeroed ``[map_rows * g, J]``, none
      where the entry lies outside ``[0, map_rows)``;
    * ``"dw"``: ``a^T . b`` with ``a [K, I]``, ``b [K, J]``, float32 ``[I, J]``;
    * ``"dbasis"``: ``a [I, K] . b^T`` with ``b = W [J, K]`` float32,
      ``[I, J]`` in the operands' dtype.

    ``a`` (and ``b`` at "dw") are float32 or bfloat16; each operand 2-D
    with unit column stride (rows may be farther apart). CPU tensors run
    :func:`product_reference`; CUDA tensors launch the kernel (counted in
    ``product.launches``) or raise.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {tuple(LAYOUTS)}, got {layout!r}")
    if a.device.type == "cpu":
        return product_reference(layout, a, b, rowmap, g, map_rows)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"a and b must lie on one CUDA device, got {a.device} and {b.device}")
    if a.dtype not in OPERAND_DTYPES:
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    want_b = a.dtype if layout == "dw" else torch.float32
    if b.dtype != want_b:
        raise TypeError(f"b must be {want_b} at layout {layout!r}, got {b.dtype}")
    if layout == "dw":
        (k, i), j = a.shape, b.shape[1]
    elif layout == "fwd":
        (i, k), j = a.shape, b.shape[1]
    else:
        (i, k), j = a.shape, b.shape[0]
    lda = _rows("a", a, a.shape[1])
    ldb = _rows("b", b, b.shape[1])
    if (layout == "dbasis" and b.shape[1] != k) or (layout != "dbasis" and b.shape[0] != k):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not share the depth at {layout!r}")
    if rowmap is not None:
        if layout != "fwd" or g < 1 or rowmap.device != a.device or rowmap.dtype != torch.int32 \
                or tuple(rowmap.shape) != (-(-i // g),) or not rowmap.is_contiguous():
            raise ValueError(f"rowmap must be a contiguous int32 [ceil(I / g)] vector on {a.device} "
                             f"(forward only, g >= 1)")
        out = torch.zeros(map_rows * g, j, dtype=torch.float32, device=a.device)
    else:
        out = torch.empty(i, j, dtype=torch.float32 if layout != "dbasis" else a.dtype, device=a.device)
    if min(i, j, k) == 0:
        return out.zero_()
    lib = library("product")
    n_splits, scratch = ctypes.c_int(), ctypes.c_longlong()
    lib.se3_product_plan(LAYOUTS[layout], i, j, k, a.element_size(), ctypes.byref(n_splits),
                         ctypes.byref(scratch))
    work = torch.empty(scratch.value, dtype=torch.uint8, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.se3_product(LAYOUTS[layout], int(a.dtype == torch.bfloat16), a.data_ptr(), lda,
                              b.data_ptr(), ldb, out.data_ptr(), j,
                              None if rowmap is None else rowmap.data_ptr(), g, map_rows, i, j, k,
                              n_splits.value, work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"product kernel launch failed: CUDA error {err}")
    product.launches += 1
    return out


# kernel launches so far (CPU calls do not count); callers may reset it
product.launches = 0
