"""The Mosaic pattern probes of ``experiments/probe_mosaic.py``, each a
Hopper CUDA kernel beside its plain PyTorch version
(``csrc/probe_mosaic.cu``; ``p11_grid_accum`` is :func:`probes.grid_column_accum`).

The JAX script's 17 probes each ran one ``pl.pallas_call`` (its
``run_kernel``, one block with whole arrays in VMEM, or p11's grid): a
product, reshape, slice, transpose or mid-index write at TM = 128, E = 32,
G = 2, D = 9, Q = 32, C = O = 64.  Here the 16 of ``run_kernel`` are four
kernels over a grid of tiles:

- ``strided_product`` (p1-p4, p8, p10, p13, p15): ``out[b, i, j] = sum_k
  A[b, i, k] * B[b, k, j]``, each operand a strided view of its input,
  float32 operands in 3xTF32 or bfloat16 operands on tensor cores with
  float32 sums; :func:`product_plan` picks the tile, the layouts and copy
  widths, the stages and, where K is long and the output tiles few (p3,
  p15), a split of K over a thread-block cluster whose partial tiles are
  added in rank order in the same launch;
- ``strided_copy`` (p5-p7, p12, p16, p17): the reshape, slice or transpose
  as a copy of a strided view.  Its 2 MB at most take a fraction of a
  microsecond at the card's byte rate, so launch latency and the work per
  element decide its time: :func:`copy_plan` collapses the view on the host
  (p5, p6 and p16 to one contiguous run, copied as float4s with no index
  math; p7 and p17 to rows of 32 floats, float4s with 32-bit index math by
  multiply-high; p12's transpose through a 32 x 33 shared-memory tile,
  128-byte reads and writes), each thread issuing 4 loads before its
  stores; any other view takes a scalar path;
- ``blockdiag_build`` (p9) and ``mid_write`` (p14).

:data:`PROBES` maps the JAX names to one wrapper per probe, each counting
its own launches (``launches``; p11 counts on ``probes.grid_column_accum``);
:data:`REFERENCES` to the plain versions, :data:`SHAPES` to the inputs the
JAX probe draws (``fresh``'s shapes and dtypes), :data:`KIND` to how a
result is held: ``copy`` bitwise, ``product`` within a share of ``max
|plain|``, ``sum`` against the sum of its terms' magnitudes.  CPU tensors
run the plain versions; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import probes
from .build import library
from .probes import _check, _stream, kernel_attributes

__all__ = ["TM", "E", "G", "D", "Q", "C", "O", "SHAPES", "KIND", "PROBES", "REFERENCES", "MOSAIC_KERNELS",
           "PRODUCT_TILES", "PRODUCT_TILE_GROUPS", "PRODUCT_SLICE", "PRODUCT_MAX_CLUSTER", "SMEM_MAX", "PRODUCT_OPERANDS",
           "COPY_PATHS", "COPY_VIEWS", "copy_plan", "product_plan", "probe_work", "mosaic_kernel_attributes"]

TM, E, G, D, Q, C, O = 128, 32, 2, 9, 32, 64, 64
_P = TM // 2
_F32, _BF16 = torch.float32, torch.bfloat16
# the kernels of csrc/probe_mosaic.cu by their index in se3_probe_mosaic_attrs
# (strided_product's instantiations by se3_probe_product_attrs)
MOSAIC_KERNELS = ("strided_copy[flat]", "strided_copy[rows]", "strided_copy[tile]", "strided_copy[scalar]",
                  "blockdiag_build", "mid_write")
# strided_copy's paths by their codes in the kernel (csrc CopyPath)
COPY_PATHS = ("flat", "rows", "tile", "scalar")
_INT32 = 2 ** 31
# strided_product (csrc/probe_mosaic.cu): block tiles (rows, columns) by
# id, 4 warps each; the depth of a staged slice; the portable cluster size;
# the shared memory one block may use on an H100
PRODUCT_TILES = ((64, 64), (32, 64), (64, 32), (32, 32), (32, 16))
# groups of 4 warps a block at most, by tile id, each group over its own
# share of the block's slices
PRODUCT_TILE_GROUPS = (1, 4, 1, 4, 4)
PRODUCT_SLICE, PRODUCT_MAX_CLUSTER, SMEM_MAX = 32, 8, 232448
# K is split until the grid holds this many blocks, each split at least
# this many slices deep; a block's slices are shared by groups of 4 warps,
# each at least this many slices
_TARGET_BLOCKS, _MIN_SLICES, _GROUP_SLICES = 64, 4, 2
# a long depth into fewer output tiles than this takes narrower tiles
_FEW_TILES = 8

# name: the (shape, dtype) of each input, as the JAX probe's fresh(...) draws them
SHAPES = {
    "p1_plain_2d": (((TM * E * G, D), _F32), ((D, Q), _F32)),
    "p2_leading_batch": (((TM, E, C), _F32), ((TM, E, Q), _F32)),
    "p3_multi_contract": (((TM, C, Q), _F32), ((C, Q, O), _F32)),
    "p4_free_dims_rhs": (((TM, E, C), _F32), ((TM, E, G, Q), _F32)),
    "p5_lane_merge": (((TM, E, G, Q), _F32),),
    "p6_sublane_split": (((TM * E * G, Q), _F32),),
    "p7_mid_slice": (((TM, E, G, Q), _F32),),
    "p8_blockdiag_batched": (((_P, 2 * C, 2 * E), _F32), ((_P, 2 * E, 2 * G * Q), _F32)),
    "p9_concat_blockdiag_build": (((TM, C, E), _F32),),
    "p10_bf16_batched": (((TM, E, C), _BF16), ((TM, E, Q), _BF16)),
    "p11_grid_accum": (((8 * TM, Q), _F32),),
    "p12_transpose_last2": (((TM, C, Q), _F32),),
    "p13_nt_contract": (((_P, E, C), _F32), ((_P, 2 * Q, C), _F32)),
    "p14_mid_write": (((TM, C), _F32),),
    "p15_dim0_contract": (((TM * E, 2 * D), _F32), ((TM * E, 2 * Q), _F32)),
    "p16_leading_split_rank2": (((TM * E, 2 * Q), _F32),),
    "p17_outer_swap": (((TM, C, Q), _F32),),
}
KIND = {name: "product" for name in ("p1_plain_2d", "p2_leading_batch", "p3_multi_contract", "p4_free_dims_rhs",
                                     "p8_blockdiag_batched", "p10_bf16_batched", "p13_nt_contract",
                                     "p15_dim0_contract")}
KIND.update({name: "copy" for name in SHAPES if name not in KIND})
KIND["p11_grid_accum"] = "sum"


# --- the plain versions: products in float32 (bfloat16 operands widened, exactly) --

def _f(x):
    return x.float()


def _blockdiag_reference(a):
    x = a.reshape(_P, 2, C, E)
    zero = torch.zeros(_P, C, E, dtype=a.dtype, device=a.device)
    top = torch.cat([x[:, 0], zero], 2)
    bot = torch.cat([zero, x[:, 1]], 2)
    return torch.cat([top, bot], 1)


REFERENCES = {
    "p1_plain_2d": lambda a, b: torch.matmul(a, b),
    "p2_leading_batch": lambda a, b: torch.matmul(a.transpose(1, 2), b),
    "p3_multi_contract": lambda a, b: torch.matmul(a.reshape(TM, C * Q), b.reshape(C * Q, O)),
    "p4_free_dims_rhs": lambda a, b: torch.matmul(a.transpose(1, 2), b.reshape(TM, E, G * Q)).reshape(TM, C, G, Q),
    "p5_lane_merge": lambda a: a.reshape(TM, E, G * Q).clone(),
    "p6_sublane_split": lambda a: a.reshape(TM, E * G, Q).clone(),
    "p7_mid_slice": lambda a: a[:, :, 1, :].contiguous(),
    "p8_blockdiag_batched": lambda a, b: torch.matmul(a, b),
    "p9_concat_blockdiag_build": _blockdiag_reference,
    "p10_bf16_batched": lambda a, b: torch.matmul(_f(a).transpose(1, 2), _f(b)),
    "p11_grid_accum": probes.grid_column_accum_reference,
    "p12_transpose_last2": lambda a: a.transpose(1, 2).contiguous(),
    "p13_nt_contract": lambda a, b: torch.matmul(a, b.transpose(1, 2)),
    "p14_mid_write": lambda a: torch.stack([a * float(q) for q in range(4)], 1),
    "p15_dim0_contract": lambda a, b: torch.matmul(a.t(), b),
    "p16_leading_split_rank2": lambda a: a.reshape(TM, E, 2 * Q).clone(),
    "p17_outer_swap": lambda a: a.transpose(0, 1).contiguous(),
}


# --- the launches -----------------------------------------------------------------

def _copy_log2(esize: int, kc: bool, strides, rows: int, k: int, batch: int, align: int) -> int:
    """log2 of the values one cp.async copy of an operand moves: along K
    (``kc``) or its rows, where that stride is 1 and the extent, the other
    strides and the base's ``align`` bytes allow it, at most 16 bytes."""
    s_b, s_r, s_k = strides
    inner, other, extent = (s_k, s_r, k) if kc else (s_r, s_k, rows)
    for vs in (3, 2, 1):
        w = 1 << vs
        if (esize << vs) <= 16 and inner == 1 and other % w == 0 and (batch == 1 or s_b % w == 0) \
                and extent % w == 0 and align % (esize * w) == 0:
            return vs
    return 0


def _align(ptr: int) -> int:
    return min(16, ptr & -ptr) if ptr else 16


def product_plan(batch: int, m: int, n: int, k: int, dtype, a_strides, b_strides, a_align: int = 16,
                 b_align: int = 16) -> dict:
    """How ``strided_product`` computes ``A [batch, m, k] @ B [batch, k,
    n]`` from views with element strides ``a_strides = (batch, i, k)`` and
    ``b_strides = (batch, k, j)`` whose bases are aligned to ``a_align`` /
    ``b_align`` bytes: the block tile (``tile``, ``bm`` x ``bn``), each
    operand's slice layout (``a_kc``: A kept depth-contiguous, where its K
    stride is 1 or its row stride is not; ``b_kc`` likewise) and copy width
    (``a_vs`` / ``b_vs``: log2 of values a copy), the split of K over a
    cluster of ``splits`` blocks of ``k_per_split`` terms (a multiple of
    :data:`PRODUCT_SLICE`), the ``groups`` of 4 warps a block (each over its
    own share of the block's slices, with a ring of its own), the ring's
    ``stages``, the dynamic shared memory ``smem`` (``product_smem`` in the
    source) and the ``grid`` (splits, tiles, batch).  Pure Python: the CPU
    tests check it."""
    esize = 2 if dtype == _BF16 else 4
    a_kc = a_strides[2] == 1 or a_strides[1] != 1
    b_kc = b_strides[1] == 1 or b_strides[2] != 1
    if n <= 32:
        tile = 2
    elif m <= 32 or batch * math.ceil(m / 64) * math.ceil(n / 64) < 8:
        tile = 1
    else:
        tile = 0
    # a long depth into few tiles: narrower tiles (32 x 32, then 32 x 16 in
    # float32) spread its split over more clusters, each block reading less
    long_depth = k >= 2 * _MIN_SLICES * PRODUCT_SLICE
    if tile == 1 and long_depth and batch * math.ceil(m / 32) * math.ceil(n / 64) < _FEW_TILES:
        tile = 3
        if esize == 4 and batch * math.ceil(m / 32) * math.ceil(n / 32) < _FEW_TILES // 2:
            tile = 4
    bm, bn = PRODUCT_TILES[tile]
    m_tiles, n_tiles = math.ceil(m / bm), math.ceil(n / bn)
    slices = math.ceil(k / PRODUCT_SLICE)
    splits = max(1, min(PRODUCT_MAX_CLUSTER, _TARGET_BLOCKS // (batch * m_tiles * n_tiles), slices // _MIN_SLICES))
    per = math.ceil(slices / splits) * PRODUCT_SLICE
    splits = math.ceil(k / per)
    groups = max(1, min(PRODUCT_TILE_GROUPS[tile], per // PRODUCT_SLICE // _GROUP_SLICES))
    stages = 3 if math.ceil(per // PRODUCT_SLICE / groups) >= 3 else 2
    padk = 16 // esize
    a_elems = bm * (PRODUCT_SLICE + padk) if a_kc else PRODUCT_SLICE * (bm + 8)
    b_elems = bn * (PRODUCT_SLICE + padk) if b_kc else PRODUCT_SLICE * (bn + 8)
    smem = groups * stages * (a_elems + b_elems) * esize
    if splits > 1 or groups > 1:
        smem = max(smem, groups * bm * bn * 4)
    return {"tile": tile, "bm": bm, "bn": bn, "groups": groups, "a_kc": a_kc, "b_kc": b_kc,
            "a_vs": _copy_log2(esize, a_kc, (a_strides[0], a_strides[1], a_strides[2]), m, k, batch, a_align),
            "b_vs": _copy_log2(esize, b_kc, (b_strides[0], b_strides[2], b_strides[1]), n, k, batch, b_align),
            "splits": splits, "k_per_split": per, "stages": stages, "smem": smem,
            "m_tiles": m_tiles, "n_tiles": n_tiles, "grid": (splits, m_tiles * n_tiles, batch)}


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [batch, M, K] @ b [batch, K, N]`` of two strided views, float32
    out ``[batch, M, N]``, in one launch."""
    batch, m, k = a.shape
    n = b.shape[2]
    plan = product_plan(batch, m, n, k, a.dtype, a.stride(), b.stride(), _align(a.data_ptr()),
                        _align(b.data_ptr()))
    out = torch.empty(batch, m, n, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_mosaic").se3_probe_strided_product(
            a.data_ptr(), b.data_ptr(), int(a.dtype == _BF16), *a.stride(), *b.stride(), batch, m, n, k,
            plan["tile"], int(plan["a_kc"]), int(plan["b_kc"]), plan["a_vs"], plan["b_vs"], plan["splits"],
            plan["k_per_split"], plan["stages"], plan["groups"], plan["smem"], out.data_ptr(), _stream(a)),
            "strided_product")
    return out


def copy_plan(shape, strides, align: int = 16) -> dict:
    """How ``strided_copy`` copies a float32 view of ``shape`` and element
    ``strides`` whose base is aligned to ``align`` bytes into a contiguous
    output: the view collapsed (size-1 dimensions dropped, each dimension
    merged into the next where its stride is the next one's extent times
    stride), at most 4 dimensions left, padded in front with extent 1 and
    stride 0 (``dims``, ``strides``), and the ``path`` it allows
    (:data:`COPY_PATHS`): ``flat`` for one contiguous run, ``rows`` where
    the last dimension is contiguous with a multiple of 4 floats and the
    other strides are multiples of 4, ``tile`` where the second-to-last
    dimension is the contiguous one (a transpose), else ``scalar``; every
    path but ``scalar`` with offsets below 2^31, the vector paths with a
    16-byte aligned base.  Pure Python: the CPU tests check it, and the C
    entry refuses a path that does not fit."""
    merged = []
    for d, s in zip(shape, strides):
        if d == 1:
            continue
        if merged and merged[-1][1] == s * d:
            merged[-1] = (merged[-1][0] * d, s)
        else:
            merged.append((d, s))
    merged = merged or [(1, 1)]
    if len(merged) > 4:
        raise ValueError(f"strided_copy takes views that collapse to at most 4 dimensions, got {tuple(shape)} "
                         f"with strides {tuple(strides)}")
    dims = [1] * (4 - len(merged)) + [d for d, _ in merged]
    strd = [0] * (4 - len(merged)) + [s for _, s in merged]
    n = math.prod(dims)
    small = n < _INT32 and sum((d - 1) * s for d, s in merged) < _INT32
    vec = align % 16 == 0
    if len(merged) == 1 and strd[3] == 1 and small and vec:
        path = "flat"
    elif strd[3] == 1 and dims[3] % 4 == 0 and all(x % 4 == 0 for x in strd[:3]) and small and vec:
        path = "rows"
    elif len(merged) >= 2 and strd[2] == 1 and small:
        path = "tile"
    else:
        path = "scalar"
    return {"dims": dims, "strides": strd, "path": path, "n": n}


# each copy probe's view of its input, as strided_copy takes it
COPY_VIEWS = {
    "p5_lane_merge": lambda a: a.reshape(TM, E, G * Q),
    "p6_sublane_split": lambda a: a.reshape(TM, E * G, Q),
    "p7_mid_slice": lambda a: a[:, :, 1, :],
    "p12_transpose_last2": lambda a: a.transpose(1, 2),
    "p16_leading_split_rank2": lambda a: a.reshape(TM, E, 2 * Q),
    "p17_outer_swap": lambda a: a.transpose(0, 1),
}


def _copy(view: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a strided float32 view, in one launch of the
    path :func:`copy_plan` picks."""
    plan = copy_plan(view.shape, view.stride(), _align(view.data_ptr()))
    out = torch.empty(view.shape, dtype=torch.float32, device=view.device)
    with torch.cuda.device(view.device):
        _check(library("probe_mosaic").se3_probe_strided_copy(view.data_ptr(), *plan["dims"], *plan["strides"],
                                                              COPY_PATHS.index(plan["path"]), out.data_ptr(),
                                                              _stream(view)), "strided_copy")
    return out


def _blockdiag(a: torch.Tensor) -> torch.Tensor:
    out = torch.empty(_P, 2 * C, 2 * E, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_mosaic").se3_probe_blockdiag_build(a.data_ptr(), _P, C, E, out.data_ptr(),
                                                                 _stream(a)), "blockdiag_build")
    return out


def _mid_write(a: torch.Tensor) -> torch.Tensor:
    out = torch.empty(a.shape[0], 4, a.shape[1], dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_mosaic").se3_probe_mid_write(a.data_ptr(), a.shape[0], 4, a.shape[1], out.data_ptr(),
                                                           _stream(a)), "mid_write")
    return out


# each product probe's operands as strided_product takes them, from its inputs
PRODUCT_OPERANDS = {
    "p1_plain_2d": lambda a, b: (a[None], b[None]),
    "p2_leading_batch": lambda a, b: (a.transpose(1, 2), b),
    "p3_multi_contract": lambda a, b: (a.reshape(1, TM, C * Q), b.reshape(1, C * Q, O)),
    "p4_free_dims_rhs": lambda a, b: (a.transpose(1, 2), b.reshape(TM, E, G * Q)),
    "p8_blockdiag_batched": lambda a, b: (a, b),
    "p10_bf16_batched": lambda a, b: (a.transpose(1, 2), b),
    "p13_nt_contract": lambda a, b: (a, b.transpose(1, 2)),
    "p15_dim0_contract": lambda a, b: (a.t()[None], b[None]),
}


# each product probe's output shape (its plain version's)
_PRODUCT_OUT = {"p1_plain_2d": (TM * E * G, Q), "p2_leading_batch": (TM, C, Q), "p3_multi_contract": (TM, O),
                "p4_free_dims_rhs": (TM, C, G, Q), "p8_blockdiag_batched": (_P, 2 * C, 2 * G * Q),
                "p10_bf16_batched": (TM, C, Q), "p13_nt_contract": (_P, E, 2 * Q), "p15_dim0_contract": (2 * D, 2 * Q)}


def _product_probe(name: str):
    operands, shape = PRODUCT_OPERANDS[name], _PRODUCT_OUT[name]
    return lambda *xs: _product(*operands(*xs)).reshape(shape)


_LAUNCH = {
    **{name: _product_probe(name) for name in PRODUCT_OPERANDS},
    **{name: (lambda a, view=view: _copy(view(a))) for name, view in COPY_VIEWS.items()},
    "p9_concat_blockdiag_build": _blockdiag,
    "p14_mid_write": _mid_write,
}


def _wrapper(name: str):
    launch, plain, shapes = _LAUNCH[name], REFERENCES[name], SHAPES[name]

    def probe(*xs: torch.Tensor) -> torch.Tensor:
        if [tuple(x.shape) for x in xs] != [s for s, _ in shapes]:
            raise ValueError(f"{name} takes inputs of shapes {[s for s, _ in shapes]}, got "
                             f"{[tuple(x.shape) for x in xs]}")
        dev = xs[0].device
        if dev.type == "cpu":
            return plain(*xs)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        for x, (_, dt) in zip(xs, shapes):
            if x.device != dev or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"{name} takes contiguous {dt} tensors on one device, got {x.dtype} on {x.device}")
        out = launch(*xs)
        probe.launches += 1
        return out

    probe.__name__ = probe.__qualname__ = name
    probe.__doc__ = f"The Mosaic probe {name} on the card (plain version for CPU tensors)."
    probe.launches = 0
    return probe


PROBES = {name: (_wrapper(name) if name in _LAUNCH else probes.grid_column_accum)
          for name in SHAPES}


def probe_work(name: str, xs, out: torch.Tensor) -> dict:
    """What probe ``name`` must do on inputs ``xs`` giving ``out``: each
    input read once and the output written once (``bytes``), and a
    product's multiply-adds (``product_flops``, 2 per term, on tensor
    cores: 3xTF32 for float32 operands)."""
    nbytes = float(sum(x.numel() * x.element_size() for x in xs) + out.numel() * out.element_size())
    flops = 0.0
    if KIND[name] == "product":
        a, _ = PRODUCT_OPERANDS[name](*xs)
        flops = 2.0 * out.numel() * a.shape[2]
    return {"product_flops": flops, "bytes": nbytes}


def product_plans() -> dict:
    """:func:`product_plan` of every product probe at its shapes (bases
    16-byte aligned, as fresh tensors are)."""
    plans = {}
    for name, operands in PRODUCT_OPERANDS.items():
        xs = [torch.empty(shape, dtype=dt, device="meta") for shape, dt in SHAPES[name]]
        a, b = operands(*xs)
        plans[name] = product_plan(a.shape[0], a.shape[1], b.shape[2], a.shape[2], a.dtype, a.stride(), b.stride())
    return plans


def mosaic_kernel_attributes() -> dict:
    """Registers, local bytes and shared memory of every kernel of
    ``csrc/probe_mosaic.cu`` (``cudaFuncGetAttributes``; needs the card):
    the strided_product instantiation of each product probe's plan, keyed
    ``strided_product<dtype,tile,A layout,B layout> (probe)``, then the others."""
    out = {}
    for name, plan in product_plans().items():
        bf16 = SHAPES[name][0][1] == _BF16
        key = (f"strided_product<{'bf16' if bf16 else 'float'},{plan['bm']}x{plan['bn']},"
               f"{'K' if plan['a_kc'] else 'M'},{'K' if plan['b_kc'] else 'N'}> ({name.split('_')[0]})")
        attrs = (ctypes.c_int * 4)()
        _check(library("probe_mosaic").se3_probe_product_attrs(int(bf16), plan["tile"], int(plan["a_kc"]),
                                                               int(plan["b_kc"]), plan["smem"],
                                                               ctypes.cast(attrs, ctypes.c_void_p)),
               "se3_probe_product_attrs")
        out[key] = {"registers": attrs[0], "local_bytes": attrs[1], "static_smem": attrs[2],
                    "dynamic_smem": attrs[3]}
    out.update({k: kernel_attributes("probe_mosaic", "se3_probe_mosaic_attrs", i)
                for i, k in enumerate(MOSAIC_KERNELS)})
    return out
