"""The probe kernels: the fused forward stage by stage, the five backward
building blocks, the streaming column sum and the accumulators into a
revisited output, each a Hopper CUDA kernel beside its plain PyTorch
version (counterparts of the Pallas kernels of
``experiments/chip_stage_time.py``, ``experiments/bisect_fused.py``,
``experiments/chip_stream.py``, ``experiments/bisect_accum.py``,
``experiments/bisect_accum2.py`` and ``probe_mosaic.py``'s
``p11_grid_accum``; the cell-conv and the other Mosaic probes are in
``cellconv_probes.py`` and ``mosaic_probes.py``).

The staged forward (``csrc/probe_stage_fwd.cu``; replaces
``chip_stage_time.py:kern`` and the kernels of ``bisect_fused.py``'s s1-s6)
computes, per query row m of E = 32 edges, G = 2 out-frames of Q = 32
basis functions and C = O = 64 channels, with D = 18 or 19 pne inputs::

    pre[m*E+e, gq]   = geo[m*E+e, :] . proj[:, gq] (+ bias[gq])
    pne              = gelu(pre)                      tanh form (jax.nn.gelu)
    basis_t[m, gq, c] = sum_e pne[m*E+e, gq] * feat[m, e, c]
    basis_b[gq, m, c] = basis_t[m, gq, c]
    per_gq[gq, m, o] = sum_c basis_b[gq, m, c] * W[gq, c, o]
    out[g, m, o]     = sum_q per_gq[g*Q+q, m, o]

and stops after one of :data:`STAGES`.  :func:`stage_forward` returns the
stage's whole tensor (``bisect_fused``'s probes; a leading batch gives
s6): one block for each tile of :data:`STAGE_ROWS` rows and chunk of
:data:`STAGE_CHUNK` gq (:func:`stage_tensor_grid`, 256 blocks at 1024
rows, two an SM), pne, the aggregation and the weight contraction on
tensor cores in 3xTF32 with feat and W streamed through each warp's
``cp.async`` ring; s1 is bound by the bytes it writes, s5 / s6 by
operations, and at these sizes by a launch's latency as much (see the
source).  :func:`stage_sum` returns the sum of the stage's values, the kernel
summing each tile of :data:`STAGE_ROWS` rows into one partial and adding
the partials in tile order, so that the stage's intermediate never
reaches HBM (``chip_stage_time``'s probes; a persistent block per SM
walks the tiles, with every product on tensor cores and W streamed
through shared memory, see the source).
With ``cdt=torch.bfloat16`` values are rounded to bfloat16 where the JAX
script casts (``CDT=bf16``): geo and proj before the first product, pne
before the aggregation, feat, basis_b before the weight product, and W;
every sum is float32, and the inputs stay float32 in memory.

The backward building blocks (``csrc/probe_bwd_ops.cu``; replace
``bisect_fused.py``'s b1-b5): :func:`gelu_jvp` (``gelu(a) + gelu'(a)``,
what ``jax.jvp`` with a tangent of ones gives), :func:`expand_groups`,
:func:`batched_contract` (the ``d_w`` contraction over rows),
:func:`rank3_accum` (a column sum over every row into one output that the
TPU grid revisited, here one launch that sums each row block in row order
and the block sums in block order, the TPU grid's order) and
:func:`merge_back`; b1 and b5 are one streaming kernel (``stream_map``,
one float4 a thread), b1 with one exponential a value
(:func:`gelu_jvp_exp_form` is its arithmetic in PyTorch).  The streaming sum (``csrc/probe_stream.cu``; replaces
``chip_stream.py:k_sum``): :func:`column_sums` of a row-major ``[R, L]``
array read once with 16-byte loads.  The accumulators
(``csrc/probe_accum.cu``): :func:`block_total_accum` (the sum of every
value of ``a`` broadcast into up to three outputs, and ``2a`` where asked:
``bisect_accum.py`` and ``bisect_accum2.py``) and
:func:`grid_column_accum` (column sums over blocks of rows added in block
order, one launch of one block: ``probe_mosaic.py``'s ``p11_grid_accum``).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (``*_reference``) for CPU tensors; there is no other fallback.
Each counts its launches (``launches``; in ``launches_by`` also
:func:`stage_forward`'s by stage, ``"[batch]"`` for a batched call,
:func:`stage_sum`'s by stage and compute dtype, :func:`column_sums`' by
width, :func:`block_total_accum`'s by its outputs, :func:`accum_tag`).  The
kernels' sums run in other orders than the plain versions';
:func:`rank3_accum`, :func:`column_sums`, :func:`stage_sum`,
:func:`block_total_accum` and :func:`grid_column_accum` add their partials
in a fixed order, so two calls give the same bits.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .build import library

__all__ = [
    "STAGES", "STAGE_E", "STAGE_G", "STAGE_Q", "STAGE_C", "STAGE_O", "STAGE_MAX_D",
    "gelu_tanh", "gelu_tanh_grad",
    "stage_forward", "stage_forward_reference", "stage_sum", "stage_sum_reference",
    "stage_work", "stage_kernel_attributes", "STAGE_ROWS", "STAGE_CHUNK", "stage_tiles", "stage_w_l2_bytes",
    "stage_tensor_grid", "stage_tensor_writes",
    "gelu_jvp", "gelu_jvp_reference", "expand_groups", "expand_groups_reference",
    "batched_contract", "batched_contract_reference", "rank3_accum", "rank3_accum_reference",
    "RANK3_GROUP", "RANK3_TARGET_BLOCKS", "rank3_accum_plan", "rank3_accum_writes", "rank3_in_kernel_order",
    "merge_back", "merge_back_reference", "GELU_JVP_CLAMP", "FDIVIDEF_ZERO_PAST", "gelu_jvp_exp_form",
    "stream_kernel_attributes",
    "column_sums", "column_sums_reference",
    "accum_tag", "block_total_accum", "block_total_accum_reference", "grid_column_accum",
    "grid_column_accum_reference", "grid_column_in_kernel_order", "column_partials_bytes",
    "COLUMN_PARTIALS_MAX_BYTES", "TM", "ACCUM_KERNELS", "ACCUM_THREADS", "accum_plan", "accum_blocks",
    "block_total_in_kernel_order", "kernel_attributes", "accum_kernel_attributes",
]

# the stages by their codes in the kernel (csrc Stage); "reduce" is the whole forward
STAGES = {"pne": 0, "agg": 1, "swap": 2, "wcontract": 3, "reduce": 4}
_TENSOR, _TILE_SUM = 0, 1
# the staged forward's fixed widths (the JAX scripts'): edges per row,
# out-frames, basis functions, channels in and out; pne inputs at most
STAGE_E, STAGE_G, STAGE_Q, STAGE_C, STAGE_O = 32, 2, 32, 64, 64
STAGE_GQ = STAGE_G * STAGE_Q
STAGE_MAX_D = 19
# query rows a block of the whole-tensor mode and a tile of the tile-sum
# mode hold (csrc/probe_stage_fwd.cu's kRows): M must be a multiple
STAGE_ROWS = 16
# gq a block of the whole-tensor mode computes (csrc kQC): the 16 rows of
# the pne and aggregation products; an out-frame is two chunks
STAGE_CHUNK = 16
_TENSOR_THREADS = 256
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_CUBIC = 0.044715


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (``approximate=True``): the tanh form."""
    return F.gelu(x, approximate="tanh")


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """The derivative of :func:`gelu_tanh`, in closed form."""
    t = torch.tanh(_SQRT_2_OVER_PI * (x + _GELU_CUBIC * x * x * x))
    return 0.5 * (1.0 + t) + x * (0.5 * (1.0 - t * t)) * (_SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_CUBIC * x * x))


def _rounded(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    return x if cdt == torch.float32 else x.to(cdt).float()


def _check_cdt(cdt) -> None:
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cdt must be torch.float32 or torch.bfloat16, got {cdt}")


def stage_forward_reference(geo, feat, proj, w, bias=None, stage="reduce", cdt=torch.float32):
    """Plain PyTorch version of :func:`stage_forward`: the stage's tensor,
    float32.  ``geo [M*E, D]``, ``feat [M, E, C]`` (or with a leading batch
    ``[B, ...]``), ``proj [D, GQ]``, ``bias [1, GQ]`` or ``[GQ]`` or None,
    ``w [GQ, C, O]``.  By stage: pne ``[M*E, GQ]``, agg (basis_t) ``[M, GQ,
    C]``, swap (basis_b) ``[GQ, M, C]``, wcontract (per_gq) ``[GQ, M, O]``,
    reduce (out) ``[G, M, O]``."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {tuple(STAGES)}, got {stage!r}")
    _check_cdt(cdt)
    squeeze = geo.dim() == 2
    if squeeze:
        geo, feat = geo[None], feat[None]
    b, m = feat.shape[0], feat.shape[1]
    pre = torch.matmul(_rounded(geo.float(), cdt), _rounded(proj.float(), cdt))
    if bias is not None:
        pre = pre + bias.float().reshape(-1)
    out = gelu_tanh(pre)                                                   # pne [B, M*E, GQ]
    if stage != "pne":
        pne = _rounded(out, cdt).reshape(b, m, STAGE_E, -1)
        out = torch.einsum("bmeq,bmec->bmqc", pne, _rounded(feat.float(), cdt))  # basis_t [B, M, GQ, C]
        if stage != "agg":
            out = _rounded(out, cdt).permute(0, 2, 1, 3).contiguous()     # basis_b [B, GQ, M, C]
            if stage != "swap":
                out = torch.matmul(out, _rounded(w.float(), cdt)[None])    # per_gq [B, GQ, M, O]
                if stage == "reduce":
                    gq, o = out.shape[1], out.shape[3]
                    out = out.reshape(b, STAGE_G, gq // STAGE_G, m, o).sum(2)  # [B, G, M, O]
    return out[0] if squeeze else out


def stage_sum_reference(geo, feat, proj, w, stage="reduce", cdt=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`stage_sum`: the sum of the stage's
    values, a 0-d float32 tensor."""
    return stage_forward_reference(geo, feat, proj, w, None, stage, cdt).sum()


def _stage_shapes(geo, feat, proj, w, bias):
    """Checks the staged forward's operands on the card; ``(B, M, D, rows
    per block)``."""
    for name, x in (("geo", geo), ("feat", feat), ("proj", proj), ("w", w), ("bias", bias)):
        if x is None:
            continue
        if x.device != geo.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {geo.device}, got "
                             f"{x.dtype} on {x.device}")
    if geo.dim() not in (2, 3) or feat.dim() != geo.dim() + 1:
        raise ValueError(f"geo [M*E, D] / [B, M*E, D] with feat [M, E, C] / [B, M, E, C], got "
                         f"{tuple(geo.shape)} and {tuple(feat.shape)}")
    geo3 = geo if geo.dim() == 3 else geo[None]
    feat4 = feat if feat.dim() == 4 else feat[None]
    b, m, e, c = feat4.shape
    d = geo3.shape[2]
    rows = STAGE_ROWS
    if (e, c) != (STAGE_E, STAGE_C) or geo3.shape[:2] != (b, m * e) or m % rows or not 1 <= d <= STAGE_MAX_D:
        raise ValueError(f"the kernel takes E = {STAGE_E}, C = {STAGE_C}, D <= {STAGE_MAX_D} and M a "
                         f"multiple of {rows}; got geo {tuple(geo.shape)}, feat {tuple(feat.shape)}")
    if tuple(proj.shape) != (d, STAGE_GQ) or tuple(w.shape) != (STAGE_GQ, STAGE_C, STAGE_O):
        raise ValueError(f"proj must be [{d}, {STAGE_GQ}] and w [{STAGE_GQ}, {STAGE_C}, {STAGE_O}], got "
                         f"{tuple(proj.shape)} and {tuple(w.shape)}")
    if bias is not None and bias.numel() != STAGE_GQ:
        raise ValueError(f"bias must hold {STAGE_GQ} values, got {tuple(bias.shape)}")
    return b, m, d, rows


def _stage_launch(geo, feat, proj, w, bias, out, part, total, b, m, d, stage, mode, cdt, wimg=None) -> None:
    lib = library("probe_stage")
    stream = torch.cuda.current_stream(geo.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(geo.device):
        err = lib.se3_probe_stage_fwd(geo.data_ptr(), feat.data_ptr(), proj.data_ptr(), ptr(bias),
                                      w.data_ptr(), ptr(wimg), ptr(out), ptr(part), ptr(total), b, m, d,
                                      STAGES[stage], mode, int(cdt == torch.bfloat16), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_stage_fwd kernel ({stage}) launch failed: CUDA error {err}")


def _stage_out_shape(stage, b, m, d):
    return {"pne": (b, m * STAGE_E, STAGE_GQ), "agg": (b, m, STAGE_GQ, STAGE_C),
            "swap": (b, STAGE_GQ, m, STAGE_C), "wcontract": (b, STAGE_GQ, m, STAGE_O),
            "reduce": (b, STAGE_G, m, STAGE_O)}[stage]


def stage_forward(geo, feat, proj, w, bias, stage="reduce"):
    """The staged forward's tensor at ``stage`` (float32 operands and
    output), as :func:`stage_forward_reference` describes.  CPU tensors run
    the plain version; CUDA tensors launch ``csrc/probe_stage_fwd.cu`` in
    its whole-tensor mode once (:func:`stage_tensor_grid`), which adds the
    bias (``[GQ]`` or ``[1, GQ]``; the plain version also takes None) as
    row D of the pne product and refuses operands not 16-byte aligned."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {tuple(STAGES)}, got {stage!r}")
    if geo.device.type == "cpu":
        return stage_forward_reference(geo, feat, proj, w, bias, stage)
    if geo.device.type != "cuda":
        raise ValueError(f"unsupported device {geo.device}")
    if bias is None:
        raise ValueError("the kernel's whole-tensor mode takes a bias")
    b, m, d, _ = _stage_shapes(geo, feat, proj, w, bias)
    out = torch.empty(_stage_out_shape(stage, b, m, d), dtype=torch.float32, device=geo.device)
    _stage_launch(geo, feat, proj, w, bias, out, None, None, b, m, d, stage, _TENSOR, torch.float32)
    key = stage if geo.dim() == 2 else f"{stage}[batch]"
    stage_forward.launches += 1
    stage_forward.launches_by[key] = stage_forward.launches_by.get(key, 0) + 1
    return out[0] if geo.dim() == 2 else out


def stage_sum(geo, feat, proj, w, stage="reduce", cdt=torch.float32, out=None) -> torch.Tensor:
    """The sum of the staged forward's values at ``stage`` (0-d float32),
    float32 or bfloat16 compute (``cdt``) on float32 operands, no bias.
    CPU tensors run :func:`stage_sum_reference`; CUDA tensors launch
    ``csrc/probe_stage_fwd.cu`` in its tile-sum mode (for 'reduce' after
    the W image, a relayout of W into the kernel's shared-memory slices),
    then add the tiles' partial sums in tile order.  The 'reduce' stage also writes the
    forward's output ``[G, M, O]`` (``[B, G, M, O]`` with a batch), as the
    JAX script's does: into ``out`` where given (contiguous float32 on the
    operands' device), else into a tensor of its own."""
    if stage not in STAGES or stage == "wcontract":
        raise ValueError(f"stage must be one of pne, agg, swap, reduce, got {stage!r}")
    _check_cdt(cdt)
    if out is not None and stage != "reduce":
        raise ValueError(f"only the 'reduce' stage writes an output, got out= for {stage!r}")
    if geo.device.type == "cpu":
        if out is None:
            return stage_sum_reference(geo, feat, proj, w, stage, cdt)
        out.copy_(stage_forward_reference(geo, feat, proj, w, None, stage, cdt))
        return out.sum()
    if geo.device.type != "cuda":
        raise ValueError(f"unsupported device {geo.device}")
    b, m, d, rows = _stage_shapes(geo, feat, proj, w, None)
    dev = geo.device
    if stage == "reduce":
        shape = _stage_out_shape(stage, b, m, d)
        if out is None:
            out = torch.empty(shape, dtype=torch.float32, device=dev)
        elif (out.device != dev or out.dtype != torch.float32 or not out.is_contiguous()
              or out.numel() != math.prod(shape)):
            raise ValueError(f"out must be a contiguous float32 tensor of {shape[1:] if geo.dim() == 2 else shape} "
                             f"on {dev}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    part = torch.empty(stage_tiles(b, m), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    wimg = (torch.empty(STAGE_GQ * STAGE_C * STAGE_O, dtype=torch.float32, device=dev)
            if stage == "reduce" else None)
    _stage_launch(geo, feat, proj, w, None, out, part, total, b, m, d, stage, _TILE_SUM, cdt, wimg)
    key = (stage, "bfloat16" if cdt == torch.bfloat16 else "float32")
    stage_sum.launches += 1
    stage_sum.launches_by[key] = stage_sum.launches_by.get(key, 0) + 1
    return total


def stage_work(stage: str, m: int, d: int, written: int = 0) -> dict:
    """What the staged forward must do up to ``stage`` over ``m`` rows
    with ``d`` pne inputs: FLOPs of the pne and aggregation products
    (``fma_flops``) and of the weight contraction (``product_flops``), and
    bytes: each input the stage needs read once (geo, then feat, then W)
    and ``written`` float32 values written."""
    edges = m * STAGE_E
    fma = 2.0 * edges * d * STAGE_GQ
    nbytes = 4.0 * (edges * d + written)
    product = 0.0
    if stage != "pne":
        fma += 2.0 * edges * STAGE_GQ * STAGE_C
        nbytes += 4.0 * edges * STAGE_C
    if stage in ("wcontract", "reduce"):
        product = 2.0 * m * STAGE_GQ * STAGE_C * STAGE_O
        nbytes += 4.0 * STAGE_GQ * STAGE_C * STAGE_O
    return {"fma_flops": fma, "product_flops": product, "bytes": nbytes}


def stage_tensor_grid(stage: str, b: int, m: int) -> dict:
    """The whole-tensor mode's launch over ``b`` batches of ``m`` rows (the
    C entry's): a block of 256 threads for each (tile of
    :data:`STAGE_ROWS` rows, chunk of :data:`STAGE_CHUNK` gq), ``grid`` x
    the tile times 4 plus the chunk, y the batch; the reduce stage in
    clusters of 2 blocks along x (``cluster``), the two chunks of one
    out-frame, which add their partial tiles in chunk order.  Pure Python:
    the CPU tests check that :func:`stage_tensor_writes` of its blocks
    covers the stage's output once."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {tuple(STAGES)}, got {stage!r}")
    chunks = STAGE_GQ // STAGE_CHUNK
    grid = (chunks * stage_tiles(1, m), b)
    return {"grid": grid, "threads": _TENSOR_THREADS, "cluster": 2 if stage == "reduce" else 1,
            "blocks": grid[0] * grid[1]}


def stage_tensor_writes(stage: str, x: int, y: int, m: int) -> tuple:
    """The part of the stage's output ``[B, ...]`` (:func:`stage_forward`'s
    batched shape) that block ``(x, y)`` of :func:`stage_tensor_grid`
    writes, as a tuple of slices: batch y, rows ``m0 = 16 (x // 4)`` .. +
    16 and gq ``16 (x % 4)`` .. + 16 of pne (as edges), basis_t, basis_b or
    per_gq; for reduce, rank ``x % 2`` of the cluster writes rows 8 (x % 2)
    .. + 8 of the tile in out-frame ``(x % 4) // 2``."""
    chunks = STAGE_GQ // STAGE_CHUNK
    m0, j = STAGE_ROWS * (x // chunks), x % chunks
    rows, gq = slice(m0, m0 + STAGE_ROWS), slice(STAGE_CHUNK * j, STAGE_CHUNK * (j + 1))
    if stage == "pne":
        return (y, slice(m0 * STAGE_E, (m0 + STAGE_ROWS) * STAGE_E), gq)
    if stage == "agg":
        return (y, rows, gq, slice(None))
    if stage in ("swap", "wcontract"):
        return (y, gq, rows, slice(None))
    half = STAGE_ROWS // 2
    return (y, j // 2, slice(m0 + half * (j % 2), m0 + half * (j % 2 + 1)), slice(None))


def stage_tiles(b: int, m: int) -> int:
    """The tile-sum mode's tiles of :data:`STAGE_ROWS` rows over ``b``
    batches of ``m`` rows (rows batch-flat; M a multiple of the tile, so no
    tile is partial), one partial sum each, indexed by the tile whichever
    block ran it and added in tile order."""
    if m % STAGE_ROWS:
        raise ValueError(f"M must be a multiple of {STAGE_ROWS}, got {m}")
    return b * m // STAGE_ROWS


def stage_w_l2_bytes(b: int, m: int, cdt=torch.float32) -> int:
    """Bytes of W the tile-sum forward reads from L2 at ``b`` x ``m`` rows:
    every tile streams the whole W image (float32, or bfloat16 rounded)
    through its shared memory once, shared by the tile's rows."""
    return stage_tiles(b, m) * STAGE_GQ * STAGE_C * STAGE_O * (2 if cdt == torch.bfloat16 else 4)


def stage_kernel_attributes(stage: str, tile_sum: bool, cdt=torch.float32) -> dict:
    """Registers, local (stack and spill) bytes, shared memory and blocks
    an SM of one instantiation of the staged forward
    (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
    needs the card): whole-tensor mode in float32 with the bias (its grid
    by :func:`stage_tensor_grid`), or tile-sum mode in ``cdt`` without it,
    whose persistent grid is at most ``grid_blocks`` (blocks an SM times
    the SMs; 0 in whole-tensor mode)."""
    attrs = (ctypes.c_int * 6)()
    err = library("probe_stage").se3_probe_stage_attrs(
        STAGES[stage], _TILE_SUM if tile_sum else _TENSOR, int(cdt == torch.bfloat16),
        ctypes.cast(attrs, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"probe_stage_fwd has no instantiation for {stage} tile_sum={tile_sum} "
                           f"{cdt}: CUDA error {err}")
    return {"registers": attrs[0], "local_bytes": attrs[1], "static_smem": attrs[2], "dynamic_smem": attrs[3],
            "blocks_per_sm": attrs[4], "grid_blocks": attrs[5]}


stage_forward.launches = 0
stage_forward.launches_by = {}
stage_sum.launches = 0
stage_sum.launches_by = {}


# --- the backward building blocks ---------------------------------------------

def _on_card(name, *xs) -> bool:
    """False for CPU tensors (the plain version runs); True for contiguous
    float32 CUDA tensors on one device; raises otherwise."""
    dev = xs[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for x in xs:
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors on one device, got {x.dtype} on {x.device}")
    return True


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def gelu_jvp_reference(a: torch.Tensor) -> torch.Tensor:
    return gelu_tanh(a) + gelu_tanh_grad(a)


# where gelu_tanh_jvp clamps its base-2 exponent (csrc/probe_common.cuh),
# and where its __fdividef(1, 1 + e) is 0 (CUDA's stated range: a divisor
# past 2^126)
GELU_JVP_CLAMP, FDIVIDEF_ZERO_PAST = 127.0, 2.0 ** 126


def gelu_jvp_exp_form(a: torch.Tensor) -> torch.Tensor:
    """:func:`gelu_jvp`'s kernel arithmetic (``gelu_tanh_jvp``) in float32
    PyTorch, ``torch.exp2`` and a division standing in for the card's
    ``ex2.approx`` and ``__fdividef`` (0 for a divisor past 2^126, as
    there): e = 2^min(x (A + B x^2), 127) = exp(-2u), A = -2 log2(e)
    sqrt(2/pi), B = 0.044715 A, s = 1 / (1 + e), g = x (2 sqrt(2/pi) + 6 *
    0.044715 sqrt(2/pi) x^2), and s (x + 1 + (e s) g)."""
    a_, b_ = -2.0 * _SQRT_2_OVER_PI / math.log(2.0), -2.0 * _SQRT_2_OVER_PI / math.log(2.0) * _GELU_CUBIC
    g1, g3 = 2.0 * _SQRT_2_OVER_PI, 6.0 * _GELU_CUBIC * _SQRT_2_OVER_PI
    x = a.float()
    x2 = x * x
    e = torch.exp2(torch.clamp(x * (a_ + b_ * x2), max=GELU_JVP_CLAMP))
    d = 1.0 + e
    s = torch.where(d > FDIVIDEF_ZERO_PAST, torch.zeros_like(d), 1.0 / d)
    return s * ((x + 1.0) + (e * s) * (x * (g1 + g3 * x2)))


def _stream_map(symbol: str, a: torch.Tensor, out: torch.Tensor, name: str) -> None:
    """Launches b1's or b5's C entry on ``a`` into ``out``: one float4 a
    thread, so ``a`` holds a positive multiple of 4 floats, fewer than 2^33
    (32-bit float4 indices), at a 16-byte aligned address."""
    if a.numel() < 4 or a.numel() % 4 or a.numel() // 4 >= 2**31 or a.data_ptr() % 16:
        raise ValueError(f"{name} takes a positive multiple of 4 floats, fewer than 2^33, at a 16-byte aligned "
                         f"address, got {a.numel()} floats {a.data_ptr() % 16} bytes past one")
    with torch.cuda.device(a.device):
        _check(getattr(library("probe_bwd"), symbol)(a.data_ptr(), out.data_ptr(), a.numel(), _stream(a)), name)


def gelu_jvp(a: torch.Tensor) -> torch.Tensor:
    """``gelu(a) + gelu'(a)`` (tanh form), elementwise (b1).  CUDA tensors
    launch one streaming kernel (one float4 a thread) with one exponential
    an element (:func:`gelu_jvp_exp_form`): ``a`` contiguous float32, a
    positive multiple of 4 values, 16-byte aligned."""
    if not _on_card("gelu_jvp", a):
        return gelu_jvp_reference(a)
    out = torch.empty_like(a)
    _stream_map("se3_probe_gelu_jvp", a, out, "gelu_jvp")
    gelu_jvp.launches += 1
    return out


def expand_groups_reference(a: torch.Tensor, q: int) -> torch.Tensor:
    g = a.shape[0]
    return a[:, None].expand(g, q, *a.shape[1:]).reshape(g * q, *a.shape[1:])


def expand_groups(a: torch.Tensor, q: int) -> torch.Tensor:
    """``a [G, ...]`` -> ``[G*Q, ...]``, row ``g*Q + q`` a copy of row g (b2)."""
    if not _on_card("expand_groups", a):
        return expand_groups_reference(a, q)
    g = a.shape[0]
    out = torch.empty((g * q, *a.shape[1:]), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_bwd").se3_probe_expand_groups(a.data_ptr(), out.data_ptr(), g, q,
                                                            a.numel() // max(g, 1), _stream(a)),
               "expand_groups")
    expand_groups.launches += 1
    return out


def batched_contract_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.transpose(1, 2), b)


def batched_contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out[gq, c, o] = sum_m a[gq, m, c] * b[gq, m, o]``: ``[GQ, R, C]`` x
    ``[GQ, R, O]`` -> ``[GQ, C, O]`` (b3)."""
    if not _on_card("batched_contract", a, b):
        return batched_contract_reference(a, b)
    gq, r, c = a.shape
    o = b.shape[2]
    if b.shape[:2] != (gq, r) or c % 4 or o % 4:
        raise ValueError(f"a [GQ, R, C] and b [GQ, R, O] with C, O multiples of 4, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    out = torch.empty(gq, c, o, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_bwd").se3_probe_batched_contract(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                                               gq, r, c, o, _stream(a)), "batched_contract")
    batched_contract.launches += 1
    return out


def rank3_accum_reference(a: torch.Tensor, gq: int, o: int, rows: int) -> torch.Tensor:
    s = torch.zeros(a.shape[1], dtype=torch.float32, device=a.device)
    for blk in a.reshape(-1, rows, a.shape[1]):  # the TPU grid's steps, in order
        s = s + blk.sum(0)
    return s[None, :, None].expand(gq, a.shape[1], o).contiguous()


# b4's kernel (csrc/probe_bwd_ops.cu colsum_broadcast): the columns a block
# sums, and the blocks its plan aims at (each block reads its columns over
# every row, so more blocks read ``a`` again: 64 beat 128 at the bisect
# shape)
RANK3_GROUP, RANK3_TARGET_BLOCKS = 8, 64


def rank3_accum_plan(c: int, gq: int) -> dict:
    """:func:`rank3_accum`'s launch for ``C = c`` columns broadcast to
    ``gq`` rows: a block for each group of :data:`RANK3_GROUP` columns
    (``groups``, grid x) and each slab of ``slab`` gq (grid y, at most
    65,535; a block walks slabs ``y, y + grid_y, ...``), the slab as small
    as keeps the blocks near :data:`RANK3_TARGET_BLOCKS`.  Pure Python; the
    C entry takes ``slab`` and recomputes the grid, and the CPU tests check
    that :func:`rank3_accum_writes` covers the output once."""
    groups = -(-c // RANK3_GROUP)
    slab = max(1, -(-groups * gq // RANK3_TARGET_BLOCKS))
    slabs = -(-gq // slab)
    grid = (groups, min(slabs, 65535))
    return {"groups": groups, "slab": slab, "slabs": slabs, "grid": grid, "blocks": grid[0] * grid[1]}


def rank3_accum_writes(plan: dict, x: int, y: int, c: int, gq: int) -> list:
    """The ``(gq rows, columns)`` slices of ``out [gq, C, O]`` (every o)
    that block ``(x, y)`` of :func:`rank3_accum_plan` writes: columns
    ``8x .. 8x + 7`` (fewer in the last group) of its slabs."""
    cols = slice(RANK3_GROUP * x, min(RANK3_GROUP * (x + 1), c))
    step = plan["grid"][1] * plan["slab"]
    return [(slice(g0, min(g0 + plan["slab"], gq)), cols) for g0 in range(y * plan["slab"], gq, step)]


def rank3_in_kernel_order(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``[C]``: the column sums :func:`rank3_accum`'s kernel broadcasts, in
    its order: each block of ``rows`` rows summed column by column in row
    order from zero, then the block sums added in block order from zero.
    Plain PyTorch, on any device."""
    blocks = a.float().reshape(-1, rows, a.shape[1])
    run = torch.zeros(blocks.shape[0], a.shape[1], dtype=torch.float32, device=a.device)
    for r in range(rows):
        run = run + blocks[:, r]
    s = torch.zeros(a.shape[1], dtype=torch.float32, device=a.device)
    for blk in run:
        s = s + blk
    return s


def rank3_accum(a: torch.Tensor, gq: int, o: int, rows: int) -> torch.Tensor:
    """``out[g, c, o] = sum_m a[m, c]`` for ``a [S*rows, C]``, broadcast
    to ``[gq, C, o]``: each block of ``rows`` rows summed on its own, the
    block sums added in block order (b4).  CUDA tensors launch one kernel
    (:func:`rank3_accum_plan`), no scratch: each block stages its columns'
    rows in shared memory, sums each row block's column in row order from
    zero and the block sums in block order from zero (the TPU grid's
    order), and writes its gq slabs; two calls give the same bits.  The
    kernel takes S, rows, C, gq and o of 1 or more."""
    if a.dim() != 2 or rows < 1 or a.shape[0] % rows:
        raise ValueError(f"a must be [S * {rows}, C], got {tuple(a.shape)}")
    if not _on_card("rank3_accum", a):
        return rank3_accum_reference(a, gq, o, rows)
    s, c = a.shape[0] // rows, a.shape[1]
    if min(s, c, gq, o) < 1:
        raise ValueError(f"the kernel takes S, C, gq and o of 1 or more, got {s}, {c}, {gq}, {o}")
    out = torch.empty(gq, c, o, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_bwd").se3_probe_rank3_accum(a.data_ptr(), out.data_ptr(), s, rows, c, gq, o,
                                                          rank3_accum_plan(c, gq)["slab"], _stream(a)),
               "rank3_accum")
    rank3_accum.launches += 1
    return out


def merge_back_reference(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(-1, a.shape[-1]) * 2.0


def merge_back(a: torch.Tensor) -> torch.Tensor:
    """``[TM, E, GQ]`` -> ``[TM*E, GQ]``, times 2 (b5), bit for bit: CUDA
    tensors launch :func:`gelu_jvp`'s streaming kernel with ``2 v`` for its
    map, on the same terms."""
    if not _on_card("merge_back", a):
        return merge_back_reference(a)
    out = torch.empty(a.numel() // a.shape[-1], a.shape[-1], dtype=torch.float32, device=a.device)
    _stream_map("se3_probe_scale2", a, out, "merge_back")
    merge_back.launches += 1
    return out


def stream_kernel_attributes(op: str) -> dict:
    """:func:`kernel_attributes` of ``stream_map`` for ``op`` ``"gelu_jvp"``
    or ``"merge_back"``."""
    return kernel_attributes("probe_bwd", "se3_probe_stream_attrs", {"gelu_jvp": 0, "merge_back": 1}[op])


for _fn in (gelu_jvp, expand_groups, batched_contract, rank3_accum, merge_back):
    _fn.launches = 0


# --- the streaming sum ----------------------------------------------------------

def column_sums_reference(x: torch.Tensor) -> torch.Tensor:
    cols = x.float().sum(0)
    return torch.cat([cols, cols.sum()[None]])


def column_sums(x: torch.Tensor) -> torch.Tensor:
    """``[L + 1]`` float32: the column sums of a row-major ``x [R, L]``,
    then their sum in column order.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/probe_stream.cu`` (L of 19, 64, 128 or
    another divisor of 2^10 * 5 * 11 * 19 up to 1024; ``R * L`` a multiple of 4)."""
    if x.dim() != 2:
        raise ValueError(f"x must be [R, L], got {tuple(x.shape)}")
    if not _on_card("column_sums", x):
        return column_sums_reference(x)
    r, width = x.shape
    lib = library("probe_stream")
    part = torch.empty(lib.se3_probe_stream_blocks() * width, dtype=torch.float32, device=x.device)
    out = torch.empty(width + 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _check(lib.se3_probe_column_sums(x.data_ptr(), r, width, part.data_ptr(), out.data_ptr(), _stream(x)),
               "column_sums")
    column_sums.launches += 1
    column_sums.launches_by[width] = column_sums.launches_by.get(width, 0) + 1
    return out


column_sums.launches = 0
column_sums.launches_by = {}


# --- the accumulators into a revisited output -------------------------------------

# the kernels of csrc/probe_accum.cu by their index in se3_probe_accum_attrs
ACCUM_KERNELS = ("block_total_accum<dfeat>", "block_total_accum", "grid_column_accum")
_MAX_ACCUM_OUTS = 3
# rows of a's leading dimension in one TPU grid block, in every accumulator probe
TM = 128
# block_total_accum's threads a block (csrc/probe_accum.cu: kAccThreads)
ACCUM_THREADS = 512
# grid_column_accum's block keeps S * C float32 partials in shared memory
# (csrc/probe_accum.cu: kColMaxSmem, an H100 block's 227 KB)
COLUMN_PARTIALS_MAX_BYTES = 232448
# a block's share of a starts on a 128-byte line: a multiple of 8 float4s
_SHARE_ALIGN = 8
_accum_blocks = {}


def accum_tag(shapes, with_dfeat: bool) -> str:
    """:func:`block_total_accum`'s key in ``launches_by``: the outputs'
    shapes, then ``dfeat``, e.g. ``"18x64+1x64+64x64x64+dfeat"``."""
    return "+".join(["x".join(map(str, s)) for s in shapes] + (["dfeat"] if with_dfeat else []))


def block_total_accum_reference(a: torch.Tensor, shapes, with_dfeat: bool = True) -> list:
    """Plain PyTorch version of :func:`block_total_accum`: the blocks of
    :data:`TM` rows summed on their own and added in block order from zero,
    as the TPU grid did."""
    s = torch.zeros((), dtype=torch.float32, device=a.device)
    for blk in a.split(TM, 0):
        s = s + blk.sum()
    outs = [s.expand(shape).clone() for shape in shapes]
    return ([a * 2.0] if with_dfeat else []) + outs


def accum_plan(n: int, blocks: int) -> dict:
    """How :func:`block_total_accum`'s persistent grid of ``blocks`` blocks
    splits ``a``'s ``n`` values (``n % 4 == 0``): ``per`` float4s a block
    (a multiple of 8, so each share starts on a 128-byte line), block b
    streaming ``[b * per, (b + 1) * per)`` clipped to ``n / 4`` (``shares``;
    the last may be short, later ones empty)."""
    if n < 4 or n % 4 or blocks < 1:
        raise ValueError(f"n must be a positive multiple of 4 and blocks positive, got {n} and {blocks}")
    n4 = n // 4
    per = -(-n4 // blocks)
    per = -(-per // _SHARE_ALIGN) * _SHARE_ALIGN
    return {"blocks": blocks, "per": per, "shares": [(min(n4, b * per), min(n4, (b + 1) * per)) for b in range(blocks)]}


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """``probe_common.cuh``'s ``block_sum`` of each row of ``v [B, T]``
    (T threads): a warp's xor-shuffle tree (lane 0 adds its own value and
    its partner's, 16 lanes apart, then 8, ...), then the warps' sums in
    warp order from zero."""
    w = v.reshape(v.shape[0], -1, 32)
    for o in (16, 8, 4, 2, 1):
        w = w[..., :o] + w[..., o:2 * o]
    s = torch.zeros(v.shape[0], dtype=v.dtype, device=v.device)
    for k in range(w.shape[1]):
        s = s + w[:, k, 0]
    return s


def block_total_in_kernel_order(a: torch.Tensor, blocks: int) -> torch.Tensor:
    """The float32 total :func:`block_total_accum`'s kernel computes with a
    grid of ``blocks``, in its order (``csrc/probe_accum.cu``): thread t of
    block b adds ``(x + y) + (z + w)`` of the float4s ``b*per + t +
    j*512``, j = 0, 1, ..., into one run from zero; each block's runs by
    :func:`_block_sum` into a partial; then thread t adds the partials t, t
    + 512, ... from zero and :func:`_block_sum` gives the total.  Padding
    the shares with zeros changes no run.  Plain PyTorch, on any device."""
    plan = accum_plan(a.numel(), blocks)
    per, t = plan["per"], ACCUM_THREADS
    x = a.reshape(-1).float()
    x = F.pad(x, (0, 4 * blocks * per - x.numel())).view(blocks, per, 4)
    x = F.pad(x, (0, 0, 0, -(-per // t) * t - per)).view(blocks, -1, t, 4)
    quads = (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])
    run = torch.zeros(blocks, t, dtype=torch.float32, device=a.device)
    for j in range(quads.shape[1]):
        run = run + quads[:, j]
    part = _block_sum(run)
    part = F.pad(part, (0, -(-blocks // t) * t - blocks)).view(-1, t)
    run = torch.zeros(1, t, dtype=torch.float32, device=a.device)
    for q in range(part.shape[0]):
        run = run + part[q]
    return _block_sum(run)[0]


def accum_blocks(device) -> int:
    """The persistent grid of :func:`block_total_accum` on CUDA ``device``
    (``se3_probe_accum_blocks``: blocks an SM that fit at once, at most 2,
    times the SMs), asked once per device."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _accum_blocks:
        with torch.cuda.device(idx):
            blocks = library("probe_accum").se3_probe_accum_blocks()
        if blocks < 1:
            raise RuntimeError(f"se3_probe_accum_blocks failed: CUDA error {-blocks}")
        _accum_blocks[idx] = blocks
    return _accum_blocks[idx]


def block_total_accum(a: torch.Tensor, shapes, with_dfeat: bool = True) -> list:
    """``[dfeat] + outs``: ``dfeat = 2a`` (where ``with_dfeat``) and one
    float32 tensor per shape of ``shapes`` (at most three), every element
    the sum of every value of ``a [S*TM, ...]``: the accumulators of
    ``experiments/bisect_accum.py`` and ``bisect_accum2.py``, which added
    each grid block's total into outputs zeroed at step 0 (``bisect_accum``
    writes its dW2 as ``broadcast(red[...]) * 0 + sum(red)``, the block
    total for finite values: the ``* 0`` term only turns an infinite one
    into NaN).  CUDA tensors launch ``csrc/probe_accum.cu`` once: a
    persistent cooperative grid (:func:`accum_blocks`, shares by
    :func:`accum_plan`) streams ``a`` once (writing ``dfeat`` on the way),
    then, after one grid-wide step, every block adds the block partials in
    a fixed order (:func:`block_total_in_kernel_order`) and writes its share
    of the outputs."""
    if a.dim() < 1 or a.shape[0] % TM or len(shapes) > _MAX_ACCUM_OUTS:
        raise ValueError(f"a must be [S * {TM}, ...] and at most {_MAX_ACCUM_OUTS} outputs, got "
                         f"{tuple(a.shape)} and {len(shapes)}")
    if not _on_card("block_total_accum", a):
        return block_total_accum_reference(a, shapes, with_dfeat)
    n = a.numel()
    plan = accum_plan(n, accum_blocks(a.device))
    lib = library("probe_accum")
    part = torch.empty(plan["blocks"], dtype=torch.float32, device=a.device)
    dfeat = torch.empty_like(a) if with_dfeat else None
    outs = [torch.empty(tuple(shape), dtype=torch.float32, device=a.device) for shape in shapes]
    slots = [(o.data_ptr(), o.numel()) for o in outs] + [(None, 0)] * (_MAX_ACCUM_OUTS - len(outs))
    with torch.cuda.device(a.device):
        _check(lib.se3_probe_block_total_accum(a.data_ptr(), n, None if dfeat is None else dfeat.data_ptr(),
                                               part.data_ptr(), plan["blocks"], plan["per"],
                                               *[v for slot in slots for v in slot], _stream(a)),
               "block_total_accum")
    key = accum_tag(shapes, with_dfeat)
    block_total_accum.launches += 1
    block_total_accum.launches_by[key] = block_total_accum.launches_by.get(key, 0) + 1
    return ([dfeat] if with_dfeat else []) + outs


def grid_column_accum_reference(a: torch.Tensor) -> torch.Tensor:
    s = torch.zeros(a.shape[1], dtype=torch.float32, device=a.device)
    for blk in a.split(TM, 0):  # the TPU grid's steps, in order
        s = s + blk.sum(0)
    return s[None]


def grid_column_in_kernel_order(a: torch.Tensor) -> torch.Tensor:
    """``[1, C]``: the column sums :func:`grid_column_accum`'s kernel
    computes, in its order (``csrc/probe_accum.cu``): each block of
    :data:`TM` rows summed column by column in row order from zero, then the
    block sums added in block order from zero.  Plain PyTorch, on any
    device."""
    blocks = a.float().reshape(-1, TM, a.shape[1])
    run = torch.zeros(blocks.shape[0], a.shape[1], dtype=torch.float32, device=a.device)
    for r in range(TM):
        run = run + blocks[:, r]
    s = torch.zeros(a.shape[1], dtype=torch.float32, device=a.device)
    for blk in run:
        s = s + blk
    return s[None]


def column_partials_bytes(a_shape) -> int:
    """Shared memory :func:`grid_column_accum`'s block takes for ``a
    [S*TM, C]``: its S * C float32 block sums."""
    return 4 * (a_shape[0] // TM) * a_shape[1]


def grid_column_accum(a: torch.Tensor) -> torch.Tensor:
    """``[1, C]``: the column sums of ``a [S*TM, C]``, each block of
    :data:`TM` rows summed on its own and the block sums added in block
    order from zero, as the TPU grid's revisited output did
    (``probe_mosaic.py``'s ``p11_grid_accum``).  CUDA tensors launch one
    block of ``csrc/probe_accum.cu`` once, no scratch: its warps sum the
    row blocks' columns in row order, their loads issued ahead, into shared
    memory, then each column's block sums are added in block order
    (:func:`grid_column_in_kernel_order`, bit for bit).  The kernel takes
    every ``a`` whose block sums fit the block's shared memory
    (:data:`COLUMN_PARTIALS_MAX_BYTES`) and refuses a larger one."""
    if a.dim() != 2 or a.shape[0] % TM or a.shape[0] == 0:
        raise ValueError(f"a must be [S * {TM}, C], got {tuple(a.shape)}")
    if not _on_card("grid_column_accum", a):
        return grid_column_accum_reference(a)
    if column_partials_bytes(a.shape) > COLUMN_PARTIALS_MAX_BYTES:
        raise ValueError(f"grid_column_accum keeps {a.shape[0] // TM} x {a.shape[1]} block sums in "
                         f"{COLUMN_PARTIALS_MAX_BYTES} bytes of shared memory at most, got {tuple(a.shape)}")
    out = torch.empty(1, a.shape[1], dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _check(library("probe_accum").se3_probe_grid_column_accum(a.data_ptr(), a.shape[0] // TM, TM, a.shape[1],
                                                                  out.data_ptr(), _stream(a)), "grid_column_accum")
    grid_column_accum.launches += 1
    return out


block_total_accum.launches = 0
block_total_accum.launches_by = {}
grid_column_accum.launches = 0


def kernel_attributes(lib_name: str, symbol: str, which: int) -> dict:
    """Registers, local (stack and spill) bytes and shared memory of kernel
    ``which`` of a probe library, through its ``*_attrs`` entry
    (``cudaFuncGetAttributes``; needs the card)."""
    attrs = (ctypes.c_int * 4)()
    err = getattr(library(lib_name), symbol)(which, ctypes.cast(attrs, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{symbol}({which}) failed: CUDA error {err}")
    return {"registers": attrs[0], "local_bytes": attrs[1], "static_smem": attrs[2], "dynamic_smem": attrs[3]}


def accum_kernel_attributes() -> dict:
    """:func:`kernel_attributes` of every kernel of ``csrc/probe_accum.cu``
    (``grid_column_accum``'s dynamic shared memory is a call's,
    :func:`column_partials_bytes`, and reads 0 here)."""
    return {k: kernel_attributes("probe_accum", "se3_probe_accum_attrs", i) for i, k in enumerate(ACCUM_KERNELS)}
