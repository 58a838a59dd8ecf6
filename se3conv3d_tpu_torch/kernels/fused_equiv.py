"""Fused equivariant PNE conv: Hopper CUDA kernels (forward and backward),
their plain PyTorch versions and the autograd Function that joins them.

Computes, for every query point m, out-frame g and output channel o::

    out[b,m,g,o] = sum_{q,c} W[c,q,o] * sum_{k,f: mask[b,m,k]}
                   gelu(P . [rel[b,m,k,g], rot6[b,m,k,g,f]] + bias)[q]
                   * feats[b, idx[b,m,k], f, c]

with exact (erf) gelu, ``P = proj_axes [9, Q]`` already scaled by the
layer's ``norm_neigh_dist`` on its three offset rows, and no normalisation
(the caller applies ``norm_num_neighs / F``).  The operands ``rel``,
``rot6`` and ``feats`` are all float32 or all bfloat16; the parameters,
the output and the parameter gradients are float32.  Gradients flow to
``feats``, ``P``, ``bias`` and ``W``; the geometry (``rel``, ``rot6``,
``idx``, ``mask``) gets none, as in the reference.

The standard (non-equivariant) geometry is the same function with
``rot6=None``: G = F = 1 and the D = 3 raw offsets ``rel [B, M, K, 1, 3]``
as the pne inputs, ``P = proj_axes [3, Q]`` (all three rows scaled by the
caller), as the TPU kernels compute it for
``se3conv3d_tpu/ops/pne_conv.py:fused_conv``.  The pne input width D is
9 with ``rot6`` and 3 without (``proj_axes`` is ``[D, Q]``); the kernels
take the standard geometry in their ``kD = 3`` instantiations, at
G*Q <= 32 (:data:`STD_MAX_Q`).

bfloat16 operands follow the TPU kernels' bf16 path (the ``cdt`` argument
of ``se3conv3d_tpu/ops/pallas/fused_equiv.py:_fwd_kernel`` /
``_bwd_kernel``): every sum is float32, and values are rounded to bfloat16
at exactly these points, in the kernels and in their plain versions alike
(:func:`_rounding`): the projection ``P`` and ``bias`` and the weights
``W`` as read; each ``pne = gelu(pre)`` (``pre`` and gelu in float32);
each ``basis`` entry before the weight contraction; in the backward
``gout``, ``dbasis = gout . W^T``, each edge's ``d_gathered`` row and each
``dpre = dpne * gelu'(pre)`` (``dpne`` and gelu' in float32) before the
``d_proj`` / ``d_bias`` sums.  The scatter mode sums the rounded rows in
float32 (``d_feats`` float32); the sorted mode stores them in a bfloat16
buffer, which the prefix sum reads as it is.  :class:`FusedEquivConv`
rounds the summed feature gradient to the features' dtype, as the JAX
package's ``.astype(feats_x.dtype)``.

Forward, ``csrc/fused_equiv_fwd.cu``: replaces
``se3conv3d_tpu/ops/pallas/fused_equiv.py:_fwd_kernel`` (reached through
``_fused_single_fwd`` / ``fused_pne_conv``).  It computes the same function,
not the TPU layout: the TPU kernel read a pre-gathered ``[M, E, C]`` feature
block and a transposed, 128-lane-packed geometry table; this one gathers
features by ``idx``/``mask`` itself and reads the per-edge geometry in its
natural ``[B, M, K, G, ...]`` layout.  At the slice's widths the per-edge
embedding ``pne [M, K*F, G*Q]`` and the gathered features are 0.5-2 GB per
conv in float32 if written out; neither leaves the chip.  It walks only the
*live rows* (:func:`live_row_table`, the query rows with at least one valid
edge, built once per neighborhood and cached on it; a padded row's output
is zero), in two passes over chunks of them.  The basis pass, shared with
the backward (``csrc/fused_equiv_common.cuh``), evaluates each edge's pne
row once into shared memory, gathers the features and writes the chunk's
``basis`` rows to an ``[Lc*G, C*Q]`` scratch; a product ``basis . W`` on
tensor cores (``mma.sync`` m16n8k8 TF32 in the 3xTF32 form: each operand
split into a TF32 high part and a TF32 remainder, three products summed in
float32, which holds float32 accuracy) reads ``W`` once per 128 rows and
stores each row at its query row, its depth ``C*Q`` split into partials
summed in a fixed order where the chunk has too few rows to fill the card.
The chunks keep the scratch within :data:`FWD_SCRATCH_BYTES`.  Two calls
give the same bits.

Backward, ``csrc/fused_equiv_bwd.cu``: replaces ``_bwd_kernel`` (reached
through ``_fused_single_bwd`` / ``fused_pne_conv_bwd`` and the lean VJP of
``ops/pne_conv.py``) together with the XLA scatter-add of per-edge feature
gradients that followed it.  The TPU summed ``dW`` and ``dproj`` across a
sequential grid; Hopper blocks run in parallel, and ``dW`` (8 MB at
C=O=256) fits in no block's shared memory.  So the backward is four
passes, each over the *live rows* only: the query rows with at least one
valid edge (:func:`live_row_table`, built once per neighborhood and cached
on it).  A row without one has a zero ``basis`` row and adds nothing to
any gradient, and the padded clouds leave most rows so (83-89% of the
ScanNet level 0).  The forward's first half writes ``basis`` to an
``[L*G, C*Q]`` scratch for the ``L`` live rows; a product ``basis^T .
gout`` gives ``d_w`` in per-row-split partials summed in a fixed order; a
product ``gout . W^T`` gives ``dbasis`` over the same scratch; and a
per-point pass recomputes pne and gelu', adds ``d_feats`` with float32
atomics straight into ``[B, N, F, C]`` (no per-edge ``[M, E, C]`` output,
masked edges skipped) and sums ``d_proj`` / ``d_bias`` per block, again
added in a fixed order.  The basis pass is the forward's, and the two
products run on the forward's 3xTF32 tensor-core product, their operand
tiles staged through shared memory by ``cp.async``, double-buffered.  The
parameter gradients are deterministic: their split boundaries depend only
on the live count;
``d_feats`` is summed by atomics in no fixed order.

Given the sort tables of the 'sorted' reduction (``sorted_slot``, the
inverse of the permutation that sorts the edges by source), the per-point
pass stores each valid edge's ``d_gathered`` row, plain, at its sorted slot
of a zeroed ``[B, M*K, F*C]`` buffer instead (the Pallas kernel's per-edge
``dfeat`` output, already permuted); ``kernels.segsum.sorted_segment_sum``
then reduces it in source order, deterministically.

``fused_equiv_fwd`` / ``fused_equiv_bwd`` launch the kernels for CUDA
tensors (the instantiation of the operands' dtype: bfloat16 operands are
never widened to reuse the float32 kernels) and run
``fused_equiv_fwd_reference`` / ``fused_equiv_bwd_reference`` for CPU
tensors, over every row whatever the live-row table; there is no other
fallback.  Each counts its launches (``launches``, ``bf16_launches`` for
those with bfloat16 operands, ``launches_by_g`` by out-frame count and
``launches_by_d`` by pne input width: 9 equivariant, 3 standard).
``fused_equiv`` is the differentiable op.  Each kernel source is built
with ``nvcc`` for ``sm_90a`` at its first launch (``kernels/build.py``).

Out-frames: the kernels take G <= 4 and G*Q <= 128 (``column_capacity``):
a pne row in shared memory holds 64 columns where G <= 2 and G*Q <= 64,
and 128 otherwise (the mixed-frame-count recipes' F = G = 4 at Q = 32), each
capacity its own instantiation, so the G <= 2 convs keep their layout and
occupancy.  A 128-column row is walked in two 64-column passes of the
register tiles (the basis pass's features and the backward's dbasis
columns are read twice); its shared memory lets fewer warps run per SM.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .build import library
from .segsum import sorted_segment_sum

__all__ = [
    "fused_equiv",
    "FusedEquivConv",
    "fused_equiv_fwd",
    "fused_equiv_fwd_reference",
    "fused_equiv_bwd",
    "fused_equiv_bwd_reference",
    "live_row_table",
    "column_capacity",
    "MAX_G",
    "MAX_GQ",
    "MAX_EDGES",
    "STD_MAX_Q",
    "FWD_SCRATCH_BYTES",
    "OPERAND_DTYPES",
]

# the operand types of rel, rot6 and feats (the kernels' instantiations)
OPERAND_DTYPES = (torch.float32, torch.bfloat16)

# a pne row in the kernels' shared memory holds 64 (g, q) columns for G <= 2
# and G*Q <= 64, or 128 for G <= 4 and G*Q <= 128 (``column_capacity``;
# csrc/fused_equiv_common.cuh ``Cols``): the kernels take G <= MAX_G and
# G*Q <= MAX_GQ
MAX_G, MAX_GQ = 4, 128
# the basis pass keeps one row's K*F pne rows in a warp's shared memory:
# the most K*F that fits, by column capacity (about 227 KB / (4 * 129) at 128;
# the standard geometry's smaller projection leaves at least as much room)
MAX_EDGES = {64: 768, 128: 432}
# the standard geometry's instantiation (kD = 3) has the narrow basis tile
# only: G = 1 and Q <= 32 (every recipe's num_basis)
STD_MAX_Q = 32
# the forward walks its live rows in chunks whose scratch (basis rows and
# depth-split partials) stays within this many bytes
FWD_SCRATCH_BYTES = 128 << 20
# the backward's dbasis product tiles its L*G rows by 128 along a grid
# dimension of at most 65535 blocks (the forward's chunks stay below it)
_MAX_SCRATCH_ROWS = 128 * 65535


def column_capacity(g: int, q: int) -> int:
    """The pne-row column capacity the kernels take ``G`` out-frames and
    ``Q`` basis functions in (64 or 128), or 0 past ``MAX_G`` / ``MAX_GQ``
    (``column_capacity`` of ``csrc/fused_equiv_common.cuh``)."""
    if g <= 2 and g * q <= 64:
        return 64
    if g <= MAX_G and g * q <= MAX_GQ:
        return 128
    return 0


def _rounding(dtype):
    """``x -> x`` rounded to the operands' ``dtype`` and widened back to
    float32: the kernels' rounding points (the identity for float32)."""
    if dtype == torch.bfloat16:
        return lambda x: x.to(torch.bfloat16).float()
    return lambda x: x


def _wide(x):
    """A bfloat16 operand widened to float32; any other (or None) as it is."""
    return x.float() if x is not None and x.dtype == torch.bfloat16 else x


def _edge_geometry(rel, rot6, f):
    """``[B, M, K, G, F, D]`` pne inputs: offsets repeated over the ``f``
    in-frames, then the 6D relative rotations (D = 9), or the offsets
    alone where ``rot6`` is None (D = 3)."""
    b, m, k, g, _ = rel.shape
    offsets = rel[:, :, :, :, None, :].expand(b, m, k, g, f, 3)
    return offsets if rot6 is None else torch.cat([offsets, rot6], -1)


def _gather(feats, idx, mask):
    """``[B, M, K, F, C]`` neighbor features, zero on invalid edges."""
    bidx = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[bidx, idx] * mask[:, :, :, None, None].to(feats.dtype)


def fused_equiv_fwd_reference(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights):
    """Plain PyTorch version of the forward kernel (same arguments, same
    result, rounding where the kernel rounds: :func:`_rounding`; ``rot6``
    None for the standard geometry)."""
    rnd = _rounding(feats.dtype)
    geo = _edge_geometry(_wide(rel), _wide(rot6), feats.shape[2])
    pre = geo @ rnd(proj_axes) + rnd(proj_biases)
    pne = rnd(F.gelu(pre))  # [B,M,K,G,F,Q], exact erf
    basis = rnd(torch.einsum("bmkfc,bmkgfq->bmgcq", _gather(_wide(feats), idx, mask), pne))
    return torch.einsum("bmgcq,cqo->bmgo", basis, rnd(conv_weights))


def live_row_table(mask: torch.Tensor) -> torch.Tensor:
    """``[L]`` int32 flat indices ``b*M + m`` of the query rows of ``mask
    [B, M, K]`` that have at least one valid edge, ascending: the rows the
    kernels work on.  One host synchronisation (to learn ``L``)."""
    return torch.nonzero(mask.any(-1).reshape(-1)).reshape(-1).to(torch.int32)


def _live_rows(live_rows, mask, rows, dev):
    """The kernels' live-row table: ``live_rows`` checked, or built from
    ``mask`` when it is None.

    The check takes the table's device, dtype, rank, contiguity and length
    (at most ``rows = B*M``), and no host synchronisation.  The kernels skip
    an entry outside ``[0, B*M)``: it reads and writes nothing, and adds
    nothing to any gradient.  Strict ascending order and no duplicates
    remain the caller's contract, as :func:`live_row_table` gives them: a
    row listed twice counts twice in the backward's parameter gradients.
    """
    if rows >= 2**31:
        raise ValueError("kernel takes fewer than 2**31 query rows")
    if live_rows is None:
        return live_row_table(mask)
    if (live_rows.device != dev or live_rows.dtype != torch.int32 or live_rows.dim() != 1
            or not live_rows.is_contiguous() or live_rows.numel() > rows):
        raise ValueError(f"live_rows must be a contiguous int32 vector of at most {rows} rows on {dev}")
    return live_rows


def _sorted_rows(d_gathered, sorted_slot):
    """``[B, M*K, F*C]``: each edge's row at its sorted slot."""
    b, m, k, f, c = d_gathered.shape
    rows = d_gathered.reshape(b, m * k, f * c)
    return torch.zeros_like(rows).scatter_(1, sorted_slot[:, :, None].expand(-1, -1, f * c), rows)


def fused_equiv_bwd_reference(rel, rot6, feats, idx, mask, proj_axes, proj_biases,
                              conv_weights, gout, sorted_slot=None):
    """Plain PyTorch version of the backward kernel: recomputes pne and basis
    and returns ``(d_feats, d_proj_axes, d_proj_biases, d_conv_weights)``;
    with ``sorted_slot`` the first is the sorted per-edge buffer of
    :func:`fused_equiv_bwd` instead (in the operands' dtype).  Rounds where
    the kernel rounds (:func:`_rounding`).

    gelu' is the closed form ``Phi(x) + x * phi(x)``, as the TPU kernel
    takes it (``se3conv3d_tpu/ops/pallas/fused_equiv.py:_act_and_grad``).
    """
    rnd = _rounding(feats.dtype)
    geo = _edge_geometry(_wide(rel), _wide(rot6), feats.shape[2])
    pre = geo @ rnd(proj_axes) + rnd(proj_biases)
    pne = rnd(F.gelu(pre))
    dact = 0.5 * (1.0 + torch.erf(pre * math.sqrt(0.5))) + pre * torch.exp(-0.5 * pre * pre) / math.sqrt(2.0 * math.pi)
    gathered = _gather(_wide(feats), idx, mask)
    basis = rnd(torch.einsum("bmkfc,bmkgfq->bmgcq", gathered, pne))
    gout = rnd(gout)
    d_w = torch.einsum("bmgcq,bmgo->cqo", basis, gout)
    dbasis = rnd(torch.einsum("bmgo,cqo->bmgcq", gout, rnd(conv_weights)))
    edge = mask[:, :, :, None, None]
    d_gathered = rnd(torch.einsum("bmkgfq,bmgcq->bmkfc", pne, dbasis)).masked_fill(~edge, 0.0)
    if sorted_slot is not None:
        d_feats = _sorted_rows(d_gathered.to(feats.dtype), sorted_slot)
    else:
        bidx = torch.arange(feats.shape[0], device=feats.device)[:, None, None].expand_as(idx)
        d_feats = torch.zeros(feats.shape, dtype=gathered.dtype, device=feats.device).index_put_(
            (bidx, idx), d_gathered, accumulate=True)
    dpne = torch.einsum("bmkfc,bmgcq->bmkgfq", gathered, dbasis)
    dpre = rnd(dpne * dact).masked_fill(~edge[..., None], 0.0)
    d_pa = torch.einsum("bmkgfq,bmkgfd->dq", dpre, geo)
    return d_feats, d_pa, dpre.sum((0, 1, 2, 3, 4)), d_w


def _check(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights):
    """The kernels' contract; returns ``(B, M, N, K, G, F, Q, C, O, D)``
    (D: 9 pne inputs with ``rot6``, 3 without: the standard geometry)."""
    tensors = dict(rel=rel, rot6=rot6, feats=feats, idx=idx, mask=mask,
                   proj_axes=proj_axes, proj_biases=proj_biases, conv_weights=conv_weights)
    if rot6 is None:
        del tensors["rot6"]
    dev = feats.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.dtype not in OPERAND_DTYPES:
        raise TypeError(f"feats must be float32 or bfloat16, got {feats.dtype}")
    for name in ("rel", "rot6")[: 1 if rot6 is None else 2]:
        if tensors[name].dtype != feats.dtype:
            raise TypeError(f"{name} must have the dtype of feats ({feats.dtype}), got {tensors[name].dtype}")
    for name in ("proj_axes", "proj_biases", "conv_weights"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    b, m, k, g, three = rel.shape
    bn, n, f, c = feats.shape
    q = proj_biases.shape[0]
    o = conv_weights.shape[2]
    d = 3 if rot6 is None else 9
    want = {
        "rel": (b, m, k, g, 3),
        "rot6": (b, m, k, g, f, 6),
        "feats": (b, n, f, c),
        "idx": (b, m, k),
        "mask": (b, m, k),
        "proj_axes": (d, q),
        "proj_biases": (q,),
        "conv_weights": (c, q, o),
    }
    for name, shape in want.items():
        if name in tensors and tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, expected {shape}"
                             + (" (the standard geometry: no rot6)" if rot6 is None else ""))
    if rot6 is None and ((g, f) != (1, 1) or q > STD_MAX_Q):
        raise ValueError(f"the standard geometry (no rot6) takes G = F = 1 and Q <= {STD_MAX_Q}, "
                         f"got G={g}, F={f}, Q={q}")
    cols = column_capacity(g, q)
    if cols == 0:
        raise ValueError(f"kernel takes G <= {MAX_G} and G*Q <= {MAX_GQ}, got G={g}, Q={q}")
    if k * f > MAX_EDGES[cols]:
        raise ValueError(f"kernel takes K*F <= {MAX_EDGES[cols]} at G={g}, G*Q={g * q} "
                         f"({cols} pne columns), got K={k}, F={f}")
    return b, m, n, k, g, f, q, c, o, d


def fused_equiv_fwd(
    rel: torch.Tensor,
    rot6: torch.Tensor,
    feats: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    proj_axes: torch.Tensor,
    proj_biases: torch.Tensor,
    conv_weights: torch.Tensor,
    live_rows: torch.Tensor = None,
) -> torch.Tensor:
    """Fused conv forward ``-> [B, M, G, O]`` float32, un-normalised.

    Args:
      rel: ``[B, M, K, G, 3]`` edge offsets in the receiver frames (the
        standard geometry: ``[B, M, K, 1, 3]`` raw offsets).
      rot6: ``[B, M, K, G, F, 6]`` 6D relative rotations, or None for the
        standard geometry (G = F = 1).
      feats: ``[B, N, F, C]`` source features; ``rel``, ``rot6`` and
        ``feats`` are all float32 or all bfloat16 (the rounding points of
        the module note).
      idx / mask: ``[B, M, K]`` int64 neighbor indices and bool validity.
      proj_axes: ``[9, Q]`` (offset rows pre-scaled), or ``[3, Q]`` for
        the standard geometry; proj_biases ``[Q]``; conv_weights
        ``[C, Q, O]``.
      live_rows: :func:`live_row_table` of ``mask`` on the device of
        ``feats``, as for :func:`fused_equiv_bwd` (see :func:`_live_rows`);
        built here, at the cost of one host synchronisation, when absent.

    CPU tensors run :func:`fused_equiv_fwd_reference` over every row,
    whatever the table; CUDA tensors launch the kernels over the live rows
    and leave the other rows zero, or launch nothing when no row is live.
    The result carries no autograd history: gradients go through
    :func:`fused_equiv`.
    """
    if feats.device.type == "cpu":
        return fused_equiv_fwd_reference(
            rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b, m, n, k, g, f, q, c, o, d = _check(
        rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights
    )
    dev = feats.device
    live_rows = _live_rows(live_rows, mask, b * m, dev)
    out = torch.zeros((b, m, g, o), dtype=torch.float32, device=dev)
    n_live = live_rows.numel()
    if n_live == 0 or c == 0 or o == 0:
        return out
    lib = library("fwd")
    bf16 = feats.dtype == torch.bfloat16
    chunk, splits, scratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    lib.se3_fused_equiv_fwd_plan(n_live, g, q, c, o, FWD_SCRATCH_BYTES, feats.element_size(),
                                 ctypes.byref(chunk), ctypes.byref(splits), ctypes.byref(scratch))
    work = torch.empty(scratch.value, dtype=torch.uint8, device=dev)  # bytes
    ptrs = (feats.data_ptr(), idx.data_ptr(), mask.data_ptr(), proj_axes.data_ptr(),
            proj_biases.data_ptr(), conv_weights.data_ptr(), live_rows.data_ptr(), out.data_ptr(),
            work.data_ptr())
    plan = (n_live, chunk.value, splits.value, int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if rot6 is None:
            err = lib.se3_fused_std_fwd(rel.data_ptr(), *ptrs, b, m, n, k, q, c, o, *plan)
        else:
            err = lib.se3_fused_equiv_fwd(rel.data_ptr(), rot6.data_ptr(), *ptrs,
                                          b, m, n, k, g, f, q, c, o, *plan)
    if err != 0:
        raise RuntimeError(f"fused_equiv_fwd kernel launch failed: CUDA error {err}")
    _count(fused_equiv_fwd, bf16, g, d)
    return out


def fused_equiv_bwd(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights, gout,
                    sorted_slot=None, live_rows=None):
    """Fused conv backward: ``gout [B, M, G, O]`` float32, the cotangent of
    the un-normalised output, ``-> (d_feats [B, N, F, C], d_proj_axes [D, Q],
    d_proj_biases [Q], d_conv_weights [C, Q, O])``, all float32 (with
    bfloat16 operands ``d_feats`` sums the rounded per-edge rows; D = 9, or
    3 for the standard geometry, ``rot6`` None).

    Same arguments as :func:`fused_equiv_fwd` plus ``gout``.  With
    ``sorted_slot [B, M*K]`` (int64, each edge's slot in source order) the
    first output is instead the ``[B, M*K, F*C]`` buffer of per-edge feature
    gradients at their sorted slots, zero for masked edges, in the operands'
    dtype.  ``live_rows``
    must be :func:`live_row_table` of this ``mask``, on the device of
    ``feats``: the kernels skip an entry outside ``[0, B*M)``, but a row
    listed twice counts twice (:func:`_live_rows`).  Without it the wrapper builds it, at the cost of one host
    synchronisation.  CPU tensors run :func:`fused_equiv_bwd_reference`
    over every row, whatever the table (the rows it leaves out add
    nothing); CUDA tensors launch the kernels, unless no row has a valid
    edge: then every gradient is zero and nothing is launched.
    """
    if feats.device.type == "cpu":
        return fused_equiv_bwd_reference(
            rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights, gout, sorted_slot
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b, m, n, k, g, f, q, c, o, d = _check(
        rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights
    )
    if gout.device != feats.device or gout.dtype != torch.float32 or not gout.is_contiguous():
        raise ValueError("gout must be a contiguous float32 tensor on the device of feats")
    if tuple(gout.shape) != (b, m, g, o):
        raise ValueError(f"gout has shape {tuple(gout.shape)}, expected {(b, m, g, o)}")
    dev = feats.device
    if sorted_slot is None:
        d_feats = torch.zeros(feats.shape, dtype=torch.float32, device=dev)
    else:
        if (sorted_slot.device != dev or sorted_slot.dtype != torch.int64
                or not sorted_slot.is_contiguous() or tuple(sorted_slot.shape) != (b, m * k)):
            raise ValueError(f"sorted_slot must be a contiguous int64 [{b}, {m * k}] tensor on {dev}")
        d_feats = torch.zeros((b, m * k, f * c), dtype=feats.dtype, device=dev)
    live_rows = _live_rows(live_rows, mask, b * m, dev)
    n_live = live_rows.numel()
    if n_live * g > _MAX_SCRATCH_ROWS:
        raise ValueError(f"kernel takes at most {_MAX_SCRATCH_ROWS} live rows x G, got {n_live * g}")
    d_params = torch.zeros((d + 1, q), dtype=torch.float32, device=dev)  # D proj rows + bias
    d_w = torch.zeros_like(conv_weights)
    if n_live == 0 or c == 0 or o == 0:
        return d_feats, d_params[:d], d_params[d], d_w
    lib = library("bwd")
    bf16 = feats.dtype == torch.bfloat16
    scratch, w_splits, p_blocks = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    lib.se3_fused_equiv_bwd_plan(n_live, g, q, c, o, feats.element_size(), ctypes.byref(scratch),
                                 ctypes.byref(w_splits), ctypes.byref(p_blocks))
    work = torch.empty(scratch.value, dtype=torch.uint8, device=dev)  # bytes
    w_part = torch.empty((w_splits.value, c * q * o), dtype=torch.float32, device=dev)
    p_part = torch.empty((p_blocks.value, (d + 1) * q), dtype=torch.float32, device=dev)
    ptrs = (feats.data_ptr(), idx.data_ptr(), mask.data_ptr(), proj_axes.data_ptr(),
            proj_biases.data_ptr(), conv_weights.data_ptr(), gout.data_ptr(), live_rows.data_ptr(),
            None if sorted_slot is None else sorted_slot.data_ptr(), d_feats.data_ptr(),
            d_params.data_ptr(), d_w.data_ptr(), work.data_ptr(), w_part.data_ptr(),
            p_part.data_ptr())
    plan = (n_live, w_splits.value, p_blocks.value, int(bf16),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if rot6 is None:
            err = lib.se3_fused_std_bwd(rel.data_ptr(), *ptrs, b, m, n, k, q, c, o, *plan)
        else:
            err = lib.se3_fused_equiv_bwd(rel.data_ptr(), rot6.data_ptr(), *ptrs,
                                          b, m, n, k, g, f, q, c, o, *plan)
    if err != 0:
        raise RuntimeError(f"fused_equiv_bwd kernel launch failed: CUDA error {err}")
    _count(fused_equiv_bwd, bf16, g, d)
    return d_feats, d_params[:d], d_params[d], d_w


def _count(wrapper, bf16, g, d):
    """One more kernel launch of ``wrapper``: all, bfloat16, by G and by D."""
    wrapper.launches += 1
    wrapper.bf16_launches += bf16
    wrapper.launches_by_g[g] = wrapper.launches_by_g.get(g, 0) + 1
    wrapper.launches_by_d[d] = wrapper.launches_by_d.get(d, 0) + 1


# kernel launches so far (CPU calls do not count): all, those with bfloat16
# operands, all by G (out-frames: {G: launches}) and all by D (pne inputs:
# 9 equivariant, 3 standard); callers may reset them
fused_equiv_fwd.launches = fused_equiv_fwd.bf16_launches = 0
fused_equiv_bwd.launches = fused_equiv_bwd.bf16_launches = 0
fused_equiv_fwd.launches_by_g, fused_equiv_bwd.launches_by_g = {}, {}
fused_equiv_fwd.launches_by_d, fused_equiv_bwd.launches_by_d = {}, {}


class FusedEquivConv(torch.autograd.Function):
    """:func:`fused_equiv_fwd` with :func:`fused_equiv_bwd` as its backward
    (``rot6`` None: the standard geometry).

    Saves only its inputs (the lean-VJP residuals of
    ``se3conv3d_tpu/ops/pne_conv.py:_lean_equiv``) and the tables it is
    given: the backward recomputes pne and basis instead of keeping them.
    Given the sort tables ``(sorted_slot, run_start, run_end)`` of the
    'sorted' reduction, the feature gradient is the sorted per-edge buffer
    reduced by :func:`~se3conv3d_tpu_torch.kernels.segsum.sorted_segment_sum`;
    without them, the kernel's atomic scatter.  Given ``live_rows``
    (:func:`live_row_table`), the forward and the backward use it instead of
    each building one.  The feature gradient comes back in the features'
    dtype: with bfloat16 operands the float32 sum is rounded once, as the
    JAX package's ``.astype(feats_x.dtype)``.
    """

    @staticmethod
    def forward(ctx, rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights,
                sorted_slot=None, run_start=None, run_end=None, live_rows=None):
        inputs = (rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights)
        tables = () if sorted_slot is None else (sorted_slot, run_start, run_end)
        ctx.has_live = live_rows is not None
        ctx.save_for_backward(*inputs, *tables, *((live_rows,) if ctx.has_live else ()))
        return fused_equiv_fwd(*inputs, live_rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        inputs, rest = ctx.saved_tensors[:8], ctx.saved_tensors[8:]
        live = rest[-1] if ctx.has_live else None
        tables = rest[:-1] if ctx.has_live else rest
        d_feats, d_pa, d_pb, d_w = fused_equiv_bwd(
            *inputs, gout.contiguous(), tables[0] if tables else None, live)
        if tables:
            d_feats = sorted_segment_sum(d_feats, *tables[1:]).reshape(inputs[2].shape)
        d_feats = d_feats.to(inputs[2].dtype)
        need = ctx.needs_input_grad
        return (None, None, d_feats if need[2] else None, None, None,
                d_pa if need[5] else None, d_pb if need[6] else None, d_w if need[7] else None,
                None, None, None, None)


def fused_equiv(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights,
                sort_tables=None, live_rows=None):
    """Differentiable fused conv ``-> [B, M, G, O]`` (see :func:`fused_equiv_fwd`;
    ``rot6`` None for the standard geometry);
    ``sort_tables = (sorted_slot, run_start, run_end)`` selects the 'sorted'
    feature-gradient reduction; ``live_rows`` is :func:`live_row_table` of
    ``mask``, built by the forward and again by the backward when absent."""
    return FusedEquivConv.apply(rel, rot6, feats, idx, mask, proj_axes, proj_biases,
                                conv_weights, *(sort_tables or (None, None, None)), live_rows)
