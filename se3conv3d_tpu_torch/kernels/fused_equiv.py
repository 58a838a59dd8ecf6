"""Fused PNE conv: Hopper CUDA kernels (forward and backward), their plain
PyTorch versions and the autograd Function that joins them.

Computes, for every query point m, out-frame g and output channel o::

    out[b,m,g,o] = sum_{q,c} W[c,q,o] * sum_{k,f: mask[b,m,k]}
                   act(P . x[b,m,k,g,f] + bias)[q] * feats[b, idx[b,m,k], f, c]

with ``act`` one of :data:`ACTS` (gelu in its exact erf form, relu, sin,
or ``linear``, the identity: the TPU kernel's ``_ACTS``), no
normalisation (the caller applies ``norm_num_neighs / F``) and ``x`` the
edge's pne inputs in one of three geometries, ``P = proj_axes [D, Q]``:

* equivariant, D = 9: ``x = [rel[b,m,k,g], rot6[b,m,k,g,f]]``, the offset
  in the receiver frame and the 6D relative rotation, ``P`` already scaled
  by the layer's ``norm_neigh_dist`` on its three offset rows;
* standard, D = 3 (``rot6=None``): G = F = 1 and ``x`` the raw offsets
  ``rel [B, M, K, 1, 3]``, all three rows of ``P`` scaled by the caller, as
  the TPU kernels compute it for ``se3conv3d_tpu/ops/pne_conv.py:fused_conv``;
* kernel-point, D = P (``kp`` a :class:`KernelPoints`): G = F = 1 and ``x``
  the P correlation weights of the edge against the kernel points
  (:func:`kp_weights`: ``rel * norm_dist`` against each point, gauss,
  linear or box), computed inside the kernels from the float32 raw offsets
  ``rel [B, M, K, 1, 3]``, as ``se3conv3d_tpu/ops/pne_conv.py:
  fused_kp_conv`` computes them in XLA for the TPU kernel (which it runs
  with ``act='linear'``).  The kernels read 3 floats an edge where a table
  of weights would be P + 1, and ``norm_dist`` from the device, with no
  host synchronisation.

The operands ``rel``, ``rot6`` and ``feats`` are all float32 or all
bfloat16 (the kernel-point ``rel`` is float32 either way); the parameters,
the output and the parameter gradients are float32.  Gradients flow to
``feats``, ``P``, ``bias`` and ``W``; the geometry (``rel``, ``rot6``, the
kernel-point weights, ``idx``, ``mask``) gets none, as in the reference.
The standard and kernel-point geometries run at G = F = 1, Q <=
:data:`STD_MAX_Q` (64), P <= :data:`MAX_KP`.

bfloat16 operands follow the TPU kernels' bf16 path (the ``cdt`` argument
of ``se3conv3d_tpu/ops/pallas/fused_equiv.py:_fwd_kernel`` /
``_bwd_kernel``): every sum is float32, and values are rounded to bfloat16
at exactly these points, in the kernels and in their plain versions alike
(:func:`_rounding`): the projection ``P`` and ``bias`` and the weights
``W`` as read; each kernel-point weight; each ``pne = act(pre)`` (``pre``
and ``act`` in float32); each ``basis`` entry before the weight
contraction; in the backward ``gout``, ``dbasis = gout . W^T``, each edge's
``d_gathered`` row and each ``dpre = dpne * act'(pre)`` (``dpne`` and
``act'`` in float32) before the ``d_proj`` / ``d_bias`` sums.  The scatter
mode sums the rounded rows in float32 (``d_feats`` float32); the sorted
mode stores them in a bfloat16 buffer, which the prefix sum reads as it
is.  :class:`FusedEquivConv` rounds the summed feature gradient to the
features' dtype, as the JAX package's ``.astype(feats_x.dtype)``.

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
``basis`` rows to an ``[Lc*G, C*Q]`` scratch; the product ``basis . W``
(``csrc/wg_product.cuh``, :mod:`.product`: ``wgmma`` fed by a ring of
TMA stages, float32 in the 3xTF32 form, each operand split
into a TF32 high part and a TF32 remainder, three products summed in
float32, which holds float32 accuracy) reads ``W`` from an image made once
a call and stores each row at its query row, its depth ``C*Q`` split into
partials summed in a fixed order where the chunk has too few rows to fill
the card.
The chunks keep the scratch within :data:`FWD_SCRATCH_BYTES`.  Two calls
give the same bits.

Backward, ``csrc/fused_equiv_bwd.cu``: replaces ``_bwd_kernel`` (reached
through ``_fused_single_bwd`` / ``fused_pne_conv_bwd``, the lean VJPs of
``ops/pne_conv.py`` and the custom VJP under ``fused_kp_conv``) together with the XLA scatter-add of per-edge feature
gradients that followed it.  The TPU summed ``dW`` and ``dproj`` across a
sequential grid; Hopper blocks run in parallel, and ``dW`` (8 MB at
C=O=256) fits in no block's shared memory.  So the backward is four
passes, each over the *live rows* only: the query rows with at least one
valid edge (:func:`live_row_table`, built once per neighborhood and cached
on it).  A row without one has a zero ``basis`` row and adds nothing to
any gradient, and the padded clouds leave most rows so (83-89% of the
ScanNet level 0).  The forward's first half writes ``basis`` to an
``[L*G, C*Q]`` scratch for the ``L`` live rows; a
product ``basis^T . gout`` gives ``d_w`` in per-row-split partials summed
in a fixed order; a product ``gout . W^T`` gives ``dbasis`` over the same
scratch; and the per-edge pass (``edge_kernel``) recomputes pne and act'
(and the kernel-point weights) from one ``pre``, adds ``d_feats`` with
float32 vector atomics straight into ``[B, N, F, C]`` (no per-edge ``[M,
E, C]`` output, masked edges skipped) and sums ``d_proj`` / ``d_bias`` per
block, again added in a fixed order.  The basis pass is the forward's, and
the two products run on the forward's product (``csrc/wg_product.cuh``).
The parameter gradients are deterministic: their split boundaries depend
only on the live count, and the per-edge pass walks the rows in a fixed
order (:func:`edge_plan`); ``d_feats`` is summed by atomics in no fixed
order.

The per-edge pass, what bounds it and its design: at the ScanNet level 0
(3.15M edges, C = 64, G*Q = 32) its two per-edge products (``dpne = feat .
dbasis^T`` and ``d_gathered = pne . dbasis``) take 12.9 GFLOP each, and it
reads the 1.07 GB dbasis scratch (0.54 in bfloat16): bytes bound it, at
about 0.38 ms (float32) and 0.20 ms (bfloat16) on an H100.  A block of 4
warps walks the live rows one at a time, a row's edges in rounds of 32 and
its channels in chunks of 32; each unit's dbasis chunk and gathered
features come in by 16-byte ``cp.async`` into a ring of 2 stages while the
unit before multiplies; the products, and ``d_proj = dpre^T . [geo, 1]``,
run on ``mma.sync`` (float32 in 3xTF32, bfloat16 on bf16 tiles), each
16-deep slice summed apart and added in float32 as the shared product
does; pne and act' come from one ``pre`` per (edge, column) at the places
of the thread's own accumulators.  :func:`edge_plan` mirrors its launch
(shared memory, stages, blocks an SM) and :func:`edge_writes` its tiles.

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
those with bfloat16 operands, ``launches_by_g`` by out-frame count,
``launches_by_d`` by pne input width: 9 equivariant, 3 standard, P
kernel-point; ``launches_by_act`` by activation and ``launches_by_kp`` by
correlation and P of the kernel-point ones).
``fused_equiv`` is the differentiable op.  Each kernel source is built
with ``nvcc`` for ``sm_90a`` at its first launch (``kernels/build.py``).

Out-frames: the kernels take G <= 4 and G*Q <= 128 (``column_capacity``):
a pne row in shared memory holds 64 columns where G <= 2 and G*Q <= 64,
and 128 otherwise (the mixed-frame-count recipes' F = G = 4 at Q = 32), each
capacity its own instantiation, so the G <= 2 convs keep their layout and
occupancy.  A 128-column row is walked in two 64-column passes of the
register tiles (the basis pass's features and the backward's dbasis
columns are read twice); its shared memory lets fewer warps run per SM.

Activations and the kernel-point geometry: the activation is a run-time
switch the same for every lane, outside the per-edge loops, in the basis
pass; the backward's per-edge pass keeps an instantiation of gelu's alone
beside one that switches.  relu's ``pre`` is summed with each product and
sum rounded on its own, in the kernels and the plain versions alike
(:func:`_pre`): its derivative steps at 0.  The kernel-point geometry is its
own instantiation (``kD = kKP`` of ``csrc/fused_equiv_common.cuh``), whose
per-edge pass holds each round's P weights in shared memory and sums
``d_proj [P + 1, Q]`` in five m-tiles of register accumulators.  What
bounds them on an H100: the same products as the gelu kernels, plus at the
kernel points about 10 FLOPs, an exp or a sqrt per point and edge and the
``2*P*Q`` projection.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..parallel.mesh import gather_points, sum_points_rows
from .build import library
from .segsum import sorted_segment_sum

__all__ = [
    "fused_equiv",
    "FusedEquivConv",
    "KernelPoints",
    "kp_weights",
    "ACTS",
    "CORRELATIONS",
    "MAX_KP",
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
    "edge_plan",
    "edge_writes",
    "EDGE_GRID",
]

# the operand types of rel, rot6 and feats (the kernels' instantiations)
OPERAND_DTYPES = (torch.float32, torch.bfloat16)
# the pne activations by their codes in the kernels (csrc Act)
ACTS = {"gelu": 0, "relu": 1, "sin": 2, "linear": 3}
# the kernel-point correlations by their codes (csrc Corr), and the most
# kernel points a conv may have (csrc kMaxKP)
CORRELATIONS = {"gauss": 0, "linear": 1, "box": 2}
MAX_KP = 64

# a pne row in the kernels' shared memory holds 64 (g, q) columns for G <= 2
# and G*Q <= 64, or 128 for G <= 4 and G*Q <= 128 (``column_capacity``;
# csrc/fused_equiv_common.cuh ``Cols``): the kernels take G <= MAX_G and
# G*Q <= MAX_GQ
MAX_G, MAX_GQ = 4, 128
# the basis pass keeps one row's K*F pne rows in a warp's shared memory:
# the most K*F that fits, by column capacity (about 227 KB / (4 * 129) at 128;
# the standard geometry's smaller projection leaves at least as much room)
MAX_EDGES = {64: 768, 128: 432}
# the standard and kernel-point geometries (kD = 3, kKP) take G = F = 1 and
# one pne row of 64 columns: Q <= 64, the narrow basis tile for Q <= 32
# (every recipe's num_basis), the wide one above
STD_MAX_Q = 64
# the forward walks its live rows in chunks whose scratch (basis rows and
# depth-split partials) stays within this many bytes
FWD_SCRATCH_BYTES = 128 << 20
# the products index their L*G rows with 32-bit integers
_MAX_SCRATCH_ROWS = 2**31 - 1


# the backward's per-edge pass (csrc/fused_equiv_bwd.cu edge_kernel): 4
# warps a block, rounds of 32 edges (two m-tiles of 16), chunks of 32
# channels, a ring of 2 stages, padded rows of 40 values for the staged
# features and the transposed geometry; its walk takes 4 blocks an SM of
# the 132 of an H100 (kEGrid)
EDGE_WARPS, EDGE_ROUND, EDGE_CHUNK, EDGE_STAGES = 4, 32, 32, 2
EDGE_ROW_STRIDE = 40
EDGE_GRID = 132 * 4
# shared memory: one block may take SMEM_MAX bytes; an SM holds SM_SMEM,
# 1 KB of it reserved for each block
SMEM_MAX, SM_SMEM, BLOCK_RESERVED = 232448, 233472, 1024


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def edge_plan(elem_bytes: int, g: int, q: int, k: int, kd: int, p: int = 0) -> dict:
    """The launch of the backward's per-edge pass (``se3_fused_edge_plan``)
    for operands of ``elem_bytes``, ``g`` out-frames, ``q`` basis
    functions, ``k`` neighbors and the geometry ``kd`` (9, 3, or 0: the
    kernel points, ``p`` of them): warps a block, dynamic shared-memory
    bytes (``fits``: within one block's ``SMEM_MAX``), ring stages, blocks
    an SM (4 at 64 pne columns, 2 at 128 and at the kernel points: the
    instantiations' launch bounds; fewer where shared memory runs out), the
    row stride of the staged dbasis and of the pne rows (G*Q rounded up to
    32, plus 4 in float32 or 8 in bfloat16: conflict-free fragment loads),
    the geometry rows of a frame (D + 1 rounded up to 16), edges a round and
    channels a chunk."""
    gqc = column_capacity(g, q)
    if gqc == 0 or (kd != 9 and gqc != 64) or (kd == 0 and not 1 <= p <= MAX_KP):
        raise ValueError(f"no per-edge instantiation takes G={g}, Q={q}, kd={kd}, P={p}")
    d, gq = (p if kd == 0 else kd), g * q
    gqs = -(-gq // 32) * 32 + (4 if elem_bytes == 4 else 8)
    geo_rows = (d + 16) // 16 * 16
    stage = _align16(elem_bytes * EDGE_CHUNK * gqs) + _align16(elem_bytes * EDGE_ROUND * EDGE_ROW_STRIDE)
    total = (EDGE_STAGES * stage + _align16(elem_bytes * EDGE_ROUND * gqs)
             + 3 * _align16(4 * g * geo_rows * EDGE_ROW_STRIDE) + _align16(4 * d * q) + _align16(4 * q)
             + _align16(4 * 3 * (p if kd == 0 else 0)) + _align16(4 * gq) + _align16(4 * 3 * 2 * k) + 16)
    want = 4 if gqc == 64 and kd != 0 else 2
    return dict(warps=EDGE_WARPS, smem_bytes=total, stages=EDGE_STAGES,
                blocks_per_sm=min(SM_SMEM // (total + BLOCK_RESERVED), want), gq_stride=gqs,
                geo_rows=geo_rows, edges_per_round=EDGE_ROUND, channels_per_chunk=EDGE_CHUNK,
                fits=total <= SMEM_MAX)


def edge_writes(n_edges: int, gq: int, c: int, gqc: int = 64, q: int = None, d: int = 9,
                sorted_bf16: bool = False) -> dict:
    """Which (edge, column) the per-edge pass's tiles write, for a row of
    ``n_edges`` valid edges, ``gq`` pne columns (``gqc`` the capacity),
    ``c`` channels, ``q`` basis functions (default ``gq``) and ``d`` pne
    inputs: ``{"dpne": Counter of (e, gq), "d_feats": Counter of (e, c),
    "d_proj": Counter of (d, q)}``, each count the lane writes, as the
    kernel's warps (n-tiles ``w, w + 4, ...`` of 8 columns, channels ``8w ..
    8w + 7`` of each chunk), m-tiles of 16 (live where the round has an edge
    in them), lanes and lane trades assign them (bfloat16 sorted rows: 8
    channels a lane where ``c % 8 == 0``)."""
    from collections import Counter

    q = gq if q is None else q
    dpne, dfeat, dproj = Counter(), Counter(), Counter()
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for rd in range(-(-n_edges // EDGE_ROUND)):
        ne = min(EDGE_ROUND, n_edges - rd * EDGE_ROUND)
        for w in range(EDGE_WARPS):
            for mt in range(2 if ne > 16 else 1):
                for jn in range(gqc // 32):
                    n0 = (w + 4 * jn) * 8
                    if n0 >= gq:
                        break
                    for (r4, t4), i in ((x, i) for x in lanes for i in range(4)):
                        e, col = mt * 16 + r4 + 8 * (i >> 1), n0 + 2 * t4 + (i & 1)
                        if e < ne and col < gq:
                            dpne[(rd * EDGE_ROUND + e, col)] += 1
                for c0 in range(0, c, EDGE_CHUNK):
                    cw = min(EDGE_CHUNK, c - c0)
                    if w * 8 >= cw:
                        continue
                    for r4, t4 in lanes:
                        e, cc, width = mt * 16 + r4 + 8 * (t4 & 1), w * 8 + 4 * (t4 >> 1), 4
                        if sorted_bf16 and c % 8 == 0:
                            if t4 >= 2:
                                continue
                            cc, width = w * 8, 8
                        if e < ne and cc < cw:
                            for x in range(min(width, cw - cc)):
                                dfeat[(rd * EDGE_ROUND + e, c0 + cc + x)] += 1
    for w in range(EDGE_WARPS):  # the block's d_proj partial, at the end of the walk
        for pm in range(-(-(d + 1) // 16)):
            for jn in range(gqc // 32):
                for (r4, t4), i in ((x, i) for x in lanes for i in range(4)):
                    dd, qq = pm * 16 + r4 + 8 * (i >> 1), (w + 4 * jn) * 8 + 2 * t4 + (i & 1)
                    if dd <= d and qq < q:
                        dproj[(dd, qq)] += 1
    return {"dpne": dpne, "d_feats": dfeat, "d_proj": dproj}


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


class KernelPoints(NamedTuple):
    """The kernel-point geometry of a conv (``ops.pne_conv.fused_kp_conv``):
    ``points [P, 3]`` float32 on the operands' device, ``sigma``, the
    correlation ``corr`` ('gauss', 'linear' or 'box') and the layer's
    ``norm_dist``, a float32 scalar tensor on the same device (read by the
    kernels from device memory)."""

    points: torch.Tensor
    sigma: float
    corr: str
    norm_dist: torch.Tensor


def _inv_s2(sigma: float) -> float:
    """``1 / sigma^2`` rounded to float32, as the kernels take it (and as
    JAX's weak-typed float32 product takes the Python float)."""
    return float(torch.tensor(1.0 / (sigma * sigma), dtype=torch.float32))


def kp_weights(rel: torch.Tensor, kp: KernelPoints) -> torch.Tensor:
    """``[..., P]`` float32 correlation weights of the raw offsets ``rel
    [..., 3]`` (float32) against ``kp.points``, in the operations and the
    order of ``se3conv3d_tpu/ops/pne_conv.py:_kp_geo_chunk`` and of the
    kernels (``kp_weights`` of ``csrc/fused_equiv_common.cuh``), each
    rounded on its own: ``rel * norm_dist``, the squared distances summed
    over x, y, z in that order and scaled by ``1 / sigma^2``, then gauss
    ``exp(-d2 / 2)``, linear ``max(1 - sqrt(d2), 0)`` or box, the one-hot of
    the first argmin."""
    t = (rel * kp.norm_dist)[..., None, :] - kp.points  # [..., P, 3]
    d2 = (t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1] + t[..., 2] * t[..., 2]) * _inv_s2(kp.sigma)
    if kp.corr == "gauss":
        return torch.exp(-d2 / 2.0)
    if kp.corr == "linear":
        return torch.clamp(1.0 - torch.sqrt(d2), min=0.0)
    if kp.corr == "box":
        return F.one_hot(torch.argmin(d2, -1), d2.shape[-1]).to(d2.dtype)
    raise ValueError(f"unknown correlation {kp.corr!r}")


def _edge_geometry(rel, rot6, f, kp, rnd):
    """``[B, M, K, G, F, D]`` pne inputs: offsets repeated over the ``f``
    in-frames, then the 6D relative rotations (D = 9), or the offsets
    alone where ``rot6`` is None (D = 3), or the kernel-point weights
    rounded to the operands' dtype (D = P, G = F = 1)."""
    if kp is not None:
        return rnd(kp_weights(rel, kp))[:, :, :, :, None, :]
    rel, rot6 = _wide(rel), _wide(rot6)
    b, m, k, g, _ = rel.shape
    offsets = rel[:, :, :, :, None, :].expand(b, m, k, g, f, 3)
    return offsets if rot6 is None else torch.cat([offsets, rot6], -1)


def _pre(geo, proj_axes, proj_biases, act):
    """``pre = geo . proj_axes + proj_biases``; for relu, whose derivative
    steps at 0, in the kernels' order with each product and sum rounded on
    its own (``pre_act`` / ``pre_kp`` with ``kRn``), so that the step falls
    on the same side on every edge in the kernels and here."""
    if act != "relu":
        return geo @ proj_axes + proj_biases
    pre = proj_biases.expand(geo.shape[:-1] + proj_biases.shape)
    for d in range(geo.shape[-1]):
        pre = pre + geo[..., d, None] * proj_axes[d]
    return pre


def _activation(act: str, pre: torch.Tensor) -> torch.Tensor:
    """``act(pre)`` (gelu exact, relu ``max(pre, 0)``, sin, linear)."""
    if act == "gelu":
        return F.gelu(pre)
    if act == "relu":
        return torch.relu(pre)
    if act == "sin":
        return torch.sin(pre)
    return pre


def _activation_grad(act: str, pre: torch.Tensor) -> torch.Tensor:
    """``act'(pre)`` in the closed forms of the TPU kernel's
    ``_act_and_grad``: gelu ``Phi(x) + x * phi(x)``, relu a step with 0 at
    0 (``jax.jvp`` of ``jax.nn.relu``), sin ``cos``, linear 1."""
    if act == "gelu":
        return (0.5 * (1.0 + torch.erf(pre * math.sqrt(0.5)))
                + pre * torch.exp(-0.5 * pre * pre) / math.sqrt(2.0 * math.pi))
    if act == "relu":
        return (pre > 0).to(pre.dtype)
    if act == "sin":
        return torch.cos(pre)
    return torch.ones_like(pre)


def _gather(feats, idx, mask):
    """``[B, M, K, F, C]`` neighbor features, zero on invalid edges."""
    bidx = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[bidx, idx] * mask[:, :, :, None, None].to(feats.dtype)


def fused_equiv_fwd_reference(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights,
                              act="gelu", kp=None):
    """Plain PyTorch version of the forward kernel (same arguments, same
    result, rounding where the kernel rounds: :func:`_rounding`; ``rot6``
    None for the standard and kernel-point geometries)."""
    rnd = _rounding(feats.dtype)
    geo = _edge_geometry(rel, rot6, feats.shape[2], kp, rnd)
    pre = _pre(geo, rnd(proj_axes), rnd(proj_biases), act)
    pne = rnd(_activation(act, pre))  # [B,M,K,G,F,Q]
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
                              conv_weights, gout, sorted_slot=None, act="gelu", kp=None):
    """Plain PyTorch version of the backward kernel: recomputes pne and basis
    and returns ``(d_feats, d_proj_axes, d_proj_biases, d_conv_weights)``;
    with ``sorted_slot`` the first is the sorted per-edge buffer of
    :func:`fused_equiv_bwd` instead (in the operands' dtype).  Rounds where
    the kernel rounds (:func:`_rounding`).

    ``act'`` is the closed form the TPU kernel takes
    (``se3conv3d_tpu/ops/pallas/fused_equiv.py:_act_and_grad``,
    :func:`_activation_grad`).
    """
    rnd = _rounding(feats.dtype)
    geo = _edge_geometry(rel, rot6, feats.shape[2], kp, rnd)
    pre = _pre(geo, rnd(proj_axes), rnd(proj_biases), act)
    pne = rnd(_activation(act, pre))
    dact = _activation_grad(act, pre)
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


def _check(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights, act="gelu",
           kp=None):
    """The kernels' contract; returns ``(B, M, N, K, G, F, Q, C, O, D)``
    (D: 9 pne inputs with ``rot6``, 3 without: the standard geometry; P
    with ``kp``: the kernel-point geometry)."""
    tensors = dict(rel=rel, rot6=rot6, feats=feats, idx=idx, mask=mask,
                   proj_axes=proj_axes, proj_biases=proj_biases, conv_weights=conv_weights)
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if kp is not None:
        if rot6 is not None:
            raise ValueError("the kernel-point geometry takes no rot6")
        if kp.corr not in CORRELATIONS:
            raise ValueError(f"kp.corr must be one of {tuple(CORRELATIONS)}, got {kp.corr!r}")
        tensors.update(kp_points=kp.points, kp_norm_dist=kp.norm_dist)
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
    if kp is not None:  # the raw offsets stay float32: the weights are computed from them
        for name in ("rel", "kp_points", "kp_norm_dist"):
            if tensors[name].dtype != torch.float32:
                raise TypeError(f"{name} must be float32 in the kernel-point geometry, "
                                f"got {tensors[name].dtype}")
        if kp.norm_dist.numel() != 1:
            raise ValueError("kp.norm_dist must hold one value")
    else:
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
    if kp is not None:
        d = kp.points.shape[0]
        if tuple(kp.points.shape) != (d, 3) or not 1 <= d <= MAX_KP:
            raise ValueError(f"kp.points must be [P, 3] with 1 <= P <= {MAX_KP}, "
                             f"got {tuple(kp.points.shape)}")
    else:
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
                             + (" (the standard geometry: no rot6)" if rot6 is None and kp is None
                                else " (the kernel-point geometry: P rows)" if kp is not None else ""))
    if rot6 is None and ((g, f) != (1, 1) or q > STD_MAX_Q):
        geometry = "the kernel-point geometry" if kp is not None else "the standard geometry (no rot6)"
        raise ValueError(f"{geometry} takes G = F = 1 and Q <= {STD_MAX_Q}, got G={g}, F={f}, Q={q}")
    cols = column_capacity(g, q)
    if cols == 0:
        raise ValueError(f"kernel takes G <= {MAX_G} and G*Q <= {MAX_GQ}, got G={g}, Q={q}")
    if k * f > MAX_EDGES[cols]:
        raise ValueError(f"kernel takes K*F <= {MAX_EDGES[cols]} at G={g}, G*Q={g * q} "
                         f"({cols} pne columns), got K={k}, F={f}")
    return b, m, n, k, g, f, q, c, o, d


def fused_equiv_fwd(
    rel: torch.Tensor,
    rot6: Optional[torch.Tensor],
    feats: torch.Tensor,
    idx: torch.Tensor,
    mask: torch.Tensor,
    proj_axes: torch.Tensor,
    proj_biases: torch.Tensor,
    conv_weights: torch.Tensor,
    live_rows: torch.Tensor = None,
    act: str = "gelu",
    kp: Optional[KernelPoints] = None,
) -> torch.Tensor:
    """Fused conv forward ``-> [B, M, G, O]`` float32, un-normalised.

    Args:
      rel: ``[B, M, K, G, 3]`` edge offsets in the receiver frames (the
        standard and kernel-point geometries: ``[B, M, K, 1, 3]`` raw
        offsets, float32 in the kernel-point one).
      rot6: ``[B, M, K, G, F, 6]`` 6D relative rotations, or None for the
        standard and kernel-point geometries (G = F = 1).
      feats: ``[B, N, F, C]`` source features; ``rel``, ``rot6`` and
        ``feats`` are all float32 or all bfloat16 (the rounding points of
        the module note).
      idx / mask: ``[B, M, K]`` int64 neighbor indices and bool validity.
      proj_axes: ``[9, Q]`` (offset rows pre-scaled), ``[3, Q]`` for the
        standard geometry, ``[P, Q]`` for the kernel-point one;
        proj_biases ``[Q]``; conv_weights ``[C, Q, O]``.
      live_rows: :func:`live_row_table` of ``mask`` on the device of
        ``feats``, as for :func:`fused_equiv_bwd` (see :func:`_live_rows`);
        built here, at the cost of one host synchronisation, when absent.
      act: the pne activation, one of :data:`ACTS`.
      kp: the kernel-point geometry (:class:`KernelPoints`), or None.

    CPU tensors run :func:`fused_equiv_fwd_reference` over every row,
    whatever the table; CUDA tensors launch the kernels over the live rows
    and leave the other rows zero, or launch nothing when no row is live.
    The result carries no autograd history: gradients go through
    :func:`fused_equiv`.
    """
    if feats.device.type == "cpu":
        return fused_equiv_fwd_reference(
            rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights, act, kp
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b, m, n, k, g, f, q, c, o, d = _check(
        rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights, act, kp
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
    plan = (n_live, chunk.value, splits.value, int(bf16), ACTS[act])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if kp is not None:
            err = lib.se3_fused_kp_fwd(rel.data_ptr(), kp.points.data_ptr(), kp.norm_dist.data_ptr(),
                                       *ptrs, b, m, n, k, d, q, c, o, *plan, _inv_s2(kp.sigma),
                                       CORRELATIONS[kp.corr], stream)
        elif rot6 is None:
            err = lib.se3_fused_std_fwd(rel.data_ptr(), *ptrs, b, m, n, k, q, c, o, *plan, stream)
        else:
            err = lib.se3_fused_equiv_fwd(rel.data_ptr(), rot6.data_ptr(), *ptrs,
                                          b, m, n, k, g, f, q, c, o, *plan, stream)
    if err != 0:
        raise RuntimeError(f"fused_equiv_fwd kernel launch failed: CUDA error {err}")
    _count(fused_equiv_fwd, bf16, g, d, q, act, kp, products=-(-n_live // chunk.value))
    return out


def fused_equiv_bwd(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights, gout,
                    sorted_slot=None, live_rows=None, act="gelu", kp=None):
    """Fused conv backward: ``gout [B, M, G, O]`` float32, the cotangent of
    the un-normalised output, ``-> (d_feats [B, N, F, C], d_proj_axes [D, Q],
    d_proj_biases [Q], d_conv_weights [C, Q, O])``, all float32 (with
    bfloat16 operands ``d_feats`` sums the rounded per-edge rows; D = 9, 3
    for the standard geometry, ``rot6`` None, or P for the kernel-point one,
    ``kp`` given).

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
            rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights, gout, sorted_slot,
            act, kp
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b, m, n, k, g, f, q, c, o, d = _check(
        rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights, act, kp
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
    # d_w's split partials (one split writes d_w itself)
    w_part = torch.empty((w_splits.value if w_splits.value > 1 else 0, c * q * o), dtype=torch.float32,
                         device=dev)
    p_part = torch.empty((p_blocks.value, (d + 1) * q), dtype=torch.float32, device=dev)
    ptrs = (feats.data_ptr(), idx.data_ptr(), mask.data_ptr(), proj_axes.data_ptr(),
            proj_biases.data_ptr(), conv_weights.data_ptr(), gout.data_ptr(), live_rows.data_ptr(),
            None if sorted_slot is None else sorted_slot.data_ptr(), d_feats.data_ptr(),
            d_params.data_ptr(), d_w.data_ptr(), work.data_ptr(), w_part.data_ptr(),
            p_part.data_ptr())
    plan = (n_live, w_splits.value, p_blocks.value, int(bf16), ACTS[act])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if kp is not None:
            err = lib.se3_fused_kp_bwd(rel.data_ptr(), kp.points.data_ptr(), kp.norm_dist.data_ptr(),
                                       *ptrs, b, m, n, k, d, q, c, o, *plan, _inv_s2(kp.sigma),
                                       CORRELATIONS[kp.corr], stream)
        elif rot6 is None:
            err = lib.se3_fused_std_bwd(rel.data_ptr(), *ptrs, b, m, n, k, q, c, o, *plan, stream)
        else:
            err = lib.se3_fused_equiv_bwd(rel.data_ptr(), rot6.data_ptr(), *ptrs,
                                          b, m, n, k, g, f, q, c, o, *plan, stream)
    if err != 0:
        raise RuntimeError(f"fused_equiv_bwd kernel launch failed: CUDA error {err}")
    _count(fused_equiv_bwd, bf16, g, d, q, act, kp, products=2, edges=1)
    return d_feats, d_params[:d], d_params[d], d_w


def _count(wrapper, bf16, g, d, q, act, kp, products, edges=0):
    """One more kernel launch of ``wrapper``: all, bfloat16, by G, by D, by
    (D, Q), by activation and, for the kernel-point geometry, by
    (correlation, P); its launches of the shared product (``wg_product``:
    one a forward chunk, two a backward) and of the per-edge pass
    (``edge_kernel``: one a backward)."""
    wrapper.launches += 1
    wrapper.product_launches += products
    wrapper.edge_launches += edges
    wrapper.bf16_launches += bf16
    for table, key in ((wrapper.launches_by_g, g), (wrapper.launches_by_d, d),
                       (wrapper.launches_by_q, (d, q)), (wrapper.launches_by_act, act)):
        table[key] = table.get(key, 0) + 1
    if kp is not None:
        key = (kp.corr, d)
        wrapper.launches_by_kp[key] = wrapper.launches_by_kp.get(key, 0) + 1


# kernel launches so far (CPU calls do not count): all, those with bfloat16
# operands, all by G (out-frames: {G: launches}), by D (pne inputs: 9
# equivariant, 3 standard, P kernel-point), by (D, Q) (the basis functions
# of each geometry: {(D, Q): launches}), by activation ({act: launches})
# and the kernel-point ones by ({(corr, P): launches}), and the launches of
# the shared product inside them (product_launches) and of the per-edge pass
# (edge_launches, the backward's); callers may reset them
for _wrapper in (fused_equiv_fwd, fused_equiv_bwd):
    _wrapper.launches = _wrapper.bf16_launches = _wrapper.product_launches = _wrapper.edge_launches = 0
    _wrapper.launches_by_g, _wrapper.launches_by_d, _wrapper.launches_by_q = {}, {}, {}
    _wrapper.launches_by_act, _wrapper.launches_by_kp = {}, {}


class FusedEquivConv(torch.autograd.Function):
    """:func:`fused_equiv_fwd` with :func:`fused_equiv_bwd` as its backward
    (``rot6`` None: the standard geometry, or with ``kp`` the kernel-point
    one; ``act`` the activation).

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

    Given ``points_total`` (a points group, ``parallel.mesh``), ``feats`` is
    this rank's rows of a source level of that many rows: the forward
    gathers the whole level over the points row, and so does the backward
    again, while only the rank's rows are saved; the backward's float32
    feature gradient of the whole level is summed over the row and cut to
    the rank's rows before its rounding.
    """

    @staticmethod
    def forward(ctx, rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights,
                sorted_slot=None, run_start=None, run_end=None, live_rows=None, act="gelu",
                kp=None, points_total=None):
        inputs = (rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights)
        tables = () if sorted_slot is None else (sorted_slot, run_start, run_end)
        ctx.has_live, ctx.act, ctx.kp, ctx.points_total = live_rows is not None, act, kp, points_total
        ctx.save_for_backward(*inputs, *tables, *((live_rows,) if ctx.has_live else ()))
        if points_total is not None:
            inputs = inputs[:2] + (gather_points(feats, 1, points_total),) + inputs[3:]
        return fused_equiv_fwd(*inputs, live_rows, act, kp)

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        inputs, rest = ctx.saved_tensors[:8], ctx.saved_tensors[8:]
        live = rest[-1] if ctx.has_live else None
        tables = rest[:-1] if ctx.has_live else rest
        dtype, total = inputs[2].dtype, ctx.points_total
        if total is not None:
            inputs = inputs[:2] + (gather_points(inputs[2], 1, total),) + inputs[3:]
        d_feats, d_pa, d_pb, d_w = fused_equiv_bwd(
            *inputs, gout.contiguous(), tables[0] if tables else None, live, ctx.act, ctx.kp)
        if tables:
            d_feats = sorted_segment_sum(d_feats, *tables[1:]).reshape(inputs[2].shape)
        if total is not None:
            d_feats = sum_points_rows(d_feats.float(), 1, total)
        d_feats = d_feats.to(dtype)
        need = ctx.needs_input_grad
        return (None, None, d_feats if need[2] else None, None, None,
                d_pa if need[5] else None, d_pb if need[6] else None, d_w if need[7] else None,
                None, None, None, None, None, None, None)


def fused_equiv(rel, rot6, feats, idx, mask, proj_axes, proj_biases, conv_weights,
                sort_tables=None, live_rows=None, act="gelu", kp=None, points_total=None):
    """Differentiable fused conv ``-> [B, M, G, O]`` (see :func:`fused_equiv_fwd`;
    ``rot6`` None for the standard and kernel-point geometries, ``kp`` the
    latter's :class:`KernelPoints`, ``act`` the activation);
    ``sort_tables = (sorted_slot, run_start, run_end)`` selects the 'sorted'
    feature-gradient reduction; ``live_rows`` is :func:`live_row_table` of
    ``mask``, built by the forward and again by the backward when absent;
    ``points_total``: ``feats`` is this rank's rows of a source level of
    that many rows on a points group (:class:`FusedEquivConv`)."""
    return FusedEquivConv.apply(rel, rot6, feats, idx, mask, proj_axes, proj_biases,
                                conv_weights, *(sort_tables or (None, None, None)), live_rows,
                                act, kp, points_total)
