"""Point-neighborhood-embedding conv ops (counterpart of
``se3conv3d_tpu/ops/pne_conv.py``).

The kernel paths run the CUDA kernels (their plain versions for CPU
tensors): the equivariant mlp conv with 6D rotations,
:func:`fused_equiv_conv`; the standard mlp conv, :func:`fused_conv`; the
kernel-point conv, :func:`fused_kp_conv`; each mlp one with any activation
the kernels take (gelu, relu, sin, linear).  The plain path, in PyTorch ops
on whichever device holds the tensors, is what the JAX package runs in XLA
where no Pallas kernel serves (``mlp_softmax``, ``'max'`` aggregation, the
quaternion and matrix rotations, or ``use_fused=False``):
:func:`relative_offsets`, :func:`linear_pne`, :func:`kp_pne`,
:func:`basis_conv`, :func:`equiv_geometry` and :func:`equiv_basis_conv`.

Shape glossary: B batch, M query points, N source points, K neighbors,
G out-frames, F in-frames, Q basis functions, C/O channels.  Geometry never
receives gradients, as in the reference (its neighbor search, PNE inputs and
frames are built under ``torch.no_grad()``).

The conv backward reduces per-edge feature gradients into the source points
in one of two modes, ``BWD_SCATTER_MODE`` (read at call time; the
``SE3CONV_BWD_MODE`` environment variable sets it at import):

* ``'scatter'`` (default): float32 atomics inside the backward kernel, the
  original CUDA backward's ``atomicAdd``;
* ``'sorted'``: the backward kernel stores each edge's row at its slot in
  source order (:func:`backward_sort_tables`), and
  ``kernels.segsum.sorted_segment_sum`` sums the runs by a blocked prefix
  sum (the Hopper port of the Pallas ``_cumsum_kernel``) and prefix
  differences.  Deterministic; the JAX package's opt-in A/B mode.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..core.neighborhoods import Neighborhood
from ..core.pointcloud import PointCloud, gather_rows
from ..core.rotation import matrix_to_quaternion, matrix_to_rotation_6d
from ..kernels.fused_equiv import KernelPoints, _rounding, fused_equiv, kp_weights

__all__ = [
    "pne_activation",
    "relative_offsets",
    "linear_pne",
    "kp_pne",
    "basis_conv",
    "equiv_geometry_parts",
    "equiv_geometry",
    "equiv_basis_conv",
    "fused_equiv_conv",
    "std_geometry",
    "fused_conv",
    "fused_kp_conv",
    "ROT_DIMS",
    "backward_sort_tables",
    "sorted_backward",
    "BWD_SCATTER_MODE",
    "geometry_dtype",
]

BWD_SCATTER_MODE = os.environ.get("SE3CONV_BWD_MODE", "scatter")
# the relative rotation's features by representation
ROT_DIMS = {"6D": 6, "quaternion": 4, "matrix": 9}


def geometry_dtype(compute_dtype, default: torch.dtype = torch.float32) -> torch.dtype:
    """The operand dtype of a conv of ``compute_dtype``: the edge geometry
    and the features it reads (``default``, the features' own, for None).
    The kernels take float32 or bfloat16 operands and raise on any other."""
    return default if compute_dtype is None else compute_dtype


def sorted_backward() -> bool:
    """Whether the conv backward runs the 'sorted' reduction (reads
    ``BWD_SCATTER_MODE`` now)."""
    if BWD_SCATTER_MODE not in ("scatter", "sorted"):
        raise ValueError(f"BWD_SCATTER_MODE must be 'scatter' or 'sorted', got {BWD_SCATTER_MODE!r}")
    return BWD_SCATTER_MODE == "sorted"


@torch.no_grad()
def backward_sort_tables(neigh: Neighborhood, n_src: int) -> Neighborhood:
    """Attach the sorted-edge tables of the 'sorted' backward reduction.

    Per example, over all ``M*K`` edges: ``bwd_perm``, the stable
    permutation that sorts the edges by source index; ``bwd_slot``, its
    inverse (each edge's position in source order); and ``bwd_run_start`` /
    ``bwd_run_end`` ``[B, n_src]``, each source's run in that order.
    Masked edges and padded query rows hold source 0 and park in its run,
    where they add zero rows, as in
    ``se3conv3d_tpu/ops/pne_conv.py:backward_sort_tables``; the JAX package
    keeps one table per 16,384-query chunk (a TPU compiler workaround), the
    port one per example, so the two agree where ``M <= 16384``.  Built once
    per neighborhood; every conv backward on it reuses them.
    """
    b, m, k = neigh.idx.shape
    flat = neigh.idx.reshape(b, m * k)
    perm = torch.argsort(flat, dim=1, stable=True)
    sorted_ids = flat.gather(1, perm)
    slot = torch.empty_like(perm).scatter_(
        1, perm, torch.arange(m * k, device=perm.device).expand(b, -1).contiguous())
    targets = torch.arange(n_src, device=flat.device).expand(b, -1).contiguous()
    return dataclasses.replace(
        neigh, bwd_perm=perm, bwd_slot=slot,
        bwd_run_start=torch.searchsorted(sorted_ids, targets, side="left"),
        bwd_run_end=torch.searchsorted(sorted_ids, targets, side="right"),
    )


def pne_activation(name: str) -> Optional[Callable]:
    """Activation by pne_type suffix; gelu is the exact (erf) form."""
    table = {
        "relu": F.relu,
        "gelu": F.gelu,
        "sin": torch.sin,
        "softmax": lambda x: torch.softmax(x, -1),
        "linear": None,
    }
    for suffix, fn in table.items():
        if name.endswith(suffix):
            return fn
    raise ValueError(f"unknown pne type {name!r}")


@torch.no_grad()
def relative_offsets(pc_in: PointCloud, pc_out: PointCloud, neigh: Neighborhood,
                     norm_dist: torch.Tensor) -> torch.Tensor:
    """Normalised edge offsets ``(src - center) * norm_dist -> [B, M, K, 3]``
    (``se3conv3d_tpu/ops/pne_conv.py:relative_offsets``), from the
    neighborhood's raw offsets ``std_rel`` where they are float32 (others
    are rebuilt, with a warning)."""
    rel = (neigh.std_rel if _serves(neigh.std_rel, torch.float32)
           else std_geometry(pc_in, pc_out, neigh, torch.float32))
    return rel[:, :, :, 0] * norm_dist


def linear_pne(rel, proj_axes, proj_biases, act: Optional[Callable]):
    """MLP point-neighborhood embedding ``[..., D] -> [..., Q]``."""
    out = rel @ proj_axes + proj_biases
    return out if act is None else act(out)


def kp_pne(rel, kernel_pts, sigma: float, corr: str, proj_axes, proj_biases):
    """Kernel-point embedding ``[..., 3] -> [..., Q]`` of normalised offsets
    (``se3conv3d_tpu/ops/pne_conv.py:kp_pne``, reference
    ``custom_ops/PNE.py:108-127``): correlation weights against ``kernel_pts
    [P, 3]`` ('gauss', 'linear' or 'box'), as the kernels' plain version
    computes them (:func:`kernels.fused_equiv.kp_weights`, here on offsets
    already normalised), then the linear projection."""
    unit = torch.ones((), dtype=rel.dtype, device=rel.device)
    return kp_weights(rel, KernelPoints(kernel_pts, sigma, corr, unit)) @ proj_axes + proj_biases


def basis_conv(pne, features, neigh: Neighborhood, conv_weights, norm_num_neighs,
               compute_dtype: Optional[torch.dtype] = None):
    """Standard basis-projection conv ``out[b,m,o] = norm * sum pne[b,m,k,q]
    feat[b,nbr,c] W[c,q,o]`` (``se3conv3d_tpu/ops/pne_conv.py:basis_conv``);
    ``pne [B, M, K, Q]`` must already be zero on invalid edges.  With
    ``compute_dtype`` the features, pne, weights and basis are rounded to it
    (float32 sums), as the JAX package's plain bf16 path (autograd rounds
    the cotangents at the same points, as JAX's ``astype`` does)."""
    rnd = _rounding(compute_dtype)
    basis = rnd(torch.einsum("bmkc,bmkq->bmcq", gather_rows(rnd(features), neigh.idx), rnd(pne)))
    return torch.einsum("bmcq,cqo->bmo", basis, rnd(conv_weights)) * norm_num_neighs


@torch.no_grad()
def equiv_geometry_parts(pc_in: PointCloud, pc_out: PointCloud, neigh: Neighborhood,
                         dtype: Optional[torch.dtype] = None, rel_rot_type: str = "6D"):
    """Per-edge geometry ``(rel_local [B,M,K,G,3], rot [B,M,K,G,F,R])``.

    The edge offset in each receiver frame g (unscaled: the layer's
    ``norm_neigh_dist`` is a scalar that commutes with the rotation) and the
    relative rotation ``R_g^T R_f`` in ``rel_rot_type`` (6D, R = 6;
    quaternion, 4; matrix, 9).  Layer-independent, so it is computed once
    per neighborhood.  Computed in float32 and, with ``dtype`` bfloat16
    (the kernel path's bf16 operands), rounded at the end, as the JAX
    package's fused bf16 path does
    (``se3conv3d_tpu/ops/pne_conv.py:_packed_equiv_geo_from_gf``), from
    sender frames rounded to bfloat16 as that path gathers them
    (``_equiv_geo_table``): the relative rotations carry that rounding too.
    """
    rel = gather_rows(pc_in.positions, neigh.idx) - pc_out.positions[:, :, None, :]
    frames_out = pc_out.frames
    frames_in = gather_rows(pc_in.frames, neigh.idx)
    if dtype == torch.bfloat16:
        frames_in = frames_in.to(dtype).float()
    rel_local = torch.einsum("bmkd,bmgde->bmkge", rel, frames_out)
    rel_rot = torch.einsum("bmgdp,bmkfdq->bmkgfpq", frames_out, frames_in)
    if rel_rot_type == "6D":
        rot = matrix_to_rotation_6d(rel_rot)
    elif rel_rot_type == "quaternion":
        rot = matrix_to_quaternion(rel_rot)
    elif rel_rot_type == "matrix":
        rot = rel_rot.reshape(rel_rot.shape[:-2] + (9,))
    else:
        raise ValueError(f"unknown rel_rot_type {rel_rot_type!r}")
    dtype = dtype or rel_local.dtype
    return rel_local.to(dtype).contiguous(), rot.to(dtype).contiguous()


def equiv_geometry(pc_in: PointCloud, pc_out: PointCloud, neigh: Neighborhood,
                   norm_dist: torch.Tensor, rel_rot_type: str = "6D") -> torch.Tensor:
    """The plain equivariant path's pne inputs ``[B, M, K, G, F, 3 + R]``:
    :func:`equiv_geometry_parts` in float32, the offsets scaled by
    ``norm_dist`` and repeated over the in-frames
    (``se3conv3d_tpu/ops/pne_conv.py:equiv_geometry``).  Uses the
    neighborhood's plain payload ``plain_rel`` / ``plain_rot`` where it is
    float32 in this representation (a payload that does not serve is
    rebuilt per conv, with a warning)."""
    cached = neigh.plain_rot
    if cached is not None and cached.shape[-1] != ROT_DIMS[rel_rot_type]:
        warnings.warn(f"cached relative rotations have {cached.shape[-1]} features but this conv "
                      f"reads {rel_rot_type!r}; rebuilding them per conv", stacklevel=3)
        cached = None
    if _serves(cached, torch.float32):
        rel_local, rot = neigh.plain_rel, neigh.plain_rot
    else:
        rel_local, rot = equiv_geometry_parts(pc_in, pc_out, neigh, None, rel_rot_type)
    f = rot.shape[4]
    rel_scaled = (rel_local * norm_dist)[:, :, :, :, None, :]
    return torch.cat([rel_scaled.expand(rel_scaled.shape[:4] + (f, 3)), rot], -1)


def equiv_basis_conv(pne, features, neigh: Neighborhood, conv_weights, norm_num_neighs,
                     compute_dtype: Optional[torch.dtype] = None):
    """``out[b,m,g,o] = norm/F * sum pne[b,m,k,g,f,q] feat[b,nbr,f,c] W[c,q,o]``
    (``se3conv3d_tpu/ops/pne_conv.py:equiv_basis_conv``).

    ``pne [B, M, K, G, F, Q]`` must already be zero on invalid edges;
    ``compute_dtype`` as in :func:`basis_conv`.
    """
    rnd = _rounding(compute_dtype)
    gathered = gather_rows(rnd(features), neigh.idx)  # [B, M, K, F, C]
    basis = rnd(torch.einsum("bmkfc,bmkgfq->bmgcq", gathered, rnd(pne)))
    out = torch.einsum("bmgcq,cqo->bmgo", basis, rnd(conv_weights))
    return out * (norm_num_neighs / features.shape[2])


def fused_equiv_conv(
    pc_in: PointCloud,
    pc_out: PointCloud,
    neigh: Neighborhood,
    features: torch.Tensor,
    proj_axes: torch.Tensor,
    proj_biases: torch.Tensor,
    conv_weights: torch.Tensor,
    norm_dist: torch.Tensor,
    norm_num_neighs: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    act: str = "gelu",
    points_total: Optional[int] = None,
) -> torch.Tensor:
    """Rot-equivariant mlp conv (6D relative rotations) through the fused
    kernel -> ``[B,M,G,O]``, with the pne activation ``act`` (gelu, relu,
    sin or linear).

    ``norm_dist`` folds into the three offset rows of the projection
    (``act((s*rel) @ A + rot @ B + b) == act(rel @ (s*A) + ...)``), invalid
    edges contribute zero, and the output is scaled by
    ``norm_num_neighs / F``.  Uses the neighborhood's cached geometry and
    live-row table when present.  CUDA tensors run the CUDA kernels, CPU tensors their plain
    versions (``kernels.fused_equiv``), forward and backward.  Gradients
    reach ``features``, ``proj_axes`` (through the ``norm_dist`` fold),
    ``proj_biases`` and ``conv_weights``; the two calibration buffers get
    none, as in ``se3conv3d_tpu/nn/conv.py``.  In 'sorted' mode the feature
    gradient goes through the neighborhood's sort tables, built here when
    it carries none.

    ``compute_dtype`` bfloat16 runs the kernels' bfloat16 operand path, as
    ``se3conv3d_tpu/ops/pne_conv.py:fused_equiv_conv`` does: the geometry
    in bfloat16 (rounded once from float32), the features rounded to
    bfloat16 before the gather, float32 sums, and the output in the
    features' dtype; the feature gradient comes back rounded to bfloat16,
    then widened to the features' dtype.  None or float32 computes in
    float32.  A cached geometry of the other dtype is rebuilt, never
    converted (as the JAX package does, with a warning).

    ``points_total``: on a points group (``parallel.mesh``), ``features``
    are this rank's rows of ``pc_in``, a source level of that many rows,
    which the kernels' autograd node gathers over the points row
    (``kernels.fused_equiv.FusedEquivConv``); the same in
    :func:`fused_conv` and :func:`fused_kp_conv`.
    """
    geo_dt = geometry_dtype(compute_dtype, features.dtype)
    if _serves(neigh.equiv_rel, geo_dt):
        rel, rot6 = neigh.equiv_rel, neigh.equiv_rot
    else:
        rel, rot6 = equiv_geometry_parts(pc_in, pc_out, neigh, geo_dt)
    pa_scaled = torch.cat([proj_axes[:3] * norm_dist, proj_axes[3:]], 0)
    out = fused_equiv(
        rel, rot6, features.to(geo_dt).contiguous(), neigh.idx, neigh.mask,
        pa_scaled, proj_biases.contiguous(), conv_weights.contiguous(),
        _sort_tables(neigh, features, points_total), neigh.live_rows, act, points_total=points_total,
    )
    return (out * (norm_num_neighs / features.shape[2])).to(features.dtype)


def _serves(cached: Optional[torch.Tensor], geo_dt: torch.dtype) -> bool:
    """Whether a neighborhood's cached edge geometry ``cached`` serves a conv
    whose operands are ``geo_dt``.  A cache of the other dtype is rebuilt
    per conv, never converted (as the JAX package does), with a warning."""
    if cached is None:
        return False
    if cached.dtype != geo_dt:
        warnings.warn(
            f"cached edge geometry is {cached.dtype} but this conv computes in "
            f"{geo_dt}; rebuilding it per conv: align compute_dtype across the convs that "
            "share this neighborhood to share the cache", stacklevel=3)
    return cached.dtype == geo_dt


def _sort_tables(neigh: Neighborhood, features: torch.Tensor, points_total: Optional[int] = None):
    """The sort tables ``(slot, run_start, run_end)`` of the 'sorted'
    reduction where this conv's backward will run it (built here when the
    neighborhood carries none for the source count: ``points_total``, else
    ``features``' rows), else None."""
    if not (sorted_backward() and torch.is_grad_enabled() and features.requires_grad):
        return None
    n_src = points_total or features.shape[1]
    if neigh.bwd_slot is None or neigh.bwd_run_start.shape[1] != n_src:
        neigh = backward_sort_tables(neigh, n_src)
    return neigh.bwd_slot, neigh.bwd_run_start, neigh.bwd_run_end


@torch.no_grad()
def std_geometry(pc_in: PointCloud, pc_out: PointCloud, neigh: Neighborhood,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-edge geometry of the standard conv, ``[B, M, K, 1, 3]``: the raw
    edge offsets ``pos_in[idx] - pos_out`` (unscaled: the layer's
    ``norm_neigh_dist`` scales the projection), computed in float32 and
    rounded once to ``dtype``, as ``se3conv3d_tpu/ops/pne_conv.py:
    _std_geo_chunk`` packs them.  Layer-independent, so it is computed once
    per neighborhood: the counterpart of :func:`equiv_geometry_parts`."""
    rel = gather_rows(pc_in.positions, neigh.idx) - pc_out.positions[:, :, None, :]
    return rel[:, :, :, None, :].to(dtype or rel.dtype).contiguous()


def fused_conv(
    pc_in: PointCloud,
    pc_out: PointCloud,
    neigh: Neighborhood,
    features: torch.Tensor,
    proj_axes: torch.Tensor,
    proj_biases: torch.Tensor,
    conv_weights: torch.Tensor,
    norm_dist: torch.Tensor,
    norm_num_neighs: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    act: str = "gelu",
    points_total: Optional[int] = None,
) -> torch.Tensor:
    """Standard (non-equivariant) mlp conv through the fused kernel:
    ``features [B, N, C] -> [B, M, O]`` (``se3conv3d_tpu/ops/pne_conv.py:
    fused_conv``), with the pne activation ``act``.

    The kernels' standard geometry: G = F = 1 (the features viewed as
    ``[B, N, 1, C]``), the raw offsets (:func:`std_geometry`, the
    neighborhood's cached ``std_rel`` when present) as the 3 pne inputs,
    ``norm_dist`` folded into all three rows of ``proj_axes [3, Q]``, and
    the output scaled by ``norm_num_neighs`` (there is no frame count to
    divide by).  Gradients reach ``features``, ``proj_axes``,
    ``proj_biases`` and ``conv_weights``; the calibration buffers get none.
    ``compute_dtype``, the 'sorted' feature-gradient tables, the live-row
    table and ``points_total`` as in :func:`fused_equiv_conv`.
    """
    geo_dt = geometry_dtype(compute_dtype, features.dtype)
    rel = neigh.std_rel if _serves(neigh.std_rel, geo_dt) else std_geometry(pc_in, pc_out, neigh, geo_dt)
    out = fused_equiv(
        rel, None, features[:, :, None, :].to(geo_dt).contiguous(), neigh.idx, neigh.mask,
        (proj_axes * norm_dist).contiguous(), proj_biases.contiguous(), conv_weights.contiguous(),
        _sort_tables(neigh, features, points_total), neigh.live_rows, act, points_total=points_total,
    )
    return (out[:, :, 0] * norm_num_neighs).to(features.dtype)


def fused_kp_conv(
    pc_in: PointCloud,
    pc_out: PointCloud,
    neigh: Neighborhood,
    features: torch.Tensor,
    kernel_pts: torch.Tensor,
    sigma: float,
    corr: str,
    proj_axes: torch.Tensor,
    proj_biases: torch.Tensor,
    conv_weights: torch.Tensor,
    norm_dist: torch.Tensor,
    norm_num_neighs: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    points_total: Optional[int] = None,
) -> torch.Tensor:
    """Kernel-point (kp_*) conv through the fused kernel: ``features [B, N,
    C] -> [B, M, O]`` (``se3conv3d_tpu/ops/pne_conv.py:fused_kp_conv``).

    The kernels' kernel-point geometry: G = F = 1, the pne inputs the P
    correlation weights of each edge against ``kernel_pts [P, 3]`` (float32
    on the features' device; ``sigma``, ``corr`` 'gauss', 'linear' or
    'box'), computed by the kernels from the float32 raw offsets (the
    neighborhood's ``std_rel`` where it is float32, else
    :func:`std_geometry`) scaled by ``norm_dist``, read on the device;
    ``proj_axes [P, Q]`` unscaled and the identity activation, so the
    projection is the kp ``[P] -> [Q]`` linear map.  The output is scaled by
    ``norm_num_neighs``.  With ``compute_dtype`` bfloat16 the features and
    each weight are rounded to bfloat16 (the weights from float32 offsets,
    as JAX computes them before its cast).  Gradients reach ``features``,
    ``proj_axes``, ``proj_biases`` and ``conv_weights``; the weights and
    the calibration buffers get none.  The sort tables, the live-row table
    and ``points_total`` as in :func:`fused_equiv_conv`.
    """
    geo_dt = geometry_dtype(compute_dtype, features.dtype)
    rel = neigh.std_rel if _serves(neigh.std_rel, torch.float32) else std_geometry(
        pc_in, pc_out, neigh, torch.float32)
    kp = KernelPoints(kernel_pts, sigma, corr, norm_dist.detach().reshape(()).float())
    out = fused_equiv(
        rel, None, features[:, :, None, :].to(geo_dt).contiguous(), neigh.idx, neigh.mask,
        proj_axes.contiguous(), proj_biases.contiguous(), conv_weights.contiguous(),
        _sort_tables(neigh, features, points_total), neigh.live_rows, "linear", kp, points_total,
    )
    return (out[:, :, 0] * norm_num_neighs).to(features.dtype)
