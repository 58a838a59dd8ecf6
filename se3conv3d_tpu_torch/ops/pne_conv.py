"""Point-neighborhood-embedding conv ops (counterpart of
``se3conv3d_tpu/ops/pne_conv.py``, the fused mlp paths: the equivariant
conv, :func:`fused_equiv_conv`, and the standard one, :func:`fused_conv`).

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
from ..core.rotation import matrix_to_rotation_6d
from ..kernels.fused_equiv import fused_equiv

__all__ = [
    "pne_activation",
    "linear_pne",
    "equiv_geometry_parts",
    "equiv_basis_conv",
    "fused_equiv_conv",
    "std_geometry",
    "fused_conv",
    "backward_sort_tables",
    "sorted_backward",
    "BWD_SCATTER_MODE",
    "geometry_dtype",
]

BWD_SCATTER_MODE = os.environ.get("SE3CONV_BWD_MODE", "scatter")


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


def linear_pne(rel, proj_axes, proj_biases, act: Optional[Callable]):
    """MLP point-neighborhood embedding ``[..., D] -> [..., Q]``."""
    out = rel @ proj_axes + proj_biases
    return out if act is None else act(out)


@torch.no_grad()
def equiv_geometry_parts(pc_in: PointCloud, pc_out: PointCloud, neigh: Neighborhood,
                         dtype: Optional[torch.dtype] = None):
    """Per-edge geometry ``(rel_local [B,M,K,G,3], rot6 [B,M,K,G,F,6])``.

    The edge offset in each receiver frame g (unscaled: the layer's
    ``norm_neigh_dist`` is a scalar that commutes with the rotation) and the
    6D form of the relative rotation ``R_g^T R_f``.  Layer-independent, so
    it is computed once per neighborhood.  Computed in float32 and, with
    ``dtype`` bfloat16, rounded at the end, as the JAX package's fused bf16
    path does (``se3conv3d_tpu/ops/pne_conv.py:_packed_equiv_geo_from_gf``),
    from sender frames rounded to bfloat16 as that path gathers them
    (``_equiv_geo_table``): the relative rotations carry that rounding too.
    """
    rel = gather_rows(pc_in.positions, neigh.idx) - pc_out.positions[:, :, None, :]
    frames_out = pc_out.frames
    frames_in = gather_rows(pc_in.frames, neigh.idx)
    if dtype == torch.bfloat16:
        frames_in = frames_in.to(dtype).float()
    rel_local = torch.einsum("bmkd,bmgde->bmkge", rel, frames_out)
    rel_rot = torch.einsum("bmgdp,bmkfdq->bmkgfpq", frames_out, frames_in)
    dtype = dtype or rel_local.dtype
    return (rel_local.to(dtype).contiguous(),
            matrix_to_rotation_6d(rel_rot).to(dtype).contiguous())


def equiv_basis_conv(pne, features, neigh: Neighborhood, conv_weights, norm_num_neighs):
    """``out[b,m,g,o] = norm/F * sum pne[b,m,k,g,f,q] feat[b,nbr,f,c] W[c,q,o]``.

    ``pne [B, M, K, G, F, Q]`` must already be zero on invalid edges.
    """
    f_in = features.shape[2]
    gathered = gather_rows(features, neigh.idx)  # [B, M, K, F, C]
    basis = torch.einsum("bmkfc,bmkgfq->bmgcq", gathered, pne)
    out = torch.einsum("bmgcq,cqo->bmgo", basis, conv_weights)
    return out * (norm_num_neighs / f_in)


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
) -> torch.Tensor:
    """Rot-equivariant mlp_gelu conv through the fused kernel -> ``[B,M,G,O]``.

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
        _sort_tables(neigh, features), neigh.live_rows,
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


def _sort_tables(neigh: Neighborhood, features: torch.Tensor):
    """The sort tables ``(slot, run_start, run_end)`` of the 'sorted'
    reduction where this conv's backward will run it (built here when the
    neighborhood carries none for ``features``' source count), else None."""
    if not (sorted_backward() and torch.is_grad_enabled() and features.requires_grad):
        return None
    n_src = features.shape[1]
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
) -> torch.Tensor:
    """Standard (non-equivariant) mlp_gelu conv through the fused kernel:
    ``features [B, N, C] -> [B, M, O]`` (``se3conv3d_tpu/ops/pne_conv.py:
    fused_conv``).

    The kernels' standard geometry: G = F = 1 (the features viewed as
    ``[B, N, 1, C]``), the raw offsets (:func:`std_geometry`, the
    neighborhood's cached ``std_rel`` when present) as the 3 pne inputs,
    ``norm_dist`` folded into all three rows of ``proj_axes [3, Q]``, and
    the output scaled by ``norm_num_neighs`` (there is no frame count to
    divide by).  Gradients reach ``features``, ``proj_axes``,
    ``proj_biases`` and ``conv_weights``; the calibration buffers get none.
    ``compute_dtype``, the 'sorted' feature-gradient tables and the
    live-row table as in :func:`fused_equiv_conv`.
    """
    geo_dt = geometry_dtype(compute_dtype, features.dtype)
    rel = neigh.std_rel if _serves(neigh.std_rel, geo_dt) else std_geometry(pc_in, pc_out, neigh, geo_dt)
    out = fused_equiv(
        rel, None, features[:, :, None, :].to(geo_dt).contiguous(), neigh.idx, neigh.mask,
        (proj_axes * norm_dist).contiguous(), proj_biases.contiguous(), conv_weights.contiguous(),
        _sort_tables(neigh, features), neigh.live_rows,
    )
    return (out[:, :, 0] * norm_num_neighs).to(features.dtype)
