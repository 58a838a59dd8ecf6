"""Point convolution layer (counterpart of ``se3conv3d_tpu/nn/conv.py``).

``PNEConv`` takes every ``pne_type`` (``mlp_{relu,gelu,sin,softmax,linear}``,
``kp_{gauss,linear,box}[_double]``), ``aggregation`` ('add', 'max') and
``rel_rot_type`` ('6D', 'quaternion', 'matrix') that the JAX ``PNEConv``
takes, and dispatches as it does (:func:`fused_dispatch`):

* the kernel path, where the JAX package runs its Pallas kernels: the mlp
  convs but softmax with 'add' (equivariant ones with 6D rotations), through
  ``ops.pne_conv.fused_equiv_conv`` / ``fused_conv`` with the activation,
  and the standard kernel-point convs with 'add', through
  ``ops.pne_conv.fused_kp_conv``; each runs the CUDA kernels on the card
  and their plain versions on the CPU, in float32 or, with
  ``compute_dtype`` bfloat16, with bfloat16 operands and float32 sums;
* the plain path, in PyTorch ops on whichever device holds the tensors,
  where the JAX package runs XLA: ``mlp_softmax``, 'max' aggregation, the
  quaternion and matrix rotations, and ``use_fused=False``.

An equivariant kernel-point conv raises ``NotImplementedError``, as in the
JAX package (reference ``PNEConvLayerRotEquiv.py:221-222``).  The kernel
points carry no random rotation, as the JAX package's do not (the
reference rotates them at init).

Calibration buffers (the reference's pre-process epoch,
``IConvLayer.py:75-97``): ``norm_neigh_dist`` and ``norm_num_neighs`` start
at 1.0, the first calibration pass sets them directly and later passes take
a 0.9/0.1 EMA; ball-query neighborhoods use ``1/radius``.  ``trunc_frac``
keeps the largest fraction of query rows whose ball held more than the
neighbor cap.  In a data-parallel group every sum of the calibration is the
global batch's, as on a JAX mesh.

On a points group (``parallel.mesh``) ``pc_in`` and ``pc_out`` are this
rank's row slices of their levels and the features its rows of ``pc_in``:
the conv reads the whole source level (``pc_in.source``) through one
gather over the points row, inside the kernels' autograd node on the kernel
path (``ops.pne_conv``'s ``points_total``) and by
``parallel.mesh.points_gather`` on the plain path, and writes the rank's
query rows.  Its calibration sums the rank's rows over the group.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..core.neighborhoods import Neighborhood
from ..core.pointcloud import PointCloud, gather_rows
from ..ops import pne_conv as ops
from ..parallel.mesh import group_sum_, in_group, points_gather
from .icosphere import icosphere_points

__all__ = ["PNEConv", "ConvFactory", "calibrate_norms", "check_neighbor_caps", "fused_dispatch"]


def check_neighbor_caps(calib: Union[nn.Module, Mapping[str, torch.Tensor]],
                        threshold: float = 0.01, warn: bool = True) -> Dict[str, float]:
    """Neighbor-cap certificate (``se3conv3d_tpu/nn/conv.py:check_neighbor_caps``):
    the convs whose calibration saw ball-query truncation.

    The reference's ball query is unbounded; the port keeps the nearest
    ``ModelSpec.max_neighbors``.  Each conv's ``trunc_frac`` buffer holds the
    largest fraction of query rows whose ball held more than the cap during
    calibration; this turns those buffers into a report.

    Args:
      calib: a calibrated model, or its ``state_dict``.
      threshold: least truncated-row fraction reported.
      warn: emit one ``UserWarning`` naming the offending convs.

    Returns:
      ``{conv path: truncated fraction}`` above ``threshold``, the path
      written as the JAX package writes it (``encoder/level_1/conv_0``).
    """
    tensors = dict(calib.state_dict()) if isinstance(calib, nn.Module) else dict(calib)
    bad = {
        name.rpartition(".")[0].replace(".", "/"): float(value)
        for name, value in tensors.items()
        if name.rpartition(".")[2] == "trunc_frac" and float(value) > threshold
    }
    if bad and warn:
        listing = ", ".join(f"{p}: {f:.1%}" for p, f in sorted(bad.items()))
        warnings.warn(
            "ball-query neighbor cap truncated real neighborhoods during "
            f"calibration ({listing}); the reference's ball query is "
            "unbounded — raise Model.max_neighbors or shrink the radii "
            "to keep parity",
            UserWarning,
        )
    return bad


def fused_dispatch(pne_type: str, aggregation: str, equivariant: bool, rel_rot_type: str,
                   use_fused: Optional[bool]) -> bool:
    """Whether a conv of this kind runs the kernel path: the predicate of
    ``se3conv3d_tpu/nn/conv.py:fused_dispatch`` where the Pallas kernels run
    (a TPU).  Kernel-point convs with 'add' in the standard form; mlp convs
    but softmax with 'add', equivariant ones with 6D rotations.
    ``use_fused`` False forces the plain path; True takes the kernel path
    wherever the kind allows it (on the CPU it runs the kernels' plain
    versions).  None means the same as True: in the JAX package it picks
    by backend, and the port, whose kernels serve every tensor on the card,
    keeps it only to take the JAX package's arguments as they are.  It
    depends on the kind only, so the neighborhood provider's choice of
    payload agrees with every conv."""
    if pne_type.startswith("kp"):
        kernel_ok = aggregation == "add" and not equivariant
    else:
        kernel_ok = ("mlp" in pne_type and not pne_type.endswith("softmax") and aggregation == "add"
                     and (not equivariant or rel_rot_type == "6D"))
    return kernel_ok and use_fused is not False


def _kernel_points(pne_type: str):
    """``([P, 3] float32 kernel points, sigma)`` by pne type, as
    ``se3conv3d_tpu/nn/conv.py:_kernel_points`` (reference
    ``PNEConvLayer.py:102-134``, without its random rotation): the
    icosahedron's 12 vertices and the center (P = 13), or with ``_double``
    the vertices at 0.35, the 42 of the once-subdivided icosphere at 0.7 and
    the center (P = 55)."""
    if "double" in pne_type:
        kp_scale = 0.35
        kp = torch.cat([torch.tensor(icosphere_points(0) * kp_scale, dtype=torch.float32),
                        torch.tensor(icosphere_points(1) * kp_scale * 2, dtype=torch.float32),
                        torch.zeros(1, 3)])
        sigma = {"kp_linear_double": 0.2, "kp_gauss_double": 0.16, "kp_box_double": 1.0}[pne_type]
    else:
        kp = torch.cat([torch.tensor(icosphere_points(0), dtype=torch.float32), torch.zeros(1, 3)]) * 0.6
        sigma = {"kp_linear": 0.4, "kp_gauss": 0.3, "kp_box": 1.0}[pne_type]
    return kp, sigma


@torch.no_grad()
def calibrate_norms(layer: nn.Module, pc_in: PointCloud, pc_out: PointCloud,
                    neigh: Neighborhood) -> torch.Tensor:
    """One calibration pass of ``layer``'s buffers ``norm_neigh_dist``,
    ``norm_num_neighs`` and ``initialized`` (module note): ``1/radius`` for a
    ball query, else ``1 / (2 * mean edge length)``; query rows per valid
    edge; set on the first pass, then a 0.9/0.1 EMA.  In a data-parallel
    group (``parallel.mesh``) the sums are the global batch's, summed over
    the ranks before they divide, so every rank sets the same buffers.
    Returns the number of query rows (the global batch's)."""
    edges, rows = neigh.mask.sum(), neigh.query_mask.sum()
    if in_group():  # the global batch's sums (module note)
        edges, rows = group_sum_(torch.stack([edges, rows]))
    if neigh.method == "ball_query":
        new_dist = torch.tensor(1.0 / neigh.radius, device=layer.norm_neigh_dist.device)
    else:
        src = gather_rows(pc_in.positions, neigh.idx)
        dist = (src - pc_out.positions[:, :, None, :]).pow(2).sum(-1).sqrt()
        dist_sum = group_sum_(torch.where(neigh.mask, dist, torch.zeros_like(dist)).sum())
        new_dist = 1.0 / (2.0 * (dist_sum / edges.clamp(min=1)))
    new_neighs = rows / edges.clamp(min=1)
    seen = layer.initialized
    layer.norm_neigh_dist.copy_(
        torch.where(seen, 0.9 * layer.norm_neigh_dist + 0.1 * new_dist, new_dist)
    )
    layer.norm_num_neighs.copy_(
        torch.where(seen, 0.9 * layer.norm_num_neighs + 0.1 * new_neighs, new_neighs)
    )
    layer.initialized.fill_(True)
    return rows


class PNEConv(nn.Module):
    """Point conv: ``features [B, N, F, C] -> [B, M, G, O]`` (equivariant)
    or ``[B, N, C] -> [B, M, O]`` (standard).

    Parameters ``proj_axes`` (``[3 + R, Q]`` equivariant, R = 6, 4 or 9 by
    ``rel_rot_type``; ``[3, Q]`` standard mlp; ``[P, Q]`` kernel-point, P =
    13 or 55), ``proj_biases [Q]`` and ``conv_weights [C, Q, O]`` (float32
    whatever ``compute_dtype``); calibration buffers ``norm_neigh_dist``,
    ``norm_num_neighs``, ``initialized`` and ``trunc_frac``; a kernel-point
    conv also holds its ``kernel_points`` (a buffer outside the
    ``state_dict``: the JAX package computes them, it does not store them).
    ``use_fused`` as in :func:`fused_dispatch`.
    """

    def __init__(self, in_features: int, out_features: int, num_basis: int = 32,
                 pne_type: str = "mlp_gelu", equivariant: bool = True,
                 rel_rot_type: str = "6D", aggregation: str = "add",
                 compute_dtype: Optional[torch.dtype] = None, use_fused: Optional[bool] = None):
        super().__init__()
        if equivariant and "kp" in pne_type:
            raise NotImplementedError(
                "kernel-point PNE is not defined for the equivariant path "
                "(reference PNEConvLayerRotEquiv.py:221-222)"
            )
        rot_dims = ops.ROT_DIMS[rel_rot_type]
        self.pne_type, self.equivariant, self.rel_rot_type = pne_type, equivariant, rel_rot_type
        self.aggregation, self.compute_dtype = aggregation, compute_dtype
        self.fused = fused_dispatch(pne_type, aggregation, equivariant, rel_rot_type, use_fused)
        if "mlp" in pne_type:
            self.act = ops.pne_activation(pne_type)
            p_dims = 3 + rot_dims if equivariant else 3
        else:
            kernel_points, self.sigma = _kernel_points(pne_type)
            self.corr = "gauss" if "gauss" in pne_type else "box" if "box" in pne_type else "linear"
            p_dims = kernel_points.shape[0]
        self.proj_axes = nn.Parameter(torch.empty(p_dims, num_basis))
        self.proj_biases = nn.Parameter(torch.zeros(num_basis))
        self.conv_weights = nn.Parameter(torch.empty(in_features, num_basis, out_features))
        self.register_buffer("norm_neigh_dist", torch.ones(()))
        self.register_buffer("norm_num_neighs", torch.ones(()))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))
        self.register_buffer("trunc_frac", torch.zeros(()))
        if "mlp" not in pne_type:
            self.register_buffer("kernel_points", kernel_points, persistent=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        p_dims, q = self.proj_axes.shape
        s1 = math.sqrt(1.0 / p_dims)
        s2 = math.sqrt(1.0 / (self.conv_weights.shape[0] * q))
        nn.init.uniform_(self.proj_axes, -s1, s1, generator=generator)
        nn.init.zeros_(self.proj_biases)
        nn.init.uniform_(self.conv_weights, -s2, s2, generator=generator)

    @torch.no_grad()
    def _calibrate(self, pc_in: PointCloud, pc_out: PointCloud, neigh: Neighborhood) -> None:
        rows = calibrate_norms(self, pc_in, pc_out, neigh)
        if neigh.trunc is not None:
            frac = group_sum_(neigh.trunc.sum()) / rows.clamp(min=1)
            self.trunc_frac.copy_(torch.maximum(self.trunc_frac, frac))

    def forward(self, pc_in: PointCloud, pc_out: PointCloud, features: torch.Tensor,
                neigh: Neighborhood, calibrate: bool = False) -> torch.Tensor:
        # on a points group: the whole source level, and its rows to gather
        pc_in, total = pc_in.source, (None if pc_in.whole is None else pc_in.whole.capacity)
        if calibrate:
            self._calibrate(pc_in, pc_out, neigh)
        pa, pb, w = self.proj_axes, self.proj_biases, self.conv_weights
        nd, nn_ = self.norm_neigh_dist, self.norm_num_neighs
        if self.fused and "mlp" not in self.pne_type:
            return ops.fused_kp_conv(pc_in, pc_out, neigh, features, self.kernel_points, self.sigma,
                                     self.corr, pa, pb, w, nd, nn_, self.compute_dtype, total)
        if self.fused:
            conv = ops.fused_equiv_conv if self.equivariant else ops.fused_conv
            return conv(pc_in, pc_out, neigh, features, pa, pb, w, nd, nn_, self.compute_dtype,
                        self.pne_type.split("_")[-1], total)
        if total is not None:
            features = points_gather(features, 1, total)
        mask = neigh.mask
        if self.equivariant:  # the plain path, as the JAX package's XLA path
            geo = ops.equiv_geometry(pc_in, pc_out, neigh, nd, self.rel_rot_type)
            pne = ops.linear_pne(geo, pa, pb, self.act) * mask[:, :, :, None, None, None]
            return ops.equiv_basis_conv(pne, features, neigh, w, nn_, self.compute_dtype)
        rel = ops.relative_offsets(pc_in, pc_out, neigh, nd)
        if "mlp" in self.pne_type:
            pne = ops.linear_pne(rel, pa, pb, self.act)
        else:
            pne = ops.kp_pne(rel, self.kernel_points, self.sigma, self.corr, pa, pb)
        pne = pne * mask[..., None]
        if self.aggregation == "max":  # reference PNEConvLayer.py:224-227
            per_edge = torch.einsum("bmkc,bmkq,cqo->bmko", gather_rows(features, neigh.idx), pne, w)
            per_edge = torch.where(mask[..., None], per_edge, torch.finfo(per_edge.dtype).min)
            out = torch.where(mask.any(2)[..., None], per_edge.max(2).values, 0.0)
            return out * nn_
        return ops.basis_conv(pne, features, neigh, w, nn_, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class ConvFactory:
    """Conv-layer spec that models use to stamp out convs (the JAX
    package's ``ConvFactory``).  ``compute_dtype`` None (float32),
    ``torch.float32`` or ``torch.bfloat16``: the convs' operand type;
    ``use_fused`` as in :func:`fused_dispatch` (False: the plain path; None,
    the JAX package's default, as True)."""

    num_basis: int = 32
    pne_type: str = "mlp_gelu"
    equivariant: bool = True
    rel_rot_type: str = "6D"
    aggregation: str = "add"
    compute_dtype: Optional[torch.dtype] = None
    use_fused: Optional[bool] = None

    @property
    def fused(self) -> bool:
        """Whether the convs it makes run the kernel path."""
        return fused_dispatch(self.pne_type, self.aggregation, self.equivariant,
                              self.rel_rot_type, self.use_fused)

    def make(self, in_features: int, out_features: int) -> PNEConv:
        return PNEConv(
            in_features, out_features, self.num_basis, self.pne_type, self.equivariant,
            self.rel_rot_type, self.aggregation, self.compute_dtype, self.use_fused,
        )
