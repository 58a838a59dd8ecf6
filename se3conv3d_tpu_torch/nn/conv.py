"""Point convolution layer (counterpart of ``se3conv3d_tpu/nn/conv.py``).

Ported: the mlp_gelu conv with 'add' aggregation in both of its forms:
the locally SE(3)-equivariant one with 6D relative rotations (the rot
recipes), through ``ops.pne_conv.fused_equiv_conv``, and the standard
(non-equivariant) one (the standard recipes), through
``ops.pne_conv.fused_conv``; each runs the CUDA kernels on the card and
their plain versions on the CPU, in float32 or, with ``compute_dtype``
bfloat16, with bfloat16 operands and float32 sums (the ScanNet recipes'
``compute_dtype: bfloat16``).

Calibration buffers (the reference's pre-process epoch,
``IConvLayer.py:75-97``): ``norm_neigh_dist`` and ``norm_num_neighs`` start
at 1.0, the first calibration pass sets them directly and later passes take
a 0.9/0.1 EMA; ball-query neighborhoods use ``1/radius``.  ``trunc_frac``
keeps the largest fraction of query rows whose ball held more than the
neighbor cap.
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

__all__ = ["PNEConv", "ConvFactory", "check_neighbor_caps"]


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


def _check_supported(pne_type: str, equivariant: bool, rel_rot_type: str, aggregation: str):
    # the standard conv has no relative rotation: its rel_rot_type is unread
    if (pne_type, aggregation) != ("mlp_gelu", "add") or (equivariant and rel_rot_type != "6D"):
        raise NotImplementedError(
            "only the mlp_gelu / 'add' conv is ported (6D rotations where equivariant), got "
            f"pne_type={pne_type!r}, equivariant={equivariant}, "
            f"rel_rot_type={rel_rot_type!r}, aggregation={aggregation!r}"
        )


class PNEConv(nn.Module):
    """Point conv: ``features [B, N, F, C] -> [B, M, G, O]`` (equivariant)
    or ``[B, N, C] -> [B, M, O]`` (standard).

    Parameters ``proj_axes [9, Q]`` (equivariant: 3 offset rows and the 6D
    rotation) or ``[3, Q]`` (standard), ``proj_biases [Q]`` and
    ``conv_weights [C, Q, O]`` (float32 whatever ``compute_dtype``);
    calibration buffers ``norm_neigh_dist``, ``norm_num_neighs``,
    ``initialized`` and ``trunc_frac``.
    """

    def __init__(self, in_features: int, out_features: int, num_basis: int = 32,
                 pne_type: str = "mlp_gelu", equivariant: bool = True,
                 rel_rot_type: str = "6D", aggregation: str = "add",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_supported(pne_type, equivariant, rel_rot_type, aggregation)
        self.equivariant = equivariant
        self.compute_dtype = compute_dtype
        self.proj_axes = nn.Parameter(torch.empty(9 if equivariant else 3, num_basis))
        self.proj_biases = nn.Parameter(torch.zeros(num_basis))
        self.conv_weights = nn.Parameter(torch.empty(in_features, num_basis, out_features))
        self.register_buffer("norm_neigh_dist", torch.ones(()))
        self.register_buffer("norm_num_neighs", torch.ones(()))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))
        self.register_buffer("trunc_frac", torch.zeros(()))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        p_dims, q = self.proj_axes.shape
        s1 = math.sqrt(1.0 / p_dims)
        s2 = math.sqrt(1.0 / (self.conv_weights.shape[0] * q))
        nn.init.uniform_(self.proj_axes, -s1, s1, generator=generator)
        nn.init.zeros_(self.proj_biases)
        nn.init.uniform_(self.conv_weights, -s2, s2, generator=generator)

    @torch.no_grad()
    def _calibrate(self, pc_in: PointCloud, pc_out: PointCloud, neigh: Neighborhood) -> None:
        if neigh.method == "ball_query":
            new_dist = torch.tensor(1.0 / neigh.radius, device=self.norm_neigh_dist.device)
        else:
            src = gather_rows(pc_in.positions, neigh.idx)
            dist = (src - pc_out.positions[:, :, None, :]).pow(2).sum(-1).sqrt()
            edges = neigh.mask.sum().clamp(min=1)
            mean_dist = torch.where(neigh.mask, dist, torch.zeros_like(dist)).sum() / edges
            new_dist = 1.0 / (2.0 * mean_dist)
        rows = neigh.query_mask.sum()
        new_neighs = rows / neigh.mask.sum().clamp(min=1)
        seen = self.initialized
        self.norm_neigh_dist.copy_(
            torch.where(seen, 0.9 * self.norm_neigh_dist + 0.1 * new_dist, new_dist)
        )
        self.norm_num_neighs.copy_(
            torch.where(seen, 0.9 * self.norm_num_neighs + 0.1 * new_neighs, new_neighs)
        )
        self.initialized.fill_(True)
        if neigh.trunc is not None:
            frac = neigh.trunc.sum() / rows.clamp(min=1)
            self.trunc_frac.copy_(torch.maximum(self.trunc_frac, frac))

    def forward(self, pc_in: PointCloud, pc_out: PointCloud, features: torch.Tensor,
                neigh: Neighborhood, calibrate: bool = False) -> torch.Tensor:
        if calibrate:
            self._calibrate(pc_in, pc_out, neigh)
        conv = ops.fused_equiv_conv if self.equivariant else ops.fused_conv
        return conv(
            pc_in, pc_out, neigh, features, self.proj_axes, self.proj_biases,
            self.conv_weights, self.norm_neigh_dist, self.norm_num_neighs, self.compute_dtype,
        )


@dataclasses.dataclass(frozen=True)
class ConvFactory:
    """Conv-layer spec that models use to stamp out convs.  ``compute_dtype``
    None (float32), ``torch.float32`` or ``torch.bfloat16``: the convs'
    operand type, as the JAX package's ``ConvFactory.compute_dtype``."""

    num_basis: int = 32
    pne_type: str = "mlp_gelu"
    equivariant: bool = True
    rel_rot_type: str = "6D"
    aggregation: str = "add"
    compute_dtype: Optional[torch.dtype] = None

    def make(self, in_features: int, out_features: int) -> PNEConv:
        return PNEConv(
            in_features, out_features, self.num_basis, self.pne_type,
            self.equivariant, self.rel_rot_type, self.aggregation, self.compute_dtype,
        )
