"""Attention point convs (counterparts of ``se3conv3d_tpu/nn/attention.py``,
reference ``layers/MultiHeadAttLayer.py`` and ``layers/LoRAttConvLayer.py``).

A gaussian kernel-point embedding of each edge aggregates the neighbors'
query and value projections into ``num_basis`` slots, multi-head attention
with the point's own key runs over the slots (a learned positional
embedding ``pe`` added to the queries), and ``LoRAttConv`` adds a parallel
basis-weighted conv term.  The JAX layer runs XLA einsums, not a Pallas
kernel, so these are PyTorch ops on whichever device holds the tensors.
Same-cloud only, as in the JAX package (the reference asserts ``p_pc_in ==
p_pc_out``).  On a points group (``parallel.mesh``) the clouds are this
rank's row slice: the neighbours' query and value projections come from the
whole level through one gather over the points row
(``parallel.mesh.points_gather``), each point's key from its own row.
Calibration follows :class:`~se3conv3d_tpu_torch.nn.conv.PNEConv`
(:func:`~se3conv3d_tpu_torch.nn.conv.calibrate_norms`); the kernel points
carry the reference's random rotation, a ``numpy`` draw from ``kp_seed``
(:func:`rotated_kernel_points`), the same bits as the JAX package's.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.neighborhoods import Neighborhood
from ..core.pointcloud import PointCloud, gather_rows
from ..ops import pne_conv as ops
from ..parallel.mesh import points_gather
from .blocks import TorchLinear
from .conv import calibrate_norms
from .icosphere import icosphere_points

__all__ = ["MultiHeadAttConv", "LoRAttConv", "rotated_kernel_points"]


def rotated_kernel_points(seed: int, kp_res: str):
    """``([P, 3] float32 numpy kernel points, sigma)``: the icosahedron's
    vertices at 0.6 and the center (P = 13, sigma 0.3), or with ``kp_res``
    ``'double'`` the vertices at 0.35, the once-subdivided icosphere's 42 at
    0.7 and the center (P = 55, sigma 0.16), turned by the Euler rotation
    ``rx @ ry @ rz`` of three angles ``RandomState(seed).uniform(size=3) *
    2 pi`` (``se3conv3d_tpu/nn/attention.py:_rotated_kernel_points``,
    reference ``LoRAttConvLayer.py:46-75``)."""
    if kp_res == "double":
        sigma = 0.16
        kp = np.concatenate(
            [icosphere_points(0) * 0.35, icosphere_points(1) * 0.7, np.zeros((1, 3))]
        ).astype(np.float32)
    else:
        sigma = 0.3
        kp = (np.concatenate([icosphere_points(0), np.zeros((1, 3))]) * 0.6).astype(np.float32)
    ang = np.random.RandomState(seed).uniform(size=(3,)) * 2.0 * np.pi
    cx, sx = np.cos(ang[0]), np.sin(ang[0])
    cy, sy = np.cos(ang[1]), np.sin(ang[1])
    cz, sz = np.cos(ang[2]), np.sin(ang[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (kp @ (rx @ ry @ rz)).astype(np.float32), sigma


class _AttBase(nn.Module):
    """``features [B, N, C] -> [B, N, out_features]`` over a same-cloud
    neighborhood.

    Parameters (the flax names): ``proj_axes [P, Q]``, ``proj_biases [Q]``,
    ``pe [1, 1, Q, C]``, ``linear_kqv`` (C -> 3C), ``w_out`` (C -> O) and,
    with ``with_conv_term``, ``conv_weights [Q, C, O]``; calibration
    buffers ``norm_neigh_dist``, ``norm_num_neighs`` and ``initialized``;
    the kernel points a buffer outside the ``state_dict``.  The parameters
    start uninitialised, as every layer's of the port: ``reset_parameters``
    draws this layer's own, ``models.init_parameters`` every submodule's."""

    def __init__(self, in_features: int, out_features: int, num_basis: int = 16,
                 kp_res: str = "single", num_heads: int = 4, kp_seed: int = 0,
                 with_conv_term: bool = False):
        super().__init__()
        if in_features % num_heads:
            raise ValueError(f"in_features={in_features} must split into {num_heads} heads")
        kp, self.sigma = rotated_kernel_points(kp_seed, kp_res)
        self.num_basis, self.num_heads = num_basis, num_heads
        v = in_features
        self.register_buffer("kernel_points", torch.from_numpy(kp), persistent=False)
        self.proj_axes = nn.Parameter(torch.empty(kp.shape[0], num_basis))
        self.proj_biases = nn.Parameter(torch.zeros(num_basis))
        self.pe = nn.Parameter(torch.empty(1, 1, num_basis, v))
        self.linear_kqv = TorchLinear(v, 3 * v)
        self.w_out = TorchLinear(v, out_features)
        self.conv_weights = (nn.Parameter(torch.empty(num_basis, v, out_features))
                             if with_conv_term else None)
        self.register_buffer("norm_neigh_dist", torch.ones(()))
        self.register_buffer("norm_num_neighs", torch.ones(()))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        p, q = self.proj_axes.shape
        v = self.pe.shape[-1]
        nn.init.uniform_(self.proj_axes, -math.sqrt(1.0 / p), math.sqrt(1.0 / p), generator=generator)
        nn.init.zeros_(self.proj_biases)
        nn.init.uniform_(self.pe, -math.sqrt(1.0 / v), math.sqrt(1.0 / v), generator=generator)
        if self.conv_weights is not None:
            s = math.sqrt(1.0 / (v * q))
            nn.init.uniform_(self.conv_weights, -s, s, generator=generator)

    def forward(self, pc_in: PointCloud, pc_out: PointCloud, features: torch.Tensor,
                neigh: Neighborhood, calibrate: bool = False) -> torch.Tensor:
        src = pc_in.source
        if calibrate:
            calibrate_norms(self, src, pc_out, neigh)
        v = features.shape[-1]
        rel = ops.relative_offsets(src, pc_out, neigh, self.norm_neigh_dist)
        pne = ops.kp_pne(rel, self.kernel_points, self.sigma, "gauss", self.proj_axes, self.proj_biases)
        pne = pne * neigh.mask[..., None]  # [B, M, K, Q]

        x = self.linear_kqv(features)
        qv, k = x[..., : 2 * v], x[..., 2 * v:]
        if pc_in.whole is not None:
            qv = points_gather(qv, 1, src.capacity)
        agg_qv = torch.einsum("bmkc,bmkq->bmcq", gather_rows(qv, neigh.idx), pne)
        agg_v = agg_qv[:, :, :v].transpose(-1, -2)  # [B, M, Q, V]
        agg_q = agg_qv[:, :, v:].transpose(-1, -2) + self.pe

        b, m = agg_v.shape[:2]
        h, q = self.num_heads, self.num_basis
        qh = agg_q.reshape(b, m, q, h, v // h)
        kh = k.reshape(b, m, 1, h, v // h)
        att = torch.softmax((qh * kh).sum(-1), dim=2)  # [B, M, Q, H]
        vh = agg_v.reshape(b, m, q, h, v // h)
        out = self.w_out(torch.einsum("bmqhi,bmqh->bmhi", vh, att).reshape(b, m, v))
        if self.conv_weights is not None:
            out = out + torch.einsum("bmqi,qio->bmo", agg_v, self.conv_weights)
        return out * self.norm_num_neighs


class MultiHeadAttConv(_AttBase):
    """The reference's ``MultiHeadAttLayer``: the attention term only."""

    def __init__(self, in_features: int, out_features: int, num_basis: int = 16,
                 kp_res: str = "single", num_heads: int = 4, kp_seed: int = 0):
        super().__init__(in_features, out_features, num_basis, kp_res, num_heads, kp_seed, False)


class LoRAttConv(_AttBase):
    """The reference's ``LoRAttConvLayer``: attention plus a parallel basis
    conv ``sum_{q,i} agg_v[q, i] * conv_weights[q, i, o]``."""

    def __init__(self, in_features: int, out_features: int, num_basis: int = 16,
                 kp_res: str = "single", num_heads: int = 4, kp_seed: int = 0):
        super().__init__(in_features, out_features, num_basis, kp_res, num_heads, kp_seed, True)
