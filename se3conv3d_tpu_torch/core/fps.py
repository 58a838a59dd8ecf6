"""Farthest-point subsampling (counterpart of ``se3conv3d_tpu/core/fps.py``).

Greedy FPS with a running min-distance table, ``n_samples - 1`` rounds of
PyTorch ops over the whole batch (the JAX package runs a ``lax.fori_loop``
in XLA; no kernel of its own), static output size.  Ties break as JAX's
``argmax`` / ``argmin`` do, at the first index: once ``n_samples`` exceeds an
example's valid points, every valid point's distance is 0 and every masked
point's ``-inf``, so the first valid point is picked again and again, and
``nearest`` meets duplicate selected points.  The squared distances are
summed ``dx*dx + dy*dy + dz*dz`` in that order, one rounding a step, so the
card and the CPU pick the same points.  Upsampling gathers from the nearest
selected point (the reference's ``__upsample_tensor__`` is a TODO).
"""
from __future__ import annotations

import dataclasses

import torch

from .pointcloud import PointCloud

__all__ = ["FPSMap", "fps_subsample", "fps_subsample_cloud"]


@dataclasses.dataclass
class FPSMap:
    """A cloud's FPS subset.

    Attributes:
      ids: ``[B, S]`` selected source indices.
      out_mask: ``[B, S]`` validity (S may exceed the valid point count).
      nearest: ``[B, N]`` index (into the S axis) of the closest selected
        point of every source point: the upsample map.
      src_mask: ``[B, N]``.
    """

    ids: torch.Tensor
    out_mask: torch.Tensor
    nearest: torch.Tensor
    src_mask: torch.Tensor

    def subsample(self, values: torch.Tensor) -> torch.Tensor:
        """Per-point ``values [B, N, ...]`` at the selected ids -> ``[B, S, ...]``."""
        return _take(values, self.ids)

    def upsample(self, values: torch.Tensor) -> torch.Tensor:
        """``[B, S, ...]`` values back to every source point through its
        nearest selected point -> ``[B, N, ...]``."""
        return _take(values, self.nearest)


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return values[torch.arange(values.shape[0], device=values.device)[:, None], idx]


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a - b|^2`` over the last axis (3), summed x, y, z in order."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def fps_subsample(pc: PointCloud, n_samples: int, start_idx: int = 0) -> FPSMap:
    """Greedy farthest-point selection of ``n_samples`` points per example,
    starting at ``start_idx``."""
    pos, mask = pc.positions, pc.mask
    b, n = mask.shape
    rows = torch.arange(b, device=pos.device)
    ids = torch.zeros(b, n_samples, dtype=torch.long, device=pos.device)
    ids[:, 0] = start_idx
    mind = torch.full((b, n), float("inf"), dtype=pos.dtype, device=pos.device)
    neg_inf = torch.full_like(mind, float("-inf"))
    for i in range(1, n_samples):
        cur = pos[rows, ids[:, i - 1]]  # [B, 3]
        mind = torch.minimum(mind, _sq_dist(pos, cur[:, None, :]))
        ids[:, i] = torch.where(mask, mind, neg_inf).argmax(1)

    n_valid = mask.sum(1, keepdim=True)
    out_mask = torch.arange(n_samples, device=pos.device)[None] < n_valid.clamp(max=n_samples)
    sel = _take(pos, ids)  # [B, S, 3]
    d2 = _sq_dist(pos[:, :, None, :], sel[:, None, :, :])  # [B, N, S]
    d2 = torch.where(out_mask[:, None, :], d2, torch.full_like(d2, float("inf")))
    return FPSMap(ids=ids, out_mask=out_mask, nearest=d2.argmin(2), src_mask=mask)


def fps_subsample_cloud(pc: PointCloud, n_samples: int) -> tuple:
    """FPS-subsample a cloud; returns ``(sub_cloud, map)``."""
    fmap = fps_subsample(pc, n_samples)
    return PointCloud(positions=fmap.subsample(pc.positions), mask=fmap.out_mask), fmap
