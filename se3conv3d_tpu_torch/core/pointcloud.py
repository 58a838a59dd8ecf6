"""Padded point-cloud containers and masked reductions.

Counterpart of ``se3conv3d_tpu/core/pointcloud.py``: every batch element
occupies one row of a dense ``[B, N, ...]`` tensor padded to a static ``N``
with a boolean validity mask.  Frames are ``[B, N, F, 3, 3]`` with the frame
axes as columns; a world row-vector ``v`` reads ``v @ R`` in the frame.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "PointCloud",
    "masked_sum",
    "masked_mean",
    "masked_max",
    "masked_min",
    "global_pool",
    "frame_pool",
    "gather_rows",
]


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-example gather: ``values [B, N, ...]`` at ``idx [B, ...]`` ->
    ``[B, ..., <values' trailing dims>]``."""
    b = torch.arange(values.shape[0], device=values.device)
    return values[b.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def _expand_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def masked_sum(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of ``x`` over ``dim`` counting only entries where ``mask``."""
    return torch.where(_expand_mask(mask, x), x, torch.zeros_like(x)).sum(dim)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only entries where ``mask``."""
    m = _expand_mask(mask, x)
    total = torch.where(m, x, torch.zeros_like(x)).sum(dim)
    count = m.sum(dim).clamp(min=1).to(x.dtype)
    return total / count


def _fill(x: torch.Tensor, low: bool) -> float:
    info = torch.finfo(x.dtype) if x.is_floating_point() else torch.iinfo(x.dtype)
    return info.min if low else info.max


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Max of ``x`` over ``dim`` counting only entries where ``mask``."""
    filled = torch.where(_expand_mask(mask, x), x, torch.full_like(x, _fill(x, True)))
    return filled.amax(dim)


def masked_min(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Min of ``x`` over ``dim`` counting only entries where ``mask``."""
    filled = torch.where(_expand_mask(mask, x), x, torch.full_like(x, _fill(x, False)))
    return filled.amin(dim)


_POOLERS = {
    "sum": masked_sum,
    "avg": masked_mean,
    "max": masked_max,
    "min": masked_min,
}


@dataclasses.dataclass
class PointCloud:
    """A batch of (optionally framed) padded point clouds.

    Attributes:
      positions: ``[B, N, 3]`` float coordinates; padded rows arbitrary.
      mask: ``[B, N]`` bool, True for real points.
      frames: optional ``[B, N, F, 3, 3]`` local reference frames.
    """

    positions: torch.Tensor
    mask: torch.Tensor
    frames: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.positions.shape[1]

    def with_frames(self, frames: torch.Tensor) -> "PointCloud":
        return dataclasses.replace(self, frames=frames)

    def to(self, device) -> "PointCloud":
        return PointCloud(
            self.positions.to(device),
            self.mask.to(device),
            None if self.frames is None else self.frames.to(device),
        )


def global_pool(pc: PointCloud, x: torch.Tensor, method: str = "avg") -> torch.Tensor:
    """Pool per-point features to one vector per batch element: ``x [B, N,
    C]`` over N, ``[B, N, F, C]`` over N and F jointly, padded points left
    out by ``pc.mask``.  An all-masked cloud gives 0 (``sum``, ``avg``) or
    the dtype's most negative (``max``) or largest (``min``) value, as the
    JAX package's masked reductions."""
    if method not in _POOLERS:
        raise ValueError(f"unknown pooling method {method!r}")
    pool = _POOLERS[method]
    if x.dim() == 4:
        b, n, f, c = x.shape
        return pool(x.reshape(b, n * f, c), pc.mask.repeat_interleave(f, dim=1), 1)
    return pool(x, pc.mask, 1)


def frame_pool(x: torch.Tensor, method: str = "avg") -> torch.Tensor:
    """Pool the frame axis of ``[B, N, F, C]`` features -> ``[B, N, C]``."""
    if method == "avg":
        return x.mean(2)
    if method == "sum":
        return x.sum(2)
    if method == "max":
        return x.amax(2)
    if method == "min":
        return x.amin(2)
    raise ValueError(f"unknown pooling method {method!r}")
