"""Padded point-cloud containers and masked reductions.

Counterpart of ``se3conv3d_tpu/core/pointcloud.py``: every batch element
occupies one row of a dense ``[B, N, ...]`` tensor padded to a static ``N``
with a boolean validity mask.  Frames are ``[B, N, F, 3, 3]`` with the frame
axes as columns; a world row-vector ``v`` reads ``v @ R`` in the frame.

On a points group (``parallel.mesh``) a rank's cloud is a row slice of the
whole one (:meth:`PointCloud.row_slice`): its rows are the rank's queries
and its ``whole`` cloud the sources they read; :func:`global_pool` over a
slice reduces over the points row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..parallel.mesh import points_extreme, points_sum

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
      whole: for a row slice, the whole cloud it is rows ``[start, start +
        N)`` of (None for a whole cloud).
      start: the slice's first row in ``whole``.
    """

    positions: torch.Tensor
    mask: torch.Tensor
    frames: Optional[torch.Tensor] = None
    whole: Optional["PointCloud"] = None
    start: int = 0

    @property
    def capacity(self) -> int:
        return self.positions.shape[1]

    @property
    def source(self) -> "PointCloud":
        """The whole cloud: ``whole`` for a row slice, else the cloud itself."""
        return self if self.whole is None else self.whole

    def with_frames(self, frames: torch.Tensor) -> "PointCloud":
        return dataclasses.replace(self, frames=frames)

    def row_slice(self, start: int, stop: int) -> "PointCloud":
        """Rows ``[start, stop)`` of this (whole) cloud, which it keeps as
        ``whole``."""
        cut = slice(start, stop)
        return PointCloud(self.positions[:, cut], self.mask[:, cut],
                          None if self.frames is None else self.frames[:, cut], self, start)

    def to(self, device) -> "PointCloud":
        if self.whole is not None:
            return self.whole.to(device).row_slice(self.start, self.start + self.capacity)
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
    JAX package's masked reductions.  For a row slice (``x`` this rank's
    rows of a points group) the pool runs over the whole cloud: each rank's
    sums (and, for ``avg``, counts), maxima or minima are reduced over the
    points row, the max's and min's gradient going to the owning ranks
    (split over the row's tied elements, as over one process's)."""
    if method not in _POOLERS:
        raise ValueError(f"unknown pooling method {method!r}")
    mask = pc.mask
    if x.dim() == 4:
        b, n, f, c = x.shape
        x, mask = x.reshape(b, n * f, c), mask.repeat_interleave(f, dim=1)
    if pc.whole is None:
        return _POOLERS[method](x, mask, 1)
    if method in ("max", "min"):
        local = _POOLERS[method](x, mask, 1)
        ties = (_expand_mask(mask, x) & (x == local[:, None])).sum(1)
        return points_extreme(local, ties, method == "max")
    total = points_sum(masked_sum(x, mask, 1))
    if method == "sum":
        return total
    count = points_sum(_expand_mask(mask, x).sum(1).to(x.dtype))
    return total / count.clamp(min=1)


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
