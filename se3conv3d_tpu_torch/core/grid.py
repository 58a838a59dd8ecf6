"""Voxel-grid subsampling with static capacities.

Counterpart of ``se3conv3d_tpu/core/grid.py``: per-point linearised voxel
keys, a stable sort, run-start flags and a cumulative sum give every point
the dense rank of its cell; cells are ordered by ascending key.  The output
cloud is padded to a static ``capacity`` with mask ``arange(cap) < n_cells``;
points of cells past the capacity pool into the last cell (the JAX overflow
clip).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .pointcloud import PointCloud, gather_rows, masked_max, masked_min

__all__ = ["SubsampleMap", "build_grid_subsample"]

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class SubsampleMap:
    """Mapping between a cloud and its grid subsample.

    Attributes:
      cell_id: ``[B, N]`` cell rank of every source point (clipped to
        ``capacity - 1``; padded points carry an arbitrary in-range id).
      src_mask: ``[B, N]`` validity of the source points.
      n_cells: ``[B]`` occupied cells per example.
      out_mask: ``[B, capacity]`` validity of the subsampled points.
      chosen_idx: ``[B, capacity]`` source point picked per cell (rnd mode;
        zeros in avg mode).
      rnd: random-point-per-cell instead of cell average.
    """

    cell_id: torch.Tensor
    src_mask: torch.Tensor
    n_cells: torch.Tensor
    out_mask: torch.Tensor
    chosen_idx: torch.Tensor
    rnd: bool = False

    @property
    def capacity(self) -> int:
        return self.out_mask.shape[-1]

    def subsample(self, values: torch.Tensor, method: str = "avg") -> torch.Tensor:
        """Pool per-point ``[B, N, ...]`` values to ``[B, capacity, ...]``."""
        if self.rnd:
            return gather_rows(values, self.chosen_idx)
        if method == "avg":
            return _segment_mean(values, self.cell_id, self.src_mask, self.capacity)
        if method == "max":
            return _segment_max(values, self.cell_id, self.src_mask, self.capacity)
        raise ValueError(f"unknown subsample method {method!r}")


def _seg_index(seg: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return seg.reshape(seg.shape + (1,) * (values.dim() - 2)).expand_as(values)


def _cell_sums(vm: torch.Tensor, s: torch.Tensor, mask: torch.Tensor, out_shape) -> torch.Tensor:
    """``vm [B, N, ...]`` (zero at padded points) summed into ``out_shape
    [B, cells, ...]`` by cell ``s [B, N]``, in a fixed order.

    On the CPU ``scatter_add_`` adds a cell's points in index order.  On a
    GPU its float atomics add them in an order that changes from call to
    call, and a PCA frame of a flat patch can turn with the last bit of a
    cell average: there the sums come from :func:`_sorted_cell_sums`.
    """
    if vm.is_cuda:
        return _sorted_cell_sums(vm, s, mask, out_shape)
    return vm.new_zeros(out_shape).scatter_add_(1, _seg_index(s, vm), vm)


def _sorted_cell_sums(vm, s, mask, out_shape):
    """:func:`_cell_sums` by ``index_put_`` with ``accumulate``, which sorts
    the indices and adds each cell's points in one thread, so every call
    gives the same bits.  Each padded point (``~mask``) gets a spare cell
    of its own past the real ones, dropped after: a capacity-padded cloud
    would otherwise add all its padding into one cell, serially."""
    b, n = s.shape
    cells = out_shape[1]
    seg = torch.where(mask, s, cells + torch.arange(n, device=s.device))
    rows = torch.arange(b, device=s.device)[:, None].expand_as(s)
    out = vm.new_zeros((b, cells + n) + tuple(out_shape[2:]))
    return out.index_put_((rows, seg), vm, accumulate=True)[:, :cells]


def _segment_mean(values, seg_ids, mask, num_segments):
    mf = mask.to(values.dtype)
    vm = values * mf.reshape(mask.shape + (1,) * (values.dim() - 2))
    s = torch.where(mask, seg_ids, torch.zeros_like(seg_ids))
    out_shape = (values.shape[0], num_segments) + values.shape[2:]
    total = _cell_sums(vm, s, mask, out_shape)
    count = values.new_zeros(values.shape[0], num_segments).scatter_add_(1, s, mf)
    count = count.clamp(min=1.0).reshape(count.shape + (1,) * (values.dim() - 2))
    return total / count


def _segment_max(values, seg_ids, mask, num_segments):
    low = (
        torch.finfo(values.dtype).min
        if values.is_floating_point()
        else torch.iinfo(values.dtype).min
    )
    m = mask.reshape(mask.shape + (1,) * (values.dim() - 2))
    vm = torch.where(m, values, torch.full_like(values, low))
    s = torch.where(mask, seg_ids, torch.full_like(seg_ids, num_segments - 1))
    out_shape = (values.shape[0], num_segments) + values.shape[2:]
    out = values.new_full(out_shape, low)
    return out.scatter_reduce_(1, _seg_index(s, vm), vm, "amax", include_self=True)


def _voxel_keys(positions: torch.Tensor, mask: torch.Tensor, cell_size: float) -> torch.Tensor:
    """Per-example linearised voxel keys ``[B, N]`` (invalid -> INT32_MAX).

    ``floor((p - aabb_min) / cell)`` clamped into the grid, with the +-1e-6
    AABB margin of the reference bounding box.
    """
    mn = masked_min(positions, mask, 1) - 1e-6
    mx = masked_max(positions, mask, 1) + 1e-6
    num_cells = ((mx - mn) / cell_size).to(torch.int64) + 1  # [B, 3]
    cell = torch.floor((positions - mn[:, None]) / cell_size).to(torch.int64)
    cell = torch.minimum(cell.clamp(min=0), num_cells[:, None] - 1)
    key = (cell[..., 0] * num_cells[:, 1:2] + cell[..., 1]) * num_cells[:, 2:3] + cell[..., 2]
    return torch.where(mask, key, torch.full_like(key, _INT32_MAX))


def build_grid_subsample(
    pc: PointCloud,
    cell_size: float,
    rnd: bool = False,
    uniforms: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
) -> SubsampleMap:
    """Grid-subsample mapping for a padded cloud.

    Args:
      pc: input cloud ``[B, N, 3]``.
      cell_size: voxel edge length.
      rnd: pick one random point per cell instead of averaging.
      uniforms: ``[B, capacity]`` uniform draws in ``[0, 1)``, one per
        output cell, required when ``rnd``.
      capacity: static output capacity (default: N).
    """
    b, n = pc.mask.shape
    cap = capacity or n
    dev = pc.positions.device
    keys = _voxel_keys(pc.positions, pc.mask, cell_size)
    order = torch.argsort(keys, dim=1, stable=True)
    sorted_keys = keys.gather(1, order)
    sorted_valid = pc.mask.gather(1, order)
    prev = torch.cat(
        [torch.full((b, 1), -1, dtype=keys.dtype, device=dev), sorted_keys[:, :-1]], 1
    )
    is_first = (sorted_keys != prev) & sorted_valid
    rank_sorted = torch.cumsum(is_first.to(torch.int64), 1) - 1
    n_cells = is_first.sum(1)
    cell_id = torch.zeros_like(rank_sorted).scatter_(1, order, rank_sorted)
    cell_id = cell_id.clamp(0, cap - 1)
    out_mask = torch.arange(cap, device=dev)[None] < n_cells[:, None]

    if rnd:
        if uniforms is None:
            raise ValueError("rnd grid subsample requires uniforms [B, capacity]")
        # per-cell point counts; ranks past the capacity are dropped, as
        # jax.ops.segment_sum drops out-of-range segment ids
        seg = torch.where(sorted_valid, rank_sorted, torch.full_like(rank_sorted, cap - 1))
        keep = (seg < cap) & (seg >= 0)
        counts = torch.zeros(b, cap, dtype=torch.int64, device=dev).scatter_add_(
            1, seg.clamp(0, cap - 1), (sorted_valid & keep).to(torch.int64)
        )
        starts = torch.cumsum(counts, 1) - counts
        pick = starts + torch.floor(uniforms * counts.to(uniforms.dtype)).to(torch.int64)
        chosen = order.gather(1, pick.clamp(0, n - 1))
    else:
        chosen = torch.zeros(b, cap, dtype=torch.int64, device=dev)
    return SubsampleMap(
        cell_id=cell_id,
        src_mask=pc.mask,
        n_cells=n_cells,
        out_mask=out_mask,
        chosen_idx=chosen,
        rnd=rnd,
    )
