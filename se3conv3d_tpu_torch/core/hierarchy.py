"""Point-cloud hierarchy construction.

Counterpart of ``se3conv3d_tpu/core/hierarchy.py``: grid-average the raw
cloud at ``init_cell_size`` (level 0), subsample it again at each of
``cell_sizes``, attach fresh PCA frames to every level, and build the output
cloud as a random-point-per-cell subsample of the raw cloud with its own
frames.  Frames are kNN PCA frames (a random choice of the candidates per
point), global PCA frames (one candidate set per cloud) or uniformly random
rotations, free or about a fixed axis (the reference's ``RefFrames``).

On a points group (``parallel.mesh``) every rank of a points row builds the
whole hierarchy from the raw cloud gathered over the row, with the same
draws, and keeps its row slices (:meth:`Hierarchy.row_slices`).

Randomness is explicit.  :class:`HierarchyDraws` holds every random number
a build consumes (the frame draws per level and for the output cloud, and
the output subsample's per-cell picks); :func:`draw_hierarchy` makes them
from a ``torch.Generator``, and tests hand in the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from .frames import (global_pca_frames, is_fixed_axis, pca_frames, random_frames,
                     shuffle_and_select_frames)
from .grid import SubsampleMap, build_grid_subsample
from .neighborhoods import SUBSAMPLED_SPACING_FACTOR, ball_query_neighborhood, knn_neighborhood
from ..parallel.mesh import local_rows
from .pointcloud import PointCloud

__all__ = [
    "FrameConfig",
    "HierarchyConfig",
    "Hierarchy",
    "HierarchyDraws",
    "draw_hierarchy",
    "draw_frames",
    "attach_frames",
    "build_hierarchy",
    "rotate_cloud",
    "rotate_hierarchy",
]


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Frame sampling (the reference's ``Model.RefFrames``), ``n_frames``
    per point: with ``pca``, PCA frames from a ``neigh_k`` neighborhood (or,
    with ``global_frames``, from each whole cloud), a random choice of the
    candidates; without it, uniformly random rotations.  ``fixed_axis``
    False for free SO(3) frames, 1 or 2 to keep that world axis.
    ``neigh_method`` ``'knn'`` (the ``neigh_k`` nearest points) or
    ``'ball_query'`` (up to ``neigh_k`` points, nearest first, strictly
    within ``bq_radius``)."""

    n_frames: int = 2
    pca: bool = True
    fixed_axis: object = False
    neigh_method: str = "knn"
    neigh_k: int = 16
    bq_radius: float = 0.0
    global_frames: bool = False

    @property
    def n_candidates(self) -> int:
        return 2 if is_fixed_axis(self.fixed_axis) else 4

    def with_n_frames(self, n: int) -> "FrameConfig":
        return dataclasses.replace(self, n_frames=n)


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """Static hierarchy configuration (the ``Model`` keys
    ``init_subsample`` / ``grid_subsamples`` / ``output_subsample`` /
    ``capacities`` / ``out_capacity``)."""

    init_cell_size: float
    cell_sizes: Tuple[float, ...]
    capacities: Tuple[Optional[int], ...]
    out_cell_size: Optional[float] = None
    out_capacity: Optional[int] = None
    frames: Optional[FrameConfig] = None

    @property
    def levels_radii(self) -> Tuple[float, ...]:
        return (self.init_cell_size,) + tuple(self.cell_sizes)

    def resolve_capacities(self, input_capacity: int) -> Tuple[int, ...]:
        caps, prev = [], input_capacity
        for c in self.capacities:
            prev = int(c) if c is not None else prev
            caps.append(prev)
        return tuple(caps)

    def with_capacity(self, capacity: int) -> "HierarchyConfig":
        """Every static level capacity rescaled for an input of ``capacity``
        points (at least 32 each), as the JAX package's ``with_capacity``:
        full-scene inference runs each scene at a capacity bucket."""
        base = self.out_capacity or (self.capacities[0] if self.capacities[0] else capacity)
        ratio = capacity / max(int(base), 1)
        caps = tuple(None if c is None else max(int(-(-int(c) * ratio // 1)), 32)
                     for c in self.capacities)
        return dataclasses.replace(self, capacities=caps,
                                   out_capacity=capacity if self.out_capacity else None)


@dataclasses.dataclass
class Hierarchy:
    """Per-level clouds (level 0 finest) and subsample maps
    (``maps[i]``: level i -> i+1)."""

    levels: Tuple[PointCloud, ...]
    maps: Tuple[SubsampleMap, ...]
    levels_radii: Tuple[float, ...]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def row_slices(self, index: int, size: int) -> "Hierarchy":
        """Points coordinate ``index`` of ``size``'s view of this (whole)
        hierarchy: every level cut to its rows :func:`~se3conv3d_tpu_torch.
        parallel.mesh.local_rows` (each slice keeps its whole level, which
        the neighbour searches and the conv gathers read); the subsample
        maps stay whole."""
        return Hierarchy(tuple(pc.row_slice(*local_rows(pc.capacity, index, size)) for pc in self.levels),
                         self.maps, self.levels_radii)

    def to(self, device) -> "Hierarchy":
        return Hierarchy(
            tuple(pc.to(device) for pc in self.levels),
            tuple(
                dataclasses.replace(
                    m, **{f: getattr(m, f).to(device)
                          for f in ("cell_id", "src_mask", "n_cells", "out_mask", "chosen_idx")}
                )
                for m in self.maps
            ),
            self.levels_radii,
        )


@dataclasses.dataclass
class HierarchyDraws:
    """Random numbers consumed by one :func:`build_hierarchy`.

    Attributes:
      level_frames: per level, the frame draws of a cloud of capacity
        ``cap_l`` (:func:`draw_frames`).
      out_uniforms: ``[B, out_capacity]`` per-cell picks of the output
        subsample (uniforms in ``[0, 1)``).
      out_frames: the frame draws of the output cloud.
    """

    level_frames: List[torch.Tensor]
    out_uniforms: Optional[torch.Tensor]
    out_frames: Optional[torch.Tensor]


def draw_frames(cfg: FrameConfig, batch: int, capacity: int,
                generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """The draws :func:`attach_frames` takes for a cloud ``[B, capacity]``:
    kNN PCA frames, uniform scores ``[B, capacity, S]`` over the S
    candidates (``argsort(scores)[..., :n_frames]`` picks the frames);
    global PCA frames, scores ``[B, S]``; random SO(3) frames, normals
    ``[B, capacity, F, 4]``; random frames about a fixed axis, uniforms
    ``[B, capacity, F]`` (the angle over ``2 pi``)."""
    if cfg.pca:
        shape = (batch, cfg.n_candidates) if cfg.global_frames else (batch, capacity, cfg.n_candidates)
        return torch.rand(*shape, generator=generator, device=device)
    if is_fixed_axis(cfg.fixed_axis):
        return torch.rand(batch, capacity, cfg.n_frames, generator=generator, device=device)
    return torch.randn(batch, capacity, cfg.n_frames, 4, generator=generator, device=device)


def draw_hierarchy(
    config: HierarchyConfig,
    batch: int,
    input_capacity: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> HierarchyDraws:
    """All random draws of one build, from ``generator``."""
    caps = config.resolve_capacities(input_capacity)
    out_cap = config.out_capacity or input_capacity
    cfg = config.frames

    def frames(capacity):
        return draw_frames(cfg, batch, capacity, generator, device) if cfg is not None else None

    return HierarchyDraws(
        level_frames=[frames(c) for c in caps] if cfg is not None else [],
        out_uniforms=torch.rand(batch, out_cap, generator=generator, device=device)
        if config.out_cell_size is not None else None,
        out_frames=frames(out_cap if config.out_cell_size is not None else input_capacity),
    )


def attach_frames(
    pc: PointCloud,
    cfg: FrameConfig,
    draws: torch.Tensor,
    spacing: Optional[float] = None,
) -> PointCloud:
    """Frames of ``cfg`` for every point of ``pc``, from ``draws``
    (:func:`draw_frames`): uniformly random rotations; global PCA frames,
    ``n_frames`` of each cloud's candidates in a random order, shared by
    its points; or PCA frames over a self-kNN or ball-query neighborhood
    (``cfg.neigh_method``), ``n_frames`` of the candidates kept per point
    by ``argsort(draws)``."""
    b, n = pc.mask.shape
    if not cfg.pca:
        fixed = is_fixed_axis(cfg.fixed_axis)
        frames = random_frames(b, n, cfg.n_frames, cfg.fixed_axis,
                               normals=None if fixed else draws.reshape(-1, 4),
                               uniforms=draws.reshape(-1) if fixed else None)
        return pc.with_frames(frames)
    if cfg.global_frames:
        picked = shuffle_and_select_frames(global_pca_frames(pc.positions, pc.mask),
                                           cfg.n_frames, scores=draws)
        return pc.with_frames(picked[:, None].expand(b, n, *picked.shape[1:]).contiguous())
    if cfg.neigh_method == "knn":
        neigh = knn_neighborhood(pc, pc, cfg.neigh_k, grid_cell_size=spacing)
    elif cfg.neigh_method == "ball_query":
        neigh = ball_query_neighborhood(pc, pc, cfg.bq_radius, cfg.neigh_k)
    else:
        raise ValueError(f"unknown frame neigh_method {cfg.neigh_method!r}")
    if cfg.n_frames > cfg.n_candidates:
        raise ValueError(
            f"n_frames={cfg.n_frames} exceeds the {cfg.n_candidates} candidate frames"
        )
    perm = torch.argsort(draws, dim=-1)[..., : cfg.n_frames]
    frames = pca_frames(
        pc.positions, neigh.idx, neigh.mask, fixed_axis=cfg.fixed_axis, select_idx=perm
    )
    return pc.with_frames(frames)


@torch.no_grad()
def build_hierarchy(
    positions: torch.Tensor,
    mask: torch.Tensor,
    features: Optional[torch.Tensor],
    config: HierarchyConfig,
    labels: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[HierarchyDraws] = None,
):
    """Build the hierarchy and output cloud from a raw padded batch.

    Args:
      positions: ``[B, N, 3]``; mask: ``[B, N]``; features: ``[B, N, C]`` or
        None; labels: optional ``[B, N]`` int labels.
      generator / draws: the random numbers, drawn from ``generator`` when
        ``draws`` is not given (:func:`draw_hierarchy`).

    Returns:
      ``(hierarchy, level0_features, out_pc, out_labels, raw_to_out)`` as in
      the JAX package.
    """
    b, n = mask.shape
    if draws is None:
        draws = draw_hierarchy(config, b, n, generator, positions.device)
    raw = PointCloud(positions=positions, mask=mask)
    caps = config.resolve_capacities(n)

    smap0 = build_grid_subsample(raw, config.init_cell_size, capacity=caps[0])
    pc = PointCloud(positions=smap0.subsample(positions, "avg"), mask=smap0.out_mask)
    level0_features = smap0.subsample(features, "avg") if features is not None else None
    if config.frames is not None:
        pc = attach_frames(
            pc, config.frames, draws.level_frames[0],
            spacing=SUBSAMPLED_SPACING_FACTOR * config.init_cell_size,
        )
    levels, maps = [pc], []
    for i, cell in enumerate(config.cell_sizes):
        smap = build_grid_subsample(
            PointCloud(positions=pc.positions, mask=pc.mask), cell, capacity=caps[i + 1]
        )
        nxt = PointCloud(positions=smap.subsample(pc.positions, "avg"), mask=smap.out_mask)
        if config.frames is not None:
            nxt = attach_frames(
                nxt, config.frames, draws.level_frames[i + 1],
                spacing=SUBSAMPLED_SPACING_FACTOR * cell,
            )
        levels.append(nxt)
        maps.append(smap)
        pc = nxt
    hierarchy = Hierarchy(tuple(levels), tuple(maps), config.levels_radii)

    raw_to_out = None
    if config.out_cell_size is not None:
        out_cap = config.out_capacity or n
        raw_to_out = build_grid_subsample(
            raw, config.out_cell_size, rnd=True, uniforms=draws.out_uniforms,
            capacity=out_cap,
        )
        out_pc = PointCloud(
            positions=raw_to_out.subsample(positions, "avg"), mask=raw_to_out.out_mask
        )
        out_labels = raw_to_out.subsample(labels, "max") if labels is not None else None
    else:
        out_pc, out_labels = raw, labels
    if config.frames is not None:
        out_pc = attach_frames(
            out_pc, config.frames, draws.out_frames,
            spacing=None if config.out_cell_size is None
            else SUBSAMPLED_SPACING_FACTOR * config.out_cell_size,
        )
    return hierarchy, level0_features, out_pc, out_labels, raw_to_out


def rotate_cloud(pc: PointCloud, rot: torch.Tensor) -> PointCloud:
    """Rotate a cloud's positions (``p @ R^T``) and frames (``R @ F``) by a
    shared ``[3, 3]`` rotation."""
    frames = None if pc.frames is None else torch.einsum("ij,bnfjk->bnfik", rot, pc.frames)
    return PointCloud(pc.positions @ rot.T, pc.mask, frames)


def rotate_hierarchy(h: Hierarchy, rot: torch.Tensor) -> Hierarchy:
    """Rotate every level; subsample maps are index-based and carry over."""
    return Hierarchy(tuple(rotate_cloud(pc, rot) for pc in h.levels), h.maps, h.levels_radii)
