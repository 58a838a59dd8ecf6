"""Point-cloud hierarchy construction.

Counterpart of ``se3conv3d_tpu/core/hierarchy.py``: grid-average the raw
cloud at ``init_cell_size`` (level 0), subsample it again at each of
``cell_sizes``, attach fresh PCA frames to every level, and build the output
cloud as a random-point-per-cell subsample of the raw cloud with its own
frames.

Randomness is explicit.  :class:`HierarchyDraws` holds every uniform number a
build consumes (the frame choice per level and for the output cloud, and
the output subsample's per-cell picks); :func:`draw_hierarchy` makes them
from a ``torch.Generator``, and tests hand in the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from .frames import is_fixed_axis, pca_frames
from .grid import SubsampleMap, build_grid_subsample
from .neighborhoods import SUBSAMPLED_SPACING_FACTOR, knn_neighborhood
from .pointcloud import PointCloud

__all__ = [
    "FrameConfig",
    "HierarchyConfig",
    "Hierarchy",
    "HierarchyDraws",
    "draw_hierarchy",
    "attach_frames",
    "build_hierarchy",
    "rotate_cloud",
    "rotate_hierarchy",
]


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Frame sampling (the reference's ``Model.RefFrames``): PCA frames
    from a ``neigh_k`` neighborhood, ``n_frames`` kept per point."""

    n_frames: int = 2
    pca: bool = True
    fixed_axis: object = False
    neigh_method: str = "knn"
    neigh_k: int = 16

    @property
    def n_candidates(self) -> int:
        return 2 if is_fixed_axis(self.fixed_axis) else 4


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
    """Uniform draws in ``[0, 1)`` consumed by one :func:`build_hierarchy`.

    Attributes:
      level_scores: per level, ``[B, cap_l, S]`` frame-choice scores
        (``argsort(scores)[..., :n_frames]`` picks the frames).
      out_uniforms: ``[B, out_capacity]`` per-cell picks of the output
        subsample.
      out_scores: ``[B, out_capacity, S]`` frame-choice scores of the
        output cloud.
    """

    level_scores: List[torch.Tensor]
    out_uniforms: Optional[torch.Tensor]
    out_scores: Optional[torch.Tensor]


def draw_hierarchy(
    config: HierarchyConfig,
    batch: int,
    input_capacity: int,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> HierarchyDraws:
    """All uniform draws of one build, from ``generator``."""
    caps = config.resolve_capacities(input_capacity)
    out_cap = config.out_capacity or input_capacity
    s = config.frames.n_candidates if config.frames is not None else 0

    def u(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    return HierarchyDraws(
        level_scores=[u(batch, c, s) for c in caps] if s else [],
        out_uniforms=u(batch, out_cap) if config.out_cell_size is not None else None,
        out_scores=u(batch, out_cap if config.out_cell_size is not None else input_capacity, s)
        if s else None,
    )


def attach_frames(
    pc: PointCloud,
    cfg: FrameConfig,
    scores: torch.Tensor,
    spacing: Optional[float] = None,
) -> PointCloud:
    """PCA frames over a self-kNN neighborhood, ``n_frames`` of the
    candidates kept per point by ``argsort(scores)``.

    Only the kNN PCA path of the JAX package is ported (every shipped
    DFaust recipe uses it).
    """
    if not cfg.pca or cfg.neigh_method != "knn":
        raise NotImplementedError("only kNN PCA frames are ported yet")
    if cfg.n_frames > cfg.n_candidates:
        raise ValueError(
            f"n_frames={cfg.n_frames} exceeds the {cfg.n_candidates} candidate frames"
        )
    neigh = knn_neighborhood(pc, pc, cfg.neigh_k, grid_cell_size=spacing)
    perm = torch.argsort(scores, dim=-1)[..., : cfg.n_frames]
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
        ``draws`` is not given.

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
            pc, config.frames, draws.level_scores[0],
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
                nxt, config.frames, draws.level_scores[i + 1],
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
            out_pc, config.frames, draws.out_scores,
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
