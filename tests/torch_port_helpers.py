"""Shared helpers of the port's parity tests: the JAX package's random draws
and hierarchies carried over to the PyTorch port as tensors."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from se3conv3d_tpu_torch.core.grid import SubsampleMap
from se3conv3d_tpu_torch.core.hierarchy import Hierarchy, HierarchyDraws
from se3conv3d_tpu_torch.core.pointcloud import PointCloud


def t(x):
    """numpy / jax array -> torch tensor (a copy; int32 indices widen to int64)."""
    if x is None:
        return None
    a = np.array(x)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def to_torch_cloud(pc) -> PointCloud:
    return PointCloud(t(pc.positions), t(pc.mask), t(pc.frames))


def to_torch_map(m) -> SubsampleMap:
    return SubsampleMap(t(m.cell_id), t(m.src_mask), t(m.n_cells), t(m.out_mask),
                        t(m.chosen_idx), m.rnd)


def to_torch_hierarchy(h) -> Hierarchy:
    return Hierarchy(
        tuple(to_torch_cloud(p) for p in h.levels),
        tuple(to_torch_map(m) for m in h.maps),
        h.levels_radii,
    )


def jax_hierarchy_draws(key, cfg, batch: int, n: int) -> HierarchyDraws:
    """The uniforms ``se3conv3d_tpu.core.hierarchy.build_hierarchy(key, ...)``
    draws, in the port's injected form."""
    num = cfg.num_levels
    keys = jax.random.split(key, 2 * num + 2)
    caps = cfg.resolve_capacities(n)
    s = 2 if cfg.frames.fixed_axis else 4
    out_cap = cfg.out_capacity or n
    rngs = jax.random.split(keys[num], batch)
    return HierarchyDraws(
        level_scores=[t(jax.random.uniform(keys[i], (batch, caps[i], s))) for i in range(num)],
        out_uniforms=t(jnp.stack([jax.random.uniform(r, (out_cap,)) for r in rngs])),
        out_scores=t(jax.random.uniform(keys[num + 1], (batch, out_cap, s))),
    )
