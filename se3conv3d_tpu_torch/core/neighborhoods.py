"""Fixed-degree neighbor search: brute-force kNN and ball query.

Counterpart of the brute-force path of ``se3conv3d_tpu/core/neighborhoods.py``
(``_chunked_topk_neighbors``): per query chunk, the full squared-distance
row and a top-k keep the ``k`` nearest sources; ball query keeps sources
strictly inside the radius and, past ``k`` of them, the nearest ``k``.
Invalid slots are clamped to index 0 and masked.

The JAX package switches to grid-bucketed searches once either cloud reaches
``GRID_AUTO_THRESHOLD`` points.  Those searches are not ported yet, so the
port raises there instead of silently running brute force.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .pointcloud import PointCloud

__all__ = [
    "GRID_AUTO_THRESHOLD",
    "SUBSAMPLED_SPACING_FACTOR",
    "Neighborhood",
    "knn_neighborhood",
    "ball_query_neighborhood",
]

_CHUNK = 1024
GRID_AUTO_THRESHOLD = 8192
SUBSAMPLED_SPACING_FACTOR = 1.3


@dataclasses.dataclass
class Neighborhood:
    """Padded neighbor table from a source cloud to query points.

    Attributes:
      idx: ``[B, M, K]`` int64 source indices, always in bounds.
      mask: ``[B, M, K]`` bool validity.
      query_mask: ``[B, M]`` validity of the query points.
      method: 'knn' | 'ball_query'.
      radius: ball-query radius (0.0 for knn).
      equiv_rel: optional ``[B, M, K, G, 3]`` edge offsets in the receiver
        frames (unscaled), shared by every conv on this neighborhood.
      equiv_rot: optional ``[B, M, K, G, F, 6]`` 6D relative rotations.
      trunc: optional ``[B, M]`` ball-query truncation certificate (True
        where more than K sources lay strictly inside the radius).
    """

    idx: torch.Tensor
    mask: torch.Tensor
    query_mask: torch.Tensor
    method: str = "knn"
    radius: float = 0.0
    equiv_rel: Optional[torch.Tensor] = None
    equiv_rot: Optional[torch.Tensor] = None
    trunc: Optional[torch.Tensor] = None


def _chunked_topk_neighbors(src_pos, src_mask, query_pos, query_mask, k, radius2, chunk,
                            want_count=False):
    """Batched blocked brute force over query chunks.

    Returns ``(idx [B,M,K], valid [B,M,K], count [B,M] or None)`` where
    ``count`` is the number of in-range candidates before the top-k cut.
    """
    idx_parts, d2_parts, cnt_parts = [], [], []
    inf = torch.tensor(float("inf"), dtype=src_pos.dtype, device=src_pos.device)
    s = src_pos[:, None, :, :]  # [B, 1, N, 3]
    for q0 in range(0, query_pos.shape[1], chunk):
        q = query_pos[:, q0 : q0 + chunk, None, :]  # [B, c, 1, 3]
        # per-component sum, no [B, c, N, 3] temporary
        d2 = (q[..., 0] - s[..., 0]) ** 2
        d2 = d2 + (q[..., 1] - s[..., 1]) ** 2
        d2 = d2 + (q[..., 2] - s[..., 2]) ** 2
        d2 = torch.where(src_mask[:, None, :], d2, inf)
        if radius2 is not None:
            d2 = torch.where(d2 < radius2, d2, inf)
        if want_count:
            cnt_parts.append(torch.isfinite(d2).sum(-1))
        dk, ik = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        idx_parts.append(ik)
        d2_parts.append(dk)
    idx = torch.cat(idx_parts, 1)
    d2 = torch.cat(d2_parts, 1)
    valid = torch.isfinite(d2) & query_mask[:, :, None]
    count = torch.cat(cnt_parts, 1) if want_count else None
    return torch.where(valid, idx, torch.zeros_like(idx)), valid, count


def _check_brute_force(src: PointCloud, query: PointCloud) -> None:
    if src.capacity >= GRID_AUTO_THRESHOLD or query.capacity >= GRID_AUTO_THRESHOLD:
        raise NotImplementedError(
            f"clouds of {GRID_AUTO_THRESHOLD}+ points take the grid-bucketed "
            "neighbor search in se3conv3d_tpu, which is not ported yet"
        )


def knn_neighborhood(
    src: PointCloud,
    query: PointCloud,
    k: int,
    chunk: int = _CHUNK,
    grid_cell_size: Optional[float] = None,
) -> Neighborhood:
    """k nearest sources for each query point (self included).

    ``grid_cell_size`` is the spacing hint under which the JAX package
    dispatches large clouds to its grid search; here it only decides
    whether such a cloud raises.
    """
    if grid_cell_size is not None:
        _check_brute_force(src, query)
    idx, mask, _ = _chunked_topk_neighbors(
        src.positions, src.mask, query.positions, query.mask, k, None, chunk
    )
    return Neighborhood(idx=idx, mask=mask, query_mask=query.mask, method="knn")


def ball_query_neighborhood(
    src: PointCloud,
    query: PointCloud,
    radius: float,
    k: int,
    chunk: int = _CHUNK,
    want_trunc: bool = False,
) -> Neighborhood:
    """Up to ``k`` sources strictly within ``radius``, nearest first."""
    _check_brute_force(src, query)
    idx, mask, cnt = _chunked_topk_neighbors(
        src.positions, src.mask, query.positions, query.mask, k,
        float(radius) ** 2, chunk, want_count=want_trunc,
    )
    return Neighborhood(
        idx=idx,
        mask=mask,
        query_mask=query.mask,
        method="ball_query",
        radius=float(radius),
        trunc=(cnt > k) & query.mask if want_trunc else None,
    )
