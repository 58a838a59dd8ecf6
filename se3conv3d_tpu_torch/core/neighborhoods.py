"""Fixed-degree neighbor search: kNN and ball query, brute force and grid.

Counterpart of ``se3conv3d_tpu/core/neighborhoods.py``.  Small clouds take
the brute-force path (``_chunked_topk_neighbors``): per query chunk, the
full squared-distance row and a top-k keep the ``k`` nearest sources; ball
query keeps sources strictly inside the radius and, past ``k`` of them, the
nearest ``k``.  Invalid slots are clamped to index 0 and masked.

Once either cloud reaches ``GRID_AUTO_THRESHOLD`` points the searches go to
the grid, as in the JAX package.  The port keeps the JAX package's
semantics, not its TPU hash table (a fixed-capacity ``[H, cell_cap]`` table
with f32-coded ids): the sources are sorted by linear cell key, each
query's 3x3x3 window of cells becomes 27 ``searchsorted`` ranges of that
order, the ranges are gathered as one ragged candidate row per query
(padded to the chunk's longest row, with the chunk sized so that the
candidate buffer stays under ``_GRID_SLOTS`` entries) and a top-k keeps the
nearest.  No cell has a capacity, so nothing is dropped:

* grid ball query (cells of one radius) is exact -- the same neighbor sets
  as brute force away from distance ties -- and its truncation count is
  the exact number of sources inside the ball;
* grid kNN is exact as well: a first pass at ``grid_knn_cell_size`` keeps
  the rows whose k-th distance lies inside the window's guaranteed
  coverage, passes at 3x and 9x the cell redo the rest, and any row still
  unproven (a query far from every source) runs brute force.

The JAX package's grid kNN is near-exact instead (its cells have
capacities), and its grid truncation count can under-count when a cell
overflows (``se3conv3d_tpu/core/neighborhoods.py:751``);
``tests/test_torch_grid.py`` records both differences.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .pointcloud import PointCloud

__all__ = [
    "GRID_AUTO_THRESHOLD",
    "SUBSAMPLED_SPACING_FACTOR",
    "KNN_CELL_FACTOR",
    "Neighborhood",
    "grid_knn_cell_size",
    "knn_neighborhood",
    "ball_query_neighborhood",
    "grid_knn_neighborhood",
    "grid_ball_query_neighborhood",
]

_CHUNK = 1024
GRID_AUTO_THRESHOLD = 8192
SUBSAMPLED_SPACING_FACTOR = 1.3
# kNN cell = KNN_CELL_FACTOR x spacing (scaled by k^(1/3) past k=16): the
# 3^3 window then covers past the ~2.26 x spacing k-th-neighbor radius of
# surface-sampled data, so most rows are proven after the first pass
KNN_CELL_FACTOR = 2.45
# candidate slots (queries x longest candidate row) per grid chunk
_GRID_SLOTS = 1 << 23
# queries per block whose longest candidate row sizes its chunks
_GRID_BLOCK = 4096
# ball-query cells are a hair wider than the radius, so that rounding in
# floor((p - origin) / cell) cannot put an in-ball source outside the window
_BQ_CELL_MARGIN = 1.0 + 1e-4
_OFFSETS = torch.stack(torch.meshgrid(*([torch.arange(-1, 2)] * 3), indexing="ij"), -1).reshape(-1, 3)


def grid_knn_cell_size(spacing: float, k: int) -> float:
    """Cell size of the grid kNN's first pass for a spacing hint."""
    return KNN_CELL_FACTOR * float(spacing) * (max(k, 16) / 16.0) ** (1.0 / 3.0)


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
      bwd_perm / bwd_slot / bwd_run_start / bwd_run_end: optional sorted-edge
        tables of the 'sorted' backward reduction
        (``ops.pne_conv.backward_sort_tables``): ``[B, M*K]`` permutation
        sorting the edges by source and its inverse, ``[B, N]`` run bounds.
      live_rows: optional ``[L]`` int32 table of the query rows ``b*M + m``
        with at least one valid edge, ascending
        (``kernels.fused_equiv.live_row_table``): the rows the conv
        kernels work on.
      std_rel: optional ``[B, M, K, 1, 3]`` raw edge offsets, the standard
        and kernel-point convs' geometry (``ops.pne_conv.std_geometry``),
        shared by every standard conv on this neighborhood.
      plain_rel / plain_rot: optional float32 ``[B, M, K, G, 3]`` offsets in
        the receiver frames and ``[B, M, K, G, F, R]`` relative rotations
        (R = 6, 4 or 9): the geometry of the equivariant convs on the plain
        path (``ops.pne_conv.equiv_geometry``), beside ``equiv_rel`` /
        ``equiv_rot``, the kernel path's.
    """

    idx: torch.Tensor
    mask: torch.Tensor
    query_mask: torch.Tensor
    method: str = "knn"
    radius: float = 0.0
    equiv_rel: Optional[torch.Tensor] = None
    equiv_rot: Optional[torch.Tensor] = None
    trunc: Optional[torch.Tensor] = None
    bwd_perm: Optional[torch.Tensor] = None
    bwd_slot: Optional[torch.Tensor] = None
    bwd_run_start: Optional[torch.Tensor] = None
    bwd_run_end: Optional[torch.Tensor] = None
    live_rows: Optional[torch.Tensor] = None
    std_rel: Optional[torch.Tensor] = None
    plain_rel: Optional[torch.Tensor] = None
    plain_rot: Optional[torch.Tensor] = None


def _chunked_topk_neighbors(src_pos, src_mask, query_pos, query_mask, k, radius2, chunk,
                            want_count=False):
    """Batched blocked brute force over query chunks.

    Returns ``(idx [B,M,K], valid [B,M,K], count [B,M] or None)`` where
    ``count`` is the number of in-range candidates before the top-k cut.
    """
    idx_parts, d2_parts, cnt_parts = [], [], []
    inf = torch.tensor(float("inf"), dtype=src_pos.dtype, device=src_pos.device)
    s = src_pos[:, None, :, :]  # [B, 1, N, 3]
    for q0 in range(0, max(query_pos.shape[1], 1), chunk):  # an empty query gives empty tables
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
        dk, ik = torch.topk(d2, min(k, d2.shape[-1]), dim=-1, largest=False, sorted=True)
        if ik.shape[-1] < k:  # fewer sources than k
            pad = k - ik.shape[-1]
            ik = torch.cat([ik, ik.new_zeros(ik.shape[:-1] + (pad,))], -1)
            dk = torch.cat([dk, dk.new_full(dk.shape[:-1] + (pad,), float("inf"))], -1)
        idx_parts.append(ik)
        d2_parts.append(dk)
    idx = torch.cat(idx_parts, 1)
    d2 = torch.cat(d2_parts, 1)
    valid = torch.isfinite(d2) & query_mask[:, :, None]
    count = torch.cat(cnt_parts, 1) if want_count else None
    return torch.where(valid, idx, torch.zeros_like(idx)), valid, count


# --- grid search -------------------------------------------------------------


class _CellTable:
    """Valid sources of one example sorted by linear cell key at ``cell``."""

    def __init__(self, pos: torch.Tensor, mask: torch.Tensor, cell: float):
        big = torch.finfo(pos.dtype).max
        self.cell = cell
        self.origin = torch.where(mask[:, None], pos, big).amin(0) - 1e-6
        top = torch.where(mask[:, None], pos, -big).amax(0) + 1e-6
        self.dims = (((top - self.origin) / cell).long() + 1).clamp(min=1)
        key = self.key(self.coords(pos))
        key = torch.where(mask, key, torch.iinfo(torch.int64).max)  # masked sources sort last
        self.keys, self.order = torch.sort(key, stable=True)
        self.pos = pos[self.order]

    def coords(self, p: torch.Tensor) -> torch.Tensor:
        return torch.floor((p - self.origin) / self.cell).long()

    def key(self, c: torch.Tensor) -> torch.Tensor:
        return (c[..., 0] * self.dims[1] + c[..., 1]) * self.dims[2] + c[..., 2]

    def windows(self, q: torch.Tensor, qmask: torch.Tensor):
        """``(start, end [M, 27], qc [M, 3])``: each query's 3^3 window of
        cells as ranges of the sorted order (empty outside the grid and for
        invalid queries), and the query's own cell."""
        qc = self.coords(q)
        cells = qc[:, None, :] + _OFFSETS.to(q.device)[None]
        inside = ((cells >= 0) & (cells < self.dims)).all(-1) & qmask[:, None]
        key = self.key(cells.clamp(min=0))
        start = torch.searchsorted(self.keys, key, side="left")
        end = torch.searchsorted(self.keys, key, side="right")
        return start, torch.where(inside, end, start), qc

    def coverage(self, q: torch.Tensor, qc: torch.Tensor) -> torch.Tensor:
        """``[M]`` distance from each query to the nearest face of its 3^3
        window beyond which sources can lie (+inf when the window spans the
        whole grid): every source outside the window is at least this far."""
        inf = torch.tensor(float("inf"), dtype=q.dtype, device=q.device)
        lo = torch.where(qc - 1 <= 0, inf, q - (self.origin + (qc - 1) * self.cell))
        hi = torch.where(qc + 1 >= self.dims - 1, inf, self.origin + (qc + 2) * self.cell - q)
        return torch.minimum(lo, hi).amin(-1)


def _grid_topk(table: _CellTable, q, qmask, k, radius2, want_count=False):
    """Exact top-k over each query's window candidates.

    Returns ``(idx [M,K], d2 [M,K] (+inf on empty slots), count [M] or
    None, coverage [M])``; ``count`` is the number of candidates in range.
    """
    m, dev = q.shape[0], q.device
    start, end, qc = table.windows(q, qmask)
    lens = end - start
    total = lens.sum(1)
    idx = torch.zeros((m, k), dtype=torch.int64, device=dev)
    d2k = torch.full((m, k), float("inf"), dtype=q.dtype, device=dev)
    count = torch.zeros(m, dtype=torch.int64, device=dev) if want_count else None
    nblk = -(-m // _GRID_BLOCK)
    padded = torch.nn.functional.pad(total, (0, nblk * _GRID_BLOCK - m))
    block_max = padded.reshape(nblk, _GRID_BLOCK).amax(1).tolist()
    for bi, cmax in enumerate(block_max):
        b0, b1 = bi * _GRID_BLOCK, min((bi + 1) * _GRID_BLOCK, m)
        if cmax == 0:
            continue
        step = max(1, _GRID_SLOTS // cmax)
        for q0 in range(b0, b1, step):
            sl = slice(q0, min(q0 + step, b1))
            ends = torch.cumsum(lens[sl], 1)                       # [c, 27] inclusive
            j = torch.arange(cmax, device=dev).expand(ends.shape[0], cmax)
            w = torch.searchsorted(ends, j.contiguous(), side="right").clamp(max=26)
            pos = start[sl].gather(1, w) + j - (ends - lens[sl]).gather(1, w)
            ok = j < total[sl, None]
            pos = torch.where(ok, pos, torch.zeros_like(pos))
            cand = table.pos[pos]                                   # [c, cmax, 3]
            qp = q[sl, None, :]
            # the brute force's sum order, so both agree bitwise on each distance
            d2 = (qp[..., 0] - cand[..., 0]) ** 2
            d2 = d2 + (qp[..., 1] - cand[..., 1]) ** 2
            d2 = d2 + (qp[..., 2] - cand[..., 2]) ** 2
            d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
            if radius2 is not None:
                d2 = torch.where(d2 < radius2, d2, torch.full_like(d2, float("inf")))
            if want_count:
                count[sl] = torch.isfinite(d2).sum(1)
            kk = min(k, cmax)
            dk, ik = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
            idx[sl, :kk] = table.order[pos.gather(1, ik)]
            d2k[sl, :kk] = dk
    return idx, d2k, count, table.coverage(q, qc)


def _finish(idx, d2, query_mask):
    valid = torch.isfinite(d2) & query_mask[:, :, None]
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def grid_ball_query_neighborhood(src: PointCloud, query: PointCloud, radius: float, k: int,
                                 want_trunc: bool = False) -> Neighborhood:
    """Ball query over a grid of radius-sized cells (exact; see the module
    docstring)."""
    r2 = float(radius) ** 2
    rows = []
    for b in range(src.positions.shape[0]):
        if not bool(src.mask[b].any()):
            m = query.positions.shape[1]
            dev = query.positions.device
            rows.append((torch.zeros(m, k, dtype=torch.int64, device=dev),
                         torch.full((m, k), float("inf"), device=dev),
                         torch.zeros(m, dtype=torch.int64, device=dev)))
            continue
        table = _CellTable(src.positions[b], src.mask[b], float(radius) * _BQ_CELL_MARGIN)
        idx, d2, cnt, _ = _grid_topk(table, query.positions[b], query.mask[b], k, r2,
                                     want_count=want_trunc)
        rows.append((idx, d2, cnt))
    idx, mask = _finish(torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows]),
                        query.mask)
    trunc = None
    if want_trunc:
        trunc = (torch.stack([r[2] for r in rows]) > k) & query.mask
    return Neighborhood(idx=idx, mask=mask, query_mask=query.mask, method="ball_query",
                        radius=float(radius), trunc=trunc)


def grid_knn_neighborhood(src: PointCloud, query: PointCloud, k: int,
                          cell_size: float) -> Neighborhood:
    """Exact kNN over grids of ``cell_size``, 3x and 9x that, then brute
    force for any row no window could prove (see the module docstring)."""
    idx_rows, valid_rows = [], []
    for b in range(src.positions.shape[0]):
        sp, sm = src.positions[b], src.mask[b]
        qp, qm = query.positions[b], query.mask[b]
        m = qp.shape[0]
        idx = torch.zeros((m, k), dtype=torch.int64, device=qp.device)
        valid = torch.zeros((m, k), dtype=torch.bool, device=qp.device)
        todo = torch.nonzero(qm).squeeze(1)
        if bool(sm.any()):
            for scale in (1.0, 3.0, 9.0):
                if todo.numel() == 0:
                    break
                table = _CellTable(sp, sm, scale * float(cell_size))
                i_t, d_t, _, cov = _grid_topk(table, qp[todo], qm[todo], k, None)
                idx[todo], valid[todo] = i_t, torch.isfinite(d_t)
                proven = torch.isinf(cov) | (d_t[:, -1] <= cov * cov)
                todo = todo[~proven]
        if todo.numel():
            i_t, v_t, _ = _chunked_topk_neighbors(
                sp[None], sm[None], qp[todo][None], qm[todo][None], k, None, _CHUNK)
            idx[todo], valid[todo] = i_t[0], v_t[0]
        idx_rows.append(idx)
        valid_rows.append(valid)
    mask = torch.stack(valid_rows) & query.mask[:, :, None]
    idx = torch.where(mask, torch.stack(idx_rows), 0)
    return Neighborhood(idx=idx, mask=mask, query_mask=query.mask, method="knn")


# --- public entry points ----------------------------------------------------


def _use_grid(src: PointCloud, query: PointCloud) -> bool:
    """Grid or brute force, by the whole clouds' capacities (a points
    group's row slice searches as its whole cloud does)."""
    return src.source.capacity >= GRID_AUTO_THRESHOLD or query.source.capacity >= GRID_AUTO_THRESHOLD


def knn_neighborhood(
    src: PointCloud,
    query: PointCloud,
    k: int,
    chunk: int = _CHUNK,
    grid_cell_size: Optional[float] = None,
) -> Neighborhood:
    """k nearest sources for each query point (self included).

    ``grid_cell_size`` is the spacing hint (for grid-subsampled clouds, the
    cell size times ``SUBSAMPLED_SPACING_FACTOR``); with it, and either
    cloud at ``GRID_AUTO_THRESHOLD`` points or more, the grid search runs.
    Without it the search is brute force at any size, as in the JAX package.
    """
    if grid_cell_size is not None and _use_grid(src, query):
        return grid_knn_neighborhood(src, query, k, grid_knn_cell_size(grid_cell_size, k))
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
    """Up to ``k`` sources strictly within ``radius``, nearest first; the
    grid search runs once either cloud has ``GRID_AUTO_THRESHOLD`` points."""
    if _use_grid(src, query):
        return grid_ball_query_neighborhood(src, query, radius, k, want_trunc=want_trunc)
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
