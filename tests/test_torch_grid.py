"""The port's grid neighbor search against its brute force and the JAX
package's grid search.

``GRID_AUTO_THRESHOLD`` is lowered with ``monkeypatch`` in both packages so
the grid paths run on clouds of a few hundred points (as
``tests/test_grid_neighborhoods.py`` does).  Random uniform coordinates make
distance ties improbable, so:

* grid ball query equals brute force exactly (same neighbor sets, same
  truncation flags) and equals the JAX grid ball query where no JAX cell
  overflows;
* grid kNN equals brute force exactly (the port's grid kNN is exact); the
  JAX grid kNN is near-exact, held to a recall of 0.995 against both, as
  its own ``test_knn_grid_dispatch_considers_query_side`` holds it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t

from se3conv3d_tpu.core import neighborhoods as jneigh
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu_torch.core import neighborhoods
from se3conv3d_tpu_torch.core.pointcloud import PointCloud

torch.set_num_threads(2)

JAX_RECALL = 0.995
# jitted: the JAX grid searches dispatch hundreds of small ops when eager
_jball = jax.jit(jneigh.ball_query_neighborhood, static_argnums=(2, 3),
                 static_argnames=("cell_cap", "want_trunc"))
_jknn = jax.jit(jneigh.knn_neighborhood, static_argnums=(2,), static_argnames=("grid_cell_size",))


def _cloud(seed, b=2, n=400, valid=None, scale=2.0, offset=0.0):
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(size=(b, n, 3)) * scale + offset).astype(np.float32)
    valid = [n] * b if valid is None else valid
    mask = np.arange(n)[None] < np.asarray(valid)[:, None]
    return pts, mask


def _both(pts, mask):
    return PointCloud(t(pts), t(mask)), JCloud(jnp.asarray(pts), jnp.asarray(mask))


def _sets(idx, mask):
    """Per row, the sorted valid neighbor ids (-1 padded)."""
    idx, mask = np.asarray(idx), np.asarray(mask)
    return np.sort(np.where(mask, idx, -1), -1)


def _recall(got, ref):
    hit = total = 0
    for g_row, r_row in zip(got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])):
        r = set(r_row[r_row >= 0].tolist())
        hit += len(r & set(g_row[g_row >= 0].tolist()))
        total += len(r)
    return hit / max(total, 1)


@pytest.fixture
def low_threshold(monkeypatch):
    monkeypatch.setattr(neighborhoods, "GRID_AUTO_THRESHOLD", 256)
    monkeypatch.setattr(jneigh, "GRID_AUTO_THRESHOLD", 256)


def _brute_ball(src, query, radius, k):
    idx, mask, cnt = neighborhoods._chunked_topk_neighbors(
        src.positions, src.mask, query.positions, query.mask, k, radius ** 2, 1024,
        want_count=True)
    return idx, mask, (cnt > k) & query.mask


@pytest.mark.parametrize("radius,k", [(0.35, 64), (0.4, 8)])  # no truncation / truncation
def test_grid_ball_query_matches_brute_force_and_jax(low_threshold, radius, k):
    src, jsrc = _both(*_cloud(0, valid=[400, 333]))
    query, jquery = _both(*_cloud(1, n=300, valid=[300, 260]))
    grid = neighborhoods.ball_query_neighborhood(src, query, radius, k, want_trunc=True)
    b_idx, b_mask, b_trunc = _brute_ball(src, query, radius, k)
    np.testing.assert_array_equal(_sets(grid.idx, grid.mask), _sets(b_idx, b_mask))
    np.testing.assert_array_equal(grid.trunc.numpy(), b_trunc.numpy())
    assert (grid.idx.numpy()[~grid.mask.numpy()] == 0).all()
    assert not grid.mask[1, 260:].any()  # padded queries have no edges
    assert (grid.idx[1][grid.mask[1]] < 333).all()  # padded sources are never picked
    if k == 8:
        assert grid.trunc.any() and not grid.trunc.all()
    # the JAX grid ball query, with cells large enough that none overflows
    jn = _jball(jsrc, jquery, radius, k, cell_cap=128, want_trunc=True)
    np.testing.assert_array_equal(_sets(grid.idx, grid.mask), _sets(jn.idx, jn.mask))
    np.testing.assert_array_equal(grid.trunc.numpy(), np.asarray(jn.trunc))


@pytest.mark.parametrize("method", ["ball_query", "knn"])
def test_query_side_dispatch_takes_the_grid(low_threshold, monkeypatch, method):
    """A small source cloud into a large query cloud (the decoder and
    segmentation-head shapes) takes the grid, as in the JAX package."""
    src, jsrc = _both(*_cloud(2, b=1, n=200))
    query, jquery = _both(*_cloud(3, b=1, n=600))
    calls = []
    name = "grid_ball_query_neighborhood" if method == "ball_query" else "grid_knn_neighborhood"
    real = getattr(neighborhoods, name)
    monkeypatch.setattr(neighborhoods, name, lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    if method == "ball_query":
        grid = neighborhoods.ball_query_neighborhood(src, query, 0.3, 16)
        ref = _brute_ball(src, query, 0.3, 16)[:2]
        jn = _jball(jsrc, jquery, 0.3, 16, cell_cap=128)
    else:
        grid = neighborhoods.knn_neighborhood(src, query, 8, grid_cell_size=0.3)
        ref = neighborhoods._chunked_topk_neighbors(src.positions, src.mask, query.positions,
                                                    query.mask, 8, None, 1024)[:2]
        jn = _jknn(jsrc, jquery, 8, grid_cell_size=0.3)
    assert calls
    np.testing.assert_array_equal(_sets(grid.idx, grid.mask), _sets(*ref))
    assert _recall(_sets(jn.idx, jn.mask), _sets(*ref)) >= JAX_RECALL


@pytest.mark.parametrize("hint", [0.25, 0.05])  # about the spacing / far too fine
def test_grid_knn_is_exact(low_threshold, hint):
    """At a good spacing hint most rows are proven in the first pass; at a
    far too fine one the 3x / 9x passes and the brute-force rows take over.
    Either way the result is exact."""
    src, jsrc = _both(*_cloud(4, n=600, valid=[600, 450]))
    grid = neighborhoods.knn_neighborhood(src, src, 12, grid_cell_size=hint)
    brute = neighborhoods._chunked_topk_neighbors(src.positions, src.mask, src.positions,
                                                  src.mask, 12, None, 1024)
    np.testing.assert_array_equal(_sets(grid.idx, grid.mask), _sets(*brute[:2]))
    assert grid.mask[0].all() and grid.mask[1, :450].all() and not grid.mask[1, 450:].any()
    jn = _jknn(jsrc, jsrc, 12, grid_cell_size=hint)
    assert _recall(_sets(jn.idx, jn.mask), _sets(grid.idx, grid.mask)) >= JAX_RECALL


def test_grid_knn_queries_far_from_every_source(low_threshold):
    """Queries far outside the sources' box, and a source cloud with fewer
    valid points than k: the brute-force rows keep the result exact."""
    src = PointCloud(*(t(x) for x in _cloud(5, b=2, n=300, valid=[300, 5], scale=1.0)))
    query = PointCloud(*(t(x) for x in _cloud(6, b=2, n=260, scale=1.0, offset=20.0)))
    grid = neighborhoods.knn_neighborhood(src, query, 8, grid_cell_size=0.1)
    brute = neighborhoods._chunked_topk_neighbors(src.positions, src.mask, query.positions,
                                                  query.mask, 8, None, 1024)
    np.testing.assert_array_equal(_sets(grid.idx, grid.mask), _sets(*brute[:2]))
    assert int(grid.mask[1].sum(-1).max()) == 5  # only 5 valid sources in example 1


def test_grid_search_with_no_valid_source(low_threshold):
    pts, mask = _cloud(7, b=1, n=300)
    src = PointCloud(t(pts), torch.zeros(1, 300, dtype=torch.bool))
    query = PointCloud(t(pts), t(mask))
    bq = neighborhoods.ball_query_neighborhood(src, query, 0.3, 8, want_trunc=True)
    kn = neighborhoods.knn_neighborhood(src, query, 8, grid_cell_size=0.2)
    for nb in (bq, kn):
        assert not nb.mask.any() and not nb.idx.any()
    assert not bq.trunc.any()


def test_trunc_count_is_exact_where_the_jax_grid_undercounts(low_threshold):
    """Records the JAX package's deviation (ROADMAP Queue 3,
    ``se3conv3d_tpu/core/neighborhoods.py:751``): its grid truncation count
    counts only the candidates its fixed-capacity cells kept, so a dense
    cluster in one overflowing cell under-counts and the certificate says
    "not truncated" where more than k sources lie in the ball.  The port's
    cells have no capacity: its count is exact and agrees with brute force.
    This fails once the JAX side counts exactly."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(size=(1, 300, 3)).astype(np.float32) * 4.0
    pts[0, :30] = 1.0 + rng.uniform(size=(30, 3)).astype(np.float32) * 0.01  # 30 in one cell
    mask = np.ones((1, 300), bool)
    src, jsrc = _both(pts, mask)
    query, jquery = _both(pts[:, :30].copy(), mask[:, :30].copy())
    k = 20
    ours = neighborhoods.ball_query_neighborhood(src, query, 0.05, k, want_trunc=True)
    brute = _brute_ball(src, query, 0.05, k)
    assert ours.trunc.all() and brute[2].all()  # 30 sources in every ball, k = 20
    # 8 kept per JAX cell (4 * cell_cap): the cluster's one or two cells give <= 16 <= k
    jn = _jball(jsrc, jquery, 0.05, k, cell_cap=2, want_trunc=True)
    assert not np.asarray(jn.trunc).any()
