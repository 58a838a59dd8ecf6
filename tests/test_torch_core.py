"""Geometry core of the PyTorch port against the JAX package.

Same numpy inputs through both packages; random draws are the JAX package's
own, injected into the port.  Tolerances: point sets and neighbor sets are
compared exactly (positions to 1e-6, float32 sums in another order); frames
to 1e-4 away from near-degenerate covariances, where the closed-form
eigensolver's float32 rounding in ``arccos``/``cos`` differs by ulps between
the two libraries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_hierarchy_draws, t, to_torch_cloud

from se3conv3d_tpu.core import frames as jframes
from se3conv3d_tpu.core import grid as jgrid
from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.core import neighborhoods as jneigh
from se3conv3d_tpu.core import pointcloud as jpointcloud
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.core.rotation import matrix_to_rotation_6d as jm6d
from se3conv3d_tpu.core.rotation import relative_rotations as jrelrot
from se3conv3d_tpu_torch.core import frames, grid, hierarchy, neighborhoods
from se3conv3d_tpu_torch.core import pointcloud as tpointcloud
from se3conv3d_tpu_torch.core.pointcloud import PointCloud
from se3conv3d_tpu_torch.core.rotation import (
    matrix_to_rotation_6d,
    random_rotations,
    relative_rotations,
)

torch.set_num_threads(2)


def _cloud(seed, b=2, n=200, tail=(0, 37)):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(b, n, 3)).astype(np.float32)
    pts[..., 1] *= 2.0
    mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
    return pts, mask


def _sorted_rows(x):
    return x[np.lexsort(x.T[::-1])]


@pytest.mark.parametrize("cell", [0.08, 0.2])
def test_grid_avg_point_sets(cell):
    pts, mask = _cloud(0)
    jm = jgrid.build_grid_subsample(JCloud(jnp.asarray(pts), jnp.asarray(mask)), cell, capacity=160)
    jpos = np.asarray(jm.subsample(jnp.asarray(pts), "avg"))
    tm = grid.build_grid_subsample(PointCloud(t(pts), t(mask)), cell, capacity=160)
    tpos = tm.subsample(t(pts), "avg").numpy()
    np.testing.assert_array_equal(tm.n_cells.numpy(), np.asarray(jm.n_cells))
    np.testing.assert_array_equal(tm.out_mask.numpy(), np.asarray(jm.out_mask))
    np.testing.assert_array_equal(tm.cell_id.numpy(), np.asarray(jm.cell_id))
    for bi in range(2):
        ours = tpos[bi][tm.out_mask[bi].numpy()]
        ref = jpos[bi][np.asarray(jm.out_mask[bi])]
        np.testing.assert_allclose(_sorted_rows(ours), _sorted_rows(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cell,cap", [(0.08, 160), (0.2, 160), (0.08, 48)])  # 48: overflow clip
def test_sorted_cell_sums_match_scatter_add(cell, cap):
    """The grid average's cell sums as a GPU computes them (sorted
    ``index_put_``, a spare cell per padded point), run here, against the
    CPU's ``scatter_add_`` on the same cells."""
    pts, mask = _cloud(3, tail=(0, 120))
    tm = grid.build_grid_subsample(PointCloud(t(pts), t(mask)), cell, capacity=cap)
    m = t(mask)
    vm = t(pts) * m[..., None]
    s = torch.where(m, tm.cell_id, torch.zeros_like(tm.cell_id))
    shape = (2, cap, 3)
    ours = grid._sorted_cell_sums(vm, s, m, shape)
    assert ours.shape == shape
    np.testing.assert_allclose(ours.numpy(), grid._cell_sums(vm, s, m, shape).numpy(), atol=1e-6, rtol=0)


def test_grid_rnd_with_injected_uniforms_and_overflow_clip():
    pts, mask = _cloud(1)
    cap = 48  # fewer than the occupied cells: overflow clips into the last cell
    key = jax.random.PRNGKey(5)
    jm = jgrid.build_grid_subsample(
        JCloud(jnp.asarray(pts), jnp.asarray(mask)), 0.08, rnd=True, rng=key, capacity=cap
    )
    u = np.stack([np.asarray(jax.random.uniform(k, (cap,))) for k in jax.random.split(key, 2)])
    tm = grid.build_grid_subsample(
        PointCloud(t(pts), t(mask)), 0.08, rnd=True, uniforms=t(u), capacity=cap
    )
    assert int(tm.n_cells.min()) > cap
    np.testing.assert_array_equal(tm.chosen_idx.numpy(), np.asarray(jm.chosen_idx))
    np.testing.assert_array_equal(tm.cell_id.numpy(), np.asarray(jm.cell_id))
    labels = np.random.default_rng(2).integers(0, 7, size=mask.shape).astype(np.int32)
    np.testing.assert_array_equal(
        tm.subsample(t(labels), "max").numpy(), np.asarray(jm.subsample(jnp.asarray(labels), "max"))
    )


@pytest.mark.parametrize("name", ["masked_sum", "masked_mean", "masked_max", "masked_min"])
def test_masked_reductions(name):
    pts, mask = _cloud(13)
    ours = getattr(tpointcloud, name)(t(pts), t(mask), 1).numpy()
    ref = np.asarray(getattr(jpointcloud, name)(jnp.asarray(pts), jnp.asarray(mask), axis=1))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def _assert_same_neighbor_sets(tn, jn):
    np.testing.assert_array_equal(tn.mask.numpy(), np.asarray(jn.mask))
    ti = np.sort(np.where(tn.mask.numpy(), tn.idx.numpy(), -1), -1)
    ji = np.sort(np.where(np.asarray(jn.mask), np.asarray(jn.idx), -1), -1)
    np.testing.assert_array_equal(ti, ji)
    # invalid slots are clamped to source 0
    assert (tn.idx.numpy()[~tn.mask.numpy()] == 0).all()


@pytest.mark.parametrize("method", ["knn", "ball_query"])
def test_neighbor_sets(method):
    pts, mask = _cloud(3)
    qpts, qmask = _cloud(4, n=90, tail=(11, 0))
    jsrc, jq = JCloud(jnp.asarray(pts), jnp.asarray(mask)), JCloud(jnp.asarray(qpts), jnp.asarray(qmask))
    tsrc, tq = PointCloud(t(pts), t(mask)), PointCloud(t(qpts), t(qmask))
    if method == "knn":
        jn = jneigh.knn_neighborhood(jsrc, jq, 12, grid_cell_size=0.1)
        tn = neighborhoods.knn_neighborhood(tsrc, tq, 12, grid_cell_size=0.1)
    else:
        # radius 0.3: about 11 in-ball sources per query, so the cap of 12
        # truncates some rows (nearest-k kept) and not others
        jn = jneigh.ball_query_neighborhood(jsrc, jq, 0.3, 12, want_trunc=True)
        tn = neighborhoods.ball_query_neighborhood(tsrc, tq, 0.3, 12, want_trunc=True)
        np.testing.assert_array_equal(tn.trunc.numpy(), np.asarray(jn.trunc))
        assert tn.trunc.any() and not tn.trunc.all()
    _assert_same_neighbor_sets(tn, jn)


def test_grid_threshold_raises_instead_of_brute_force(monkeypatch):
    """At ``GRID_AUTO_THRESHOLD`` points on either side the searches take the
    grid (``tests/test_torch_grid.py``): brute force, made to raise here, is
    never reached."""
    n = neighborhoods.GRID_AUTO_THRESHOLD
    pts = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, n, 3)).astype(np.float32))
    big = PointCloud(pts, torch.ones(1, n, dtype=torch.bool))
    small = PointCloud(pts[:, :8].clone(), torch.ones(1, 8, dtype=torch.bool))

    def brute(*args, **kwargs):
        raise NotImplementedError("brute force at the grid threshold")

    monkeypatch.setattr(neighborhoods, "_chunked_topk_neighbors", brute)
    bq = neighborhoods.ball_query_neighborhood(big, small, 0.1, 4)
    kn = neighborhoods.knn_neighborhood(small, big, 4, grid_cell_size=0.1)
    assert bq.mask.all() and kn.mask.all()  # 8 query points inside the big cloud; 8 >= 4 sources
    with pytest.raises(NotImplementedError):
        neighborhoods.knn_neighborhood(small, big, 4)  # no spacing hint: brute force


def _eig_gap_ok(cov, rel_gap=1e-2):
    w = np.linalg.eigvalsh(cov.astype(np.float64))
    span = np.maximum(w[..., 2] - w[..., 0], 1e-30)
    return np.diff(w, axis=-1).min(-1) / span > rel_gap


@pytest.mark.parametrize("fixed_axis", [False, 2])
def test_pca_frames_with_injected_selection(fixed_axis):
    pts, mask = _cloud(6)
    jn = jneigh.knn_neighborhood(JCloud(jnp.asarray(pts), jnp.asarray(mask)),
                                 JCloud(jnp.asarray(pts), jnp.asarray(mask)), 10)
    s = 2 if fixed_axis else 4
    sel = np.argsort(np.random.default_rng(7).uniform(size=pts.shape[:2] + (s,)), -1)[..., :2]
    jf = np.asarray(jframes.pca_frames(jnp.asarray(pts), jn.idx, jn.mask, fixed_axis,
                                       select_idx=jnp.asarray(sel)))
    tf = frames.pca_frames(t(pts), t(jn.idx), t(jn.mask), fixed_axis, select_idx=t(sel)).numpy()
    assert tf.shape == jf.shape == pts.shape[:2] + (2, 3, 3)
    # covariance exactly as both solvers see it, to mask near-degenerate points
    nb = pts[np.arange(2)[:, None, None], np.asarray(jn.idx)]
    nb = np.where(np.asarray(jn.mask)[..., None], nb, pts[:, :, None, :])
    if fixed_axis:
        nb[..., int(fixed_axis)] = 0.0
    c = nb - nb.mean(2, keepdims=True)
    cov = np.einsum("bnki,bnkj->bnij", c, c)
    ok = _eig_gap_ok(cov)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(tf[ok], jf[ok], atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.det(tf[ok]), 1.0, atol=1e-4)


def test_rotation_helpers():
    rng = np.random.default_rng(8)
    m = rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(matrix_to_rotation_6d(t(m)).numpy(), np.asarray(jm6d(jnp.asarray(m))))
    fa, fb = rng.normal(size=(4, 2, 3, 3)).astype(np.float32), rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(relative_rotations(t(fa), t(fb)).numpy(),
                               np.asarray(jrelrot(jnp.asarray(fa), jnp.asarray(fb))), atol=1e-6)
    r = random_rotations(16, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose((r @ r.transpose(1, 2)).numpy(), np.broadcast_to(np.eye(3), (16, 3, 3)),
                               atol=1e-5)
    np.testing.assert_allclose(torch.linalg.det(r).numpy(), 1.0, atol=1e-5)


def _tiny_cfgs():
    jcfg = jhier.HierarchyConfig(
        init_cell_size=0.08, cell_sizes=(0.16, 0.32), capacities=(160, 64, 32),
        out_cell_size=0.1, out_capacity=160, frames=jhier.FrameConfig(n_frames=2, neigh_k=8),
    )
    tcfg = hierarchy.HierarchyConfig(
        init_cell_size=0.08, cell_sizes=(0.16, 0.32), capacities=(160, 64, 32),
        out_cell_size=0.1, out_capacity=160, frames=hierarchy.FrameConfig(n_frames=2, neigh_k=8),
    )
    return jcfg, tcfg


def test_build_hierarchy_matches_jax():
    pts, mask = _cloud(9, n=240, tail=(0, 40))
    rng = np.random.default_rng(10)
    feats = rng.normal(size=pts.shape[:2] + (3,)).astype(np.float32)
    labels = rng.integers(0, 5, size=pts.shape[:2]).astype(np.int32)
    jcfg, tcfg = _tiny_cfgs()
    key = jax.random.PRNGKey(11)
    jh, jf0, jout, jlab, jmap = jax.jit(jhier.build_hierarchy, static_argnums=(4,))(
        key, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats), jcfg, jnp.asarray(labels)
    )
    draws = jax_hierarchy_draws(key, jcfg, 2, pts.shape[1])
    th, tf0, tout, tlab, tmap = hierarchy.build_hierarchy(
        t(pts), t(mask), t(feats), tcfg, t(labels), draws=draws
    )
    np.testing.assert_allclose(tf0.numpy(), np.asarray(jf0), atol=1e-6)
    clouds = list(zip(th.levels, jh.levels)) + [(tout, to_torch_cloud(jout))]
    for lvl, (a, b) in enumerate(clouds):
        bm = np.asarray(b.mask)
        np.testing.assert_array_equal(a.mask.numpy(), bm, err_msg=f"level {lvl}")
        np.testing.assert_allclose(a.positions.numpy()[bm], np.asarray(b.positions)[bm], atol=1e-6)
        close = np.abs(a.frames.numpy() - np.asarray(b.frames)).max((-1, -2, -3)) < 1e-4
        # frame choice and sign follow the injected draws: all but the rare
        # near-degenerate covariance agree
        assert close[bm].mean() > 0.97, f"level {lvl}: {close[bm].mean()}"
    np.testing.assert_array_equal(tmap.chosen_idx.numpy(), np.asarray(jmap.chosen_idx))
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    for a, b in zip(th.maps, jh.maps):
        np.testing.assert_array_equal(a.cell_id.numpy(), np.asarray(b.cell_id))


def test_rotate_hierarchy_rotates_points_and_frames():
    _, tcfg = _tiny_cfgs()
    pts, mask = _cloud(12)
    th, _, _, _, _ = hierarchy.build_hierarchy(
        t(pts), t(mask), None, tcfg, generator=torch.Generator().manual_seed(1)
    )
    rot = random_rotations(1, generator=torch.Generator().manual_seed(2))[0]
    rh = hierarchy.rotate_hierarchy(th, rot)
    for a, b in zip(th.levels, rh.levels):
        np.testing.assert_allclose((a.positions @ rot.T).numpy(), b.positions.numpy(), atol=1e-6)
        # local coordinates of a fixed offset are unchanged by a global rotation
        v = a.positions[:, :1, None, :] - a.positions[:, :, None, :]
        va = torch.einsum("bnfd,bnfde->bnfe", v.expand(-1, -1, 2, -1), a.frames)
        vb = torch.einsum("bnfd,bnfde->bnfe", (v @ rot.T).expand(-1, -1, 2, -1), b.frames)
        np.testing.assert_allclose(va.numpy(), vb.numpy(), atol=1e-5)
