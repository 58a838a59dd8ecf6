"""The port's 'sorted' feature-gradient reduction against the JAX package.

* ``blocked_cumsum`` (CPU tensors: its plain version) and
  ``sorted_segment_sum`` against ``se3conv3d_tpu.ops.pallas.segsum`` (the
  Pallas ``_cumsum_kernel`` in interpret mode) and numpy, at the shapes and
  tolerances of ``tests/test_segsum.py``;
* ``backward_sort_tables`` equal to the JAX tables where ``M <= 16384``
  (one JAX chunk);
* the fused conv's gradients in 'sorted' mode against 'scatter' mode in the
  port, and against ``jax.grad`` with the JAX package's
  ``BWD_SCATTER_MODE`` set to 'sorted' (as ``tests/test_segsum.py`` sets
  it), at the gradient bounds of ``tests/test_torch_conv.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t, to_torch_cloud

import se3conv3d_tpu.ops.pallas.fused_equiv as fe
from se3conv3d_tpu.core.frames import pca_frames
from se3conv3d_tpu.core.neighborhoods import Neighborhood as JNeighborhood
from se3conv3d_tpu.core.neighborhoods import ball_query_neighborhood as jball
from se3conv3d_tpu.core.neighborhoods import knn_neighborhood as jknn
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu.ops.pallas import segsum as jsegsum
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.kernels import segsum
from se3conv3d_tpu_torch.ops import pne_conv as ops

torch.set_num_threads(2)


@pytest.mark.parametrize("e,c,blk", [(16, 8, 8), (1000, 128, 256), (513, 32, 128)])
def test_blocked_cumsum_matches_jax_and_numpy(e, c, blk):
    x = np.random.default_rng(0).standard_normal((e, c)).astype(np.float32)
    before = segsum.blocked_cumsum.launches
    ours = segsum.blocked_cumsum(t(x))
    assert segsum.blocked_cumsum.launches == before  # CPU tensors launch no kernel
    np.testing.assert_array_equal(ours.numpy(), segsum.blocked_cumsum_reference(t(x)).numpy())
    ref = np.asarray(jsegsum.blocked_cumsum(jnp.asarray(x), block=blk))
    for block_ours in {blk, segsum.BLOCK}:
        got = segsum.blocked_cumsum_reference(t(x), block_ours).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got, np.cumsum(x, axis=0), rtol=1e-5, atol=1e-4)


def test_blocked_cumsum_is_batched_over_the_leading_axis():
    x = np.random.default_rng(1).standard_normal((3, 700, 24)).astype(np.float32)
    batched = segsum.blocked_cumsum(t(x)).numpy()
    assert batched.shape == x.shape
    for i in range(3):
        np.testing.assert_allclose(batched[i], segsum.blocked_cumsum(t(x[i])).numpy(),
                                   rtol=1e-6, atol=1e-5)


def test_sorted_segment_sum_matches_jax_and_scatter_oracle():
    rng = np.random.default_rng(2)
    e, c, n = 2048, 64, 300
    segs = np.sort(rng.integers(0, n, e)).astype(np.int32)
    data = rng.standard_normal((e, c)).astype(np.float32)
    rs = np.searchsorted(segs, np.arange(n), side="left").astype(np.int32)
    re = np.searchsorted(segs, np.arange(n), side="right").astype(np.int32)
    assert (rs == re).any()  # some empty segments
    oracle = np.zeros((n, c), np.float32)
    np.add.at(oracle, segs, data)
    ours = segsum.sorted_segment_sum(t(data), t(rs), t(re)).numpy()
    np.testing.assert_allclose(ours, oracle, rtol=1e-4, atol=1e-3)
    ref = np.asarray(jsegsum.sorted_segment_sum(jnp.asarray(data), jnp.asarray(rs), jnp.asarray(re)))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-3)
    # batched: [B, E, C] with [B, N] bounds
    both = segsum.sorted_segment_sum(t(np.stack([data, -data])), t(np.stack([rs, rs])),
                                     t(np.stack([re, re]))).numpy()
    np.testing.assert_allclose(both[1], -ours, rtol=1e-6, atol=1e-5)


def _neighbor_table(seed, b, m, k, n):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(b, m, k)) < 0.7
    mask[:, -7:] = False  # a padded query tail
    idx = np.where(mask, rng.integers(0, n, (b, m, k)), 0).astype(np.int32)
    return idx, mask, mask.any(-1)


@pytest.mark.parametrize("m,k,n", [(300, 8, 150), (16384, 2, 4000)])
def test_backward_sort_tables_match_jax(m, k, n):
    idx, mask, qmask = _neighbor_table(3, 2, m, k, n)
    jt = jops.backward_sort_tables(
        JNeighborhood(idx=jnp.asarray(idx), mask=jnp.asarray(mask), query_mask=jnp.asarray(qmask)), n)
    assert jt.bwd_perm.shape == (2, 1, m * k)  # M <= M_CHUNK_DEFAULT: one JAX chunk
    tt = ops.backward_sort_tables(Neighborhood(t(idx), t(mask), t(qmask)), n)
    np.testing.assert_array_equal(tt.bwd_perm.numpy(), np.asarray(jt.bwd_perm)[:, 0])
    np.testing.assert_array_equal(tt.bwd_run_start.numpy(), np.asarray(jt.bwd_run_start)[:, 0])
    np.testing.assert_array_equal(tt.bwd_run_end.numpy(), np.asarray(jt.bwd_run_end)[:, 0])
    # the slot table is the inverse permutation
    ar = torch.arange(m * k).expand(2, -1)
    np.testing.assert_array_equal(tt.bwd_slot.gather(1, tt.bwd_perm).numpy(), ar.numpy())


def _conv_case(seed, g):
    """Source cloud of 96 points (masked tail of 7), query cloud of 70 (masked
    tail of 9), ball query with K=8, G=F=g frames."""
    rng = np.random.default_rng(seed)

    def cloud(n, tail):
        pts = rng.uniform(size=(2, n, 3)).astype(np.float32) * 2.0
        mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
        jpc = JCloud(jnp.asarray(pts), jnp.asarray(mask))
        kn = jknn(jpc, jpc, 8)
        sel = np.argsort(rng.uniform(size=(2, n, 4)), -1)[..., :g]
        return JCloud(jpc.positions, jpc.mask,
                      pca_frames(jpc.positions, kn.idx, kn.mask, select_idx=jnp.asarray(sel)))

    pc_in, pc_out = cloud(96, (0, 7)), cloud(70, (9, 0))
    neigh = jball(pc_in, pc_out, 0.5, 8)
    params = (rng.normal(size=(2, 96, g, 24)).astype(np.float32),
              (rng.normal(size=(9, 16)) * 0.3).astype(np.float32),
              (rng.normal(size=(16,)) * 0.1).astype(np.float32),
              (rng.normal(size=(24, 16, 20)) * 0.1).astype(np.float32))
    return pc_in, pc_out, neigh, params


@pytest.mark.parametrize("g", [1, 2])
def test_sorted_conv_gradients_match_scatter_and_jax_sorted(g, monkeypatch):
    """Gradients of ``sum(out * cos(out))``.  Port sorted vs port scatter:
    the two reduce the same per-edge rows in other orders, and a prefix
    difference adds about eps * max |prefix|, so 1e-5 of the leaf's largest
    value.  Port sorted vs JAX sorted (Pallas kernels in interpret mode):
    atol 5e-4, rtol 5e-3, the gradient bounds of ``tests/test_torch_conv.py``."""
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    monkeypatch.setattr(jops, "BWD_SCATTER_MODE", "sorted")
    pc_in, pc_out, neigh, params = _conv_case(5 + g, g)
    nd, nn_ = 3.0, 0.11

    def jloss(p):
        out = jops.fused_equiv_conv(pc_in, pc_out, neigh, *p, jnp.asarray(nd), jnp.asarray(nn_))
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(jloss)(tuple(jnp.asarray(x) for x in params))

    tn = Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.5)
    calls = []
    real = kfe.sorted_segment_sum
    monkeypatch.setattr(kfe, "sorted_segment_sum", lambda *a: (calls.append(1), real(*a))[1])
    grads = {}
    for mode in ("scatter", "sorted"):
        monkeypatch.setattr(ops, "BWD_SCATTER_MODE", mode)
        leaves = [t(x).requires_grad_() for x in params]
        out = ops.fused_equiv_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn, *leaves,
                                   torch.tensor(nd), torch.tensor(nn_))
        (out * torch.cos(out)).sum().backward()
        grads[mode] = [x.grad.numpy() for x in leaves]
    assert len(calls) == 1  # only the sorted mode's backward reduces through the tables
    names = ("feats", "proj_axes", "proj_biases", "conv_weights")
    for name, s, x, ref in zip(names, grads["sorted"], grads["scatter"], want):
        assert np.abs(np.asarray(ref)).max() > 0, name
        assert np.abs(s - x).max() <= 1e-5 * np.abs(x).max(), name
        np.testing.assert_allclose(s, np.asarray(ref), atol=5e-4, rtol=5e-3, err_msg=name)


def test_unknown_backward_mode_raises(monkeypatch):
    monkeypatch.setattr(ops, "BWD_SCATTER_MODE", "atomic")
    with pytest.raises(ValueError):
        ops.sorted_backward()
