"""The port's farthest-point sampling (``se3conv3d_tpu_torch/core/fps.py``)
against the JAX package's ``core/fps.py`` on the same numpy clouds: ``ids``,
``out_mask`` and ``nearest`` exactly equal, also where ``n_samples`` exceeds
an example's valid points (from there on every pick is a tie, broken at the
first index, and ``nearest`` meets duplicate selected points), and the
subsample / upsample gathers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3conv3d_tpu.core.fps import fps_subsample as jfps
from se3conv3d_tpu.core.fps import fps_subsample_cloud as jfps_cloud
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud

from se3conv3d_tpu_torch.core.fps import fps_subsample, fps_subsample_cloud
from se3conv3d_tpu_torch.core.pointcloud import PointCloud

torch.set_num_threads(2)


def _cloud(b, n, valid, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(b, n, 3)).astype(np.float32) * np.array([1.0, 1.7, 0.5], np.float32)
    mask = np.arange(n)[None] < np.asarray(valid)[:, None]
    return pts, mask


CASES = {
    # name: (B, N, valid points per example, n_samples, start_idx)
    "dense": ((3, 300, (300, 300, 300), 64, 0)),
    "masked_tails": ((3, 300, (300, 250, 120), 96, 0)),
    "samples_beyond_valid": ((3, 200, (200, 40, 7), 64, 0)),
    "start_elsewhere": ((2, 150, (150, 90), 32, 5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fps_matches_jax_exactly(name):
    b, n, valid, samples, start = CASES[name]
    pts, mask = _cloud(b, n, valid, seed=len(name))
    jm = jfps(JCloud(jnp.asarray(pts), jnp.asarray(mask)), samples, start_idx=start)
    tm = fps_subsample(PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)), samples, start_idx=start)
    np.testing.assert_array_equal(tm.ids.numpy(), np.asarray(jm.ids))
    np.testing.assert_array_equal(tm.out_mask.numpy(), np.asarray(jm.out_mask))
    np.testing.assert_array_equal(tm.nearest.numpy(), np.asarray(jm.nearest))
    assert tm.ids.dtype == torch.int64 and tm.nearest.dtype == torch.int64
    if name == "samples_beyond_valid":
        # past the valid count every pick repeats the first valid point
        for i, v in enumerate(valid):
            if v < samples:
                assert (tm.ids[i, v:] == 0).all() and int(tm.out_mask[i].sum()) == v
    vals = np.random.default_rng(3).normal(size=(b, n, 4)).astype(np.float32)
    np.testing.assert_array_equal(tm.subsample(torch.from_numpy(vals)).numpy(),
                                  np.asarray(jm.subsample(jnp.asarray(vals))))
    sub = np.asarray(jm.subsample(jnp.asarray(vals)))
    np.testing.assert_array_equal(tm.upsample(torch.from_numpy(sub)).numpy(),
                                  np.asarray(jm.upsample(jnp.asarray(sub))))


def test_fps_cloud_matches_jax():
    pts, mask = _cloud(2, 180, (180, 100), seed=9)
    jsub, jm = jfps_cloud(JCloud(jnp.asarray(pts), jnp.asarray(mask)), 48)
    sub, tm = fps_subsample_cloud(PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)), 48)
    np.testing.assert_array_equal(sub.positions.numpy(), np.asarray(jsub.positions))
    np.testing.assert_array_equal(sub.mask.numpy(), np.asarray(jsub.mask))
    np.testing.assert_array_equal(tm.src_mask.numpy(), mask)
