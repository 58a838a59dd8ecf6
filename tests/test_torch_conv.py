"""The port's fused equivariant conv against the JAX package.

CPU tensors run the kernel's plain PyTorch version; it is held against
``se3conv3d_tpu.ops.fused_equiv_conv`` (the Pallas kernel in interpret mode,
as ``tests/test_fused_equiv.py`` runs it) and against the JAX XLA einsum
path, at atol 2e-4 / rtol 5e-5 -- the bounds of ``tests/test_fused_equiv.py``.
The CUDA kernel itself is compared with the plain version on the card in
``tests/test_torch_kernel_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t, to_torch_cloud

import se3conv3d_tpu.ops.pallas.fused_equiv as fe
from se3conv3d_tpu.core.frames import pca_frames
from se3conv3d_tpu.core.neighborhoods import ball_query_neighborhood as jball
from se3conv3d_tpu.core.neighborhoods import knn_neighborhood as jknn
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.nn.conv import PNEConv as JPNEConv
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.nn.conv import PNEConv
from se3conv3d_tpu_torch.ops import pne_conv as ops

torch.set_num_threads(2)

ATOL, RTOL = 2e-4, 5e-5
K, Q, C, O = 8, 16, 24, 20


def _cloud(rng, b, n, tail, g):
    pts = rng.uniform(size=(b, n, 3)).astype(np.float32) * 2.0
    mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
    jpc = JCloud(jnp.asarray(pts), jnp.asarray(mask))
    kn = jknn(jpc, jpc, 8)
    sel = np.argsort(rng.uniform(size=(b, n, 4)), -1)[..., :g]
    frames = pca_frames(jpc.positions, kn.idx, kn.mask, select_idx=jnp.asarray(sel))
    return JCloud(jpc.positions, jpc.mask, frames)


def _case(seed, g, m_out, q_tail):
    """Source cloud of 96 points (masked tail), query cloud of ``m_out``
    points (masked tail ``q_tail``), ball-query neighborhood."""
    rng = np.random.default_rng(seed)
    pc_in = _cloud(rng, 2, 96, (0, 7), g)
    pc_out = _cloud(rng, 2, m_out, (q_tail, 0), g)
    neigh = jball(pc_in, pc_out, 0.5, K)
    feats = rng.normal(size=(2, 96, g, C)).astype(np.float32)
    pa = (rng.normal(size=(9, Q)) * 0.3).astype(np.float32)
    pb = (rng.normal(size=(Q,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(C, Q, O)) * 0.1).astype(np.float32)
    return pc_in, pc_out, neigh, feats, pa, pb, w


CASES = {
    # name: (seed, G=F, M_out, masked query tail, Pallas tile_m)
    "self_g2": (0, 2, 96, 0, 32),
    "ragged_m_masked_tail": (1, 2, 70, 9, 64),
    "g1": (2, 1, 96, 0, 32),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_equiv_conv_matches_jax(name, monkeypatch):
    seed, g, m_out, q_tail, tile = CASES[name]
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(seed, g, m_out, q_tail)
    nd, nn_ = 3.0, 0.11
    jf = jnp.asarray(feats)
    pallas = jops.fused_equiv_conv(pc_in, pc_out, neigh, jf, jnp.asarray(pa), jnp.asarray(pb),
                                   jnp.asarray(w), jnp.asarray(nd), jnp.asarray(nn_), tile_m=tile)
    geo = jops.equiv_geometry(pc_in, pc_out, neigh, jnp.asarray(nd), "6D")
    pne = jops.linear_pne(geo, jnp.asarray(pa), jnp.asarray(pb), jops.pne_activation("mlp_gelu"))
    pne = pne * neigh.mask[:, :, :, None, None, None]
    xla = jops.equiv_basis_conv(pne, jf, neigh, jnp.asarray(w), jnp.asarray(nn_))

    tn = Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.5)
    got = ops.fused_equiv_conv(
        to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn, t(feats), t(pa), t(pb), t(w),
        torch.tensor(nd), torch.tensor(nn_),
    ).numpy()
    assert got.shape == (2, m_out, g, O)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(xla), atol=ATOL, rtol=RTOL)

    # the port's unfused einsum ops agree too (oracle of the kernel's plain version)
    rel, rot6 = ops.equiv_geometry_parts(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn)
    tgeo = torch.cat([(rel * nd)[:, :, :, :, None, :].expand(-1, -1, -1, -1, g, -1), rot6], -1)
    tpne = ops.linear_pne(tgeo, t(pa), t(pb), ops.pne_activation("mlp_gelu"))
    tpne = tpne * tn.mask[:, :, :, None, None, None]
    unfused = ops.equiv_basis_conv(tpne, t(feats), tn, t(w), torch.tensor(nn_)).numpy()
    np.testing.assert_allclose(unfused, np.asarray(xla), atol=ATOL, rtol=RTOL)


def test_wrapper_dispatches_cpu_tensors_to_the_plain_version():
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(3, 2, 40, 5)
    tn = Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.5)
    rel, rot6 = ops.equiv_geometry_parts(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn)
    args = (rel, rot6, t(feats), tn.idx, tn.mask, t(pa), t(pb), t(w))
    before = kfe.fused_equiv_fwd.launches
    np.testing.assert_array_equal(kfe.fused_equiv_fwd(*args).numpy(),
                                  kfe.fused_equiv_fwd_reference(*args).numpy())
    assert kfe.fused_equiv_fwd.launches == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("method", ["ball_query", "knn"])
def test_pne_conv_calibration_matches_flax(method):
    """Calibration buffers: start at 1.0, the first pass sets them, the
    second takes the 0.9/0.1 EMA; ``trunc_frac`` is a running max."""
    pc_in, pc_out, _, feats, _, _, _ = _case(4, 2, 60, 6)
    second_out = _case(5, 2, 60, 0)[1]
    jconv = JPNEConv(C, O, Q, "mlp_gelu", equivariant=True, use_fused=False)
    conv = PNEConv(C, O, Q)
    jf = jnp.asarray(feats)

    def neigh_pair(out):
        if method == "knn":
            jn = jknn(pc_in, out, K)
        else:
            jn = jball(pc_in, out, 0.5, K, want_trunc=True)
        tn = Neighborhood(t(jn.idx), t(jn.mask), t(jn.query_mask), jn.method, jn.radius,
                          trunc=t(jn.trunc))
        return jn, tn

    v = jconv.init(jax.random.PRNGKey(0), pc_in, pc_out, jf, neigh_pair(pc_out)[0])
    for out in (pc_out, second_out):
        jn, tn = neigh_pair(out)
        _, mut = jconv.apply(v, pc_in, out, jf, jn, calibrate=True, mutable=["calib"])
        v = {**v, **mut}
        with torch.no_grad():
            conv(to_torch_cloud(pc_in), to_torch_cloud(out), t(feats), tn, calibrate=True)
    for name, ref in v["calib"].items():
        np.testing.assert_allclose(getattr(conv, name).numpy(), np.asarray(ref), rtol=1e-6,
                                   err_msg=name)
    assert bool(conv.initialized)
