"""The port's fused equivariant conv against the JAX package.

CPU tensors run the kernel's plain PyTorch version; it is held against
``se3conv3d_tpu.ops.fused_equiv_conv`` (the Pallas kernel in interpret mode,
as ``tests/test_fused_equiv.py`` runs it) and against the JAX XLA einsum
path, at atol 2e-4 / rtol 5e-5 -- the bounds of ``tests/test_fused_equiv.py``.
Its gradients (the plain backward) are held against ``jax.grad`` through the
Pallas backward kernel in interpret mode at that file's gradient bounds.
The CUDA kernels themselves are compared with the plain versions on the card
in ``tests/test_torch_kernel_cuda.py``.
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


@pytest.mark.parametrize("name", ["self_g2", "g1"])
def test_fused_equiv_conv_gradients_match_jax_pallas_backward(name, monkeypatch):
    """Gradients of ``sum(out * cos(out))`` through the port's differentiable
    conv (CPU tensors: the plain backward) against ``jax.grad`` through the
    lean VJP, which runs the Pallas ``_bwd_kernel`` in interpret mode, at
    the bounds of ``tests/test_fused_equiv.py::test_gradients_match_xla_path``
    (atol 5e-4, rtol 5e-3)."""
    seed, g, m_out, q_tail, tile = CASES[name]
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(seed, g, m_out, q_tail)
    nd, nn_ = 3.0, 0.11

    def jloss(params):
        out = jops.fused_equiv_conv(pc_in, pc_out, neigh, *params, jnp.asarray(nd),
                                    jnp.asarray(nn_), tile_m=tile, lean_vjp=True)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(jloss)(tuple(jnp.asarray(x) for x in (feats, pa, pb, w)))

    tn = Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.5)
    params = [t(x).requires_grad_() for x in (feats, pa, pb, w)]
    nd_t, nn_t = torch.tensor(nd), torch.tensor(nn_)
    before = kfe.fused_equiv_bwd.launches
    out = ops.fused_equiv_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn, *params,
                               nd_t, nn_t)
    (out * torch.cos(out)).sum().backward()
    assert kfe.fused_equiv_bwd.launches == before  # CPU tensors launch no kernel
    assert nd_t.grad is None and nn_t.grad is None
    for p, ref, pname in zip(params, want, ("feats", "proj_axes", "proj_biases", "conv_weights")):
        assert np.abs(np.asarray(ref)).max() > 0, pname
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref), atol=5e-4, rtol=5e-3,
                                   err_msg=pname)


def test_fused_equiv_function_gradcheck_float64_and_saves_only_inputs():
    """``torch.autograd.gradcheck`` of the Function's CPU path in float64 at a
    tiny shape (masked and repeated neighbors), and its residuals are its
    eight inputs: the backward recomputes pne and basis."""
    gen = torch.Generator().manual_seed(0)
    b, m, n, k, g, f, q, c, o = 2, 5, 7, 4, 2, 2, 3, 3, 4

    def rnd(*s):
        return torch.randn(*s, generator=gen, dtype=torch.float64)

    idx = torch.randint(0, n, (b, m, k), generator=gen)
    mask = torch.rand(b, m, k, generator=gen) < 0.7
    geometry = (rnd(b, m, k, g, 3), rnd(b, m, k, g, f, 6), idx, mask)
    feats, pa, pb, w = (x.requires_grad_() for x in (rnd(b, n, f, c), rnd(9, q), rnd(q), rnd(c, q, o)))
    args = (geometry[0], geometry[1], feats, idx, mask, pa, pb, w)
    assert torch.autograd.gradcheck(kfe.fused_equiv, args)
    out = kfe.fused_equiv(*args)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == len(args)
    for s, a in zip(saved, args):
        assert s.shape == a.shape and s.data_ptr() == a.data_ptr()


def test_wrapper_dispatches_cpu_tensors_to_the_plain_version():
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(3, 2, 40, 5)
    tn = Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.5)
    rel, rot6 = ops.equiv_geometry_parts(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn)
    args = (rel, rot6, t(feats), tn.idx, tn.mask, t(pa), t(pb), t(w))
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    np.testing.assert_array_equal(kfe.fused_equiv_fwd(*args).numpy(),
                                  kfe.fused_equiv_fwd_reference(*args).numpy())
    gout = torch.randn(2, 40, 2, O, generator=torch.Generator().manual_seed(1))
    for got, ref in zip(kfe.fused_equiv_bwd(*args, gout), kfe.fused_equiv_bwd_reference(*args, gout)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    # CPU tensors launch no kernel
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == before


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
