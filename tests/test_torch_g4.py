"""The fused equivariant conv at G = F = 4 (the mixed-frame-count recipes'
``mix_n_frames`` draw of 4 frames) against the JAX package.

At Q = 32 a conv with four out-frames has G*Q = 128 (g, q) columns, which
the CUDA kernels take in their 128-column instantiations
(``kernels.fused_equiv.column_capacity``); on the CPU the port runs the
kernels' plain versions, held here:

* the forward and its four gradients (both feature-gradient modes, 'scatter'
  and 'sorted') against ``se3conv3d_tpu.ops.pne_conv.fused_equiv_conv``
  with the Pallas kernels in interpret mode (``FUSED_INTERPRET``): float32
  at the bounds of ``tests/test_torch_conv.py`` (forward atol 2e-4 / rtol
  5e-5; gradients atol 5e-4 / rtol 5e-3), bfloat16 at those of
  ``tests/test_torch_bf16.py`` (max error 1e-2, mean 1e-3 of max |JAX|,
  and the mean error against JAX bf16 at most half that against JAX
  float32);
* the plain versions against a float64 numpy oracle, in float32 (1e-5 of
  the largest value: float32 sums over up to 32 edges x 4 frames x 12
  channels) and in bfloat16 (rounding where the bf16 path rounds; the
  bounds of ``tests/test_torch_bf16.py::test_bf16_plain_versions_match_a_float64_oracle``);
* the wrapper's limits: G <= 4 and G*Q <= 128, K*F by column capacity.

The CUDA kernels are held against the plain versions at G = 4 on the card
(``tests/test_torch_kernel_cuda.py``, ``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from torch_port_helpers import t, to_torch_cloud

import se3conv3d_tpu.ops.pallas.fused_equiv as fe
from se3conv3d_tpu.core.frames import random_frames as jrandom_frames
from se3conv3d_tpu.core.neighborhoods import ball_query_neighborhood as jball
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.ops import pne_conv as ops

torch.set_num_threads(2)

G = F = 4
K, Q, C, O = 8, 32, 12, 10
ND, NN = 3.0, 0.11
TILE = 32
LEAVES = ("feats", "proj_axes", "proj_biases", "conv_weights")
ATOL, RTOL = 2e-4, 5e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
MAX_RTOL, MEAN_RTOL = 1e-2, 1e-3


@functools.lru_cache(maxsize=None)
def _case():
    """Source cloud of 96 points (masked tail) and query cloud of 70 points
    (masked tail), each with 4 random SO(3) frames per point, a ball-query
    neighborhood, features and parameters (numpy seed)."""
    rng = np.random.default_rng(40)

    def cloud(n, tail, key):
        pts = rng.uniform(size=(2, n, 3)).astype(np.float32) * 2.0
        mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
        return JCloud(jnp.asarray(pts), jnp.asarray(mask), jrandom_frames(key, 2, n, G))

    pc_in = cloud(96, (0, 7), jax.random.PRNGKey(41))
    pc_out = cloud(70, (9, 0), jax.random.PRNGKey(42))
    neigh = jax.jit(jball, static_argnums=(2, 3))(pc_in, pc_out, 0.5, K)
    feats = rng.normal(size=(2, 96, F, C)).astype(np.float32)
    pa = (rng.normal(size=(9, Q)) * 0.3).astype(np.float32)
    pb = (rng.normal(size=(Q,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(C, Q, O)) * 0.1).astype(np.float32)
    return pc_in, pc_out, neigh, feats, pa, pb, w


def _port_conv(params, cdt):
    pc_in, pc_out, neigh = _case()[:3]
    tn = Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.5)
    return ops.fused_equiv_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn, *params,
                                torch.tensor(ND), torch.tensor(NN), compute_dtype=cdt)


@functools.lru_cache(maxsize=None)
def _jax_out(cdt):
    pc_in, pc_out, neigh, feats, pa, pb, w = _case()
    saved = fe.FUSED_INTERPRET
    fe.FUSED_INTERPRET = True
    try:
        return np.asarray(jops.fused_equiv_conv(
            pc_in, pc_out, neigh, *(jnp.asarray(x) for x in (feats, pa, pb, w)), jnp.asarray(ND),
            jnp.asarray(NN), tile_m=TILE, compute_dtype=cdt))
    finally:
        fe.FUSED_INTERPRET = saved


@functools.lru_cache(maxsize=None)
def _jax_grads(cdt, mode):
    """Gradients of ``sum(out * cos(out))`` through the lean VJP (the Pallas
    backward in interpret mode) in feature-gradient mode ``mode``."""
    pc_in, pc_out, neigh, feats, pa, pb, w = _case()
    saved = fe.FUSED_INTERPRET, jops.BWD_SCATTER_MODE
    fe.FUSED_INTERPRET, jops.BWD_SCATTER_MODE = True, mode
    try:
        def jloss(params):
            out = jops.fused_equiv_conv(pc_in, pc_out, neigh, *params, jnp.asarray(ND),
                                        jnp.asarray(NN), tile_m=TILE, compute_dtype=cdt,
                                        lean_vjp=True)
            return jnp.sum(out * jnp.cos(out))

        return tuple(np.asarray(x) for x in jax.grad(jloss)(
            tuple(jnp.asarray(x) for x in (feats, pa, pb, w))))
    finally:
        fe.FUSED_INTERPRET, jops.BWD_SCATTER_MODE = saved


def _hold_bf16(got, want_bf16, want_f32, what):
    scale = np.abs(want_bf16).max()
    assert scale > 0, what
    err = np.abs(got - want_bf16)
    assert err.max() <= MAX_RTOL * scale, (what, err.max(), scale)
    assert err.mean() <= MEAN_RTOL * scale, (what, err.mean(), scale)
    assert err.mean() <= 0.5 * np.abs(got - want_f32).mean(), (what, err.mean(),
                                                               np.abs(got - want_f32).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_g4_conv_forward_matches_jax_fused(dtype):
    cdt = torch.bfloat16 if dtype == "bfloat16" else None
    before = kfe.fused_equiv_fwd.launches
    with torch.no_grad():
        got = _port_conv([t(x) for x in _case()[3:]], cdt).numpy()
    assert kfe.fused_equiv_fwd.launches == before  # CPU tensors launch no kernel
    assert got.shape == (2, 70, G, O)
    if cdt is None:
        np.testing.assert_allclose(got, _jax_out(None), atol=ATOL, rtol=RTOL)
    else:
        _hold_bf16(got, _jax_out(jnp.bfloat16), _jax_out(None), "bf16 forward")


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_g4_conv_gradients_match_jax_pallas_backward(dtype, mode, monkeypatch):
    monkeypatch.setattr(ops, "BWD_SCATTER_MODE", mode)
    cdt = torch.bfloat16 if dtype == "bfloat16" else None
    params = [t(x).requires_grad_() for x in _case()[3:]]
    out = _port_conv(params, cdt)
    (out * torch.cos(out)).sum().backward()
    if cdt is None:
        for p, ref, leaf in zip(params, _jax_grads(None, mode), LEAVES):
            assert np.abs(ref).max() > 0, leaf
            np.testing.assert_allclose(p.grad.numpy(), ref, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"{mode} {leaf}")
    else:
        assert torch.equal(params[0].grad, params[0].grad.to(torch.bfloat16).float())
        for p, wb, wf, leaf in zip(params, _jax_grads(jnp.bfloat16, mode),
                                   _jax_grads(None, "scatter"), LEAVES):
            _hold_bf16(p.grad.numpy(), wb, wf, f"{mode} {leaf}")


def _bf(x):
    """float64 values rounded to bfloat16, as float64."""
    return torch.from_numpy(np.asarray(x, np.float64)).to(torch.bfloat16).double().numpy()


def _oracle(rel, rot6, feats, idx, mask, pa, pb, w, gout, rnd):
    """Float64 forward and backward of the conv, rounding with ``rnd`` where
    the bf16 path rounds (the identity for float32)."""
    b, m, k, g, _ = rel.shape
    f = rot6.shape[4]
    geo = np.concatenate([np.broadcast_to(rel[:, :, :, :, None], (b, m, k, g, f, 3)), rot6], -1)
    pre = geo @ rnd(pa) + rnd(pb)
    pne = rnd(0.5 * pre * (1.0 + erf(pre / np.sqrt(2.0))))
    bidx = np.arange(b)[:, None, None]
    edge = mask[:, :, :, None, None]
    gathered = feats[bidx, idx] * edge
    basis = rnd(np.einsum("bmkfc,bmkgfq->bmgcq", gathered, pne))
    wb = rnd(w)
    out = np.einsum("bmgcq,cqo->bmgo", basis, wb)
    go = rnd(gout)
    d_w = np.einsum("bmgcq,bmgo->cqo", basis, go)
    dbasis = rnd(np.einsum("bmgo,cqo->bmgcq", go, wb))
    d_edge = rnd(np.einsum("bmkgfq,bmgcq->bmkfc", pne, dbasis)) * edge
    d_feats = np.zeros(feats.shape)
    np.add.at(d_feats, (np.broadcast_to(bidx, idx.shape), idx), d_edge)
    dact = 0.5 * (1.0 + erf(pre / np.sqrt(2.0))) + pre * np.exp(-0.5 * pre * pre) / np.sqrt(2 * np.pi)
    dpne = np.einsum("bmkfc,bmgcq->bmkgfq", gathered, dbasis)
    dpre = rnd(dpne * dact) * mask[:, :, :, None, None, None]
    return out, (d_feats, np.einsum("bmkgfq,bmkgfd->dq", dpre, geo), dpre.sum((0, 1, 2, 3, 4)), d_w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_g4_plain_versions_match_a_float64_oracle(dtype):
    """``fused_equiv_fwd_reference`` / ``fused_equiv_bwd_reference`` at
    G = F = 4, Q = 32 on float32 operands (every output within 1e-5 of its
    largest value) and on bfloat16 ones (within one bfloat16 ulp of the
    largest value, 2^-7, and within 2^-7 / 32 on average: a version that
    skipped a rounding sits near 2^-9 on average)."""
    bf16 = dtype == "bfloat16"
    rnd = _bf if bf16 else (lambda x: np.asarray(x, np.float64))
    rng = np.random.default_rng(50 + bf16)
    b, m, n, k = 2, 40, 50, 32
    rel = rnd(rng.normal(size=(b, m, k, G, 3)) * 0.5)
    rot6 = rnd(rng.normal(size=(b, m, k, G, F, 6)) * 0.5)
    feats = rnd(rng.normal(size=(b, n, F, C)))
    idx = rng.integers(0, n, size=(b, m, k))
    mask = rng.uniform(size=(b, m, k)) < 0.7
    mask[:, -4:] = False
    pa, pb = rng.normal(size=(9, Q)) * 0.3, rng.normal(size=(Q,)) * 0.1
    w, gout = rng.normal(size=(C, Q, O)) * 0.1, rng.normal(size=(b, m, G, O))
    if not bf16:  # float32 operands and parameters
        pa, pb, w, gout = (np.asarray(x, np.float32).astype(np.float64) for x in (pa, pb, w, gout))
    want_out, want_grads = _oracle(rel, rot6, feats, idx, mask, pa, pb, w, gout, rnd)

    def operand(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(torch.bfloat16) if bf16 else x

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    args = (operand(rel), operand(rot6), operand(feats), torch.from_numpy(idx),
            torch.from_numpy(mask), f32(pa), f32(pb), f32(w))
    got_out = kfe.fused_equiv_fwd(*args)
    got_grads = kfe.fused_equiv_bwd(*args, f32(gout))
    assert kfe.column_capacity(G, Q) == 128
    for what, got, want in zip(("out",) + LEAVES, (got_out,) + got_grads, (want_out,) + want_grads):
        scale = np.abs(want).max()
        err = np.abs(got.double().numpy() - want)
        if bf16:
            assert err.max() <= 2.0**-7 * scale, (what, err.max(), scale)
            assert err.mean() <= 2.0**-7 / 32 * scale, (what, err.mean(), scale)
        else:
            assert err.max() <= 1e-5 * scale, (what, err.max(), scale)


def _operands(b, m, n, k, g, f, q, c, o):
    gen = torch.Generator().manual_seed(0)
    return (torch.zeros(b, m, k, g, 3), torch.zeros(b, m, k, g, f, 6), torch.zeros(b, n, f, c),
            torch.randint(0, n, (b, m, k), generator=gen), torch.ones(b, m, k, dtype=torch.bool),
            torch.zeros(9, q), torch.zeros(q), torch.zeros(c, q, o))


def test_kernel_limits_take_g4_and_raise_past_them():
    """``_check`` (the CUDA wrappers' argument check) accepts G = 4 with
    G*Q = 128 and K*F up to the 128-column edge limit, and raises past
    G = 4, G*Q = 128 or that limit; G <= 2 convs keep the 64-column
    capacity and its edge limit."""
    assert (kfe.MAX_G, kfe.MAX_GQ) == (4, 128)
    assert [kfe.column_capacity(g, q) for g, q in ((1, 64), (2, 32), (2, 33), (4, 16), (4, 32),
                                                   (1, 128), (3, 43), (5, 8), (4, 33))] == \
        [64, 64, 128, 128, 128, 128, 0, 0, 0]
    assert kfe._check(*_operands(2, 10, 12, 32, 4, 4, 32, 8, 8))[4:7] == (4, 4, 32)
    assert kfe._check(*_operands(1, 3, 5, 108, 4, 4, 32, 4, 4))  # K*F = 432
    assert kfe._check(*_operands(1, 3, 5, 384, 2, 2, 32, 4, 4))  # K*F = 768 at 64 columns
    for shape in ((2, 10, 12, 8, 5, 1, 8, 8, 8),      # G = 5
                  (2, 10, 12, 8, 4, 4, 33, 8, 8),     # G*Q = 132
                  (1, 3, 5, 109, 4, 4, 32, 4, 4),     # K*F = 436 > 432
                  (1, 3, 5, 385, 2, 2, 32, 4, 4)):    # K*F = 770 > 768
        with pytest.raises(ValueError):
            kfe._check(*_operands(*shape))
