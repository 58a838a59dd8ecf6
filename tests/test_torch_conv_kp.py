"""The kernel-point (kp) convs against the JAX package.

The JAX package runs each standard kp conv through its Pallas kernels
(``se3conv3d_tpu/ops/pne_conv.py:fused_kp_conv``: the correlation weights
of ``_kp_geo_chunk`` as the kernel's geometry rows, ``act='linear'``); the
port computes the weights inside its CUDA kernels from the float32 raw
offsets (``ops.pne_conv.fused_kp_conv``; the kernels' plain versions run
here).  On the numpy inputs of ``tests/test_torch_conv_acts.py``'s standard
case (masked tails, a valid query row with no valid edge), for gauss,
linear and box at P = 13 and P = 55 (``_double``):

* the kernel points and sigma equal the JAX package's;
* the weights (``kernels.fused_equiv.kp_weights``) against
  ``_kp_geo_chunk`` on every edge: gauss and linear within 1e-6, box's
  one-hot the same on every edge (the count of edges that differ is 0);
* the forward against JAX's at atol 2e-4 / rtol 5e-5, its four gradients
  (both feature-gradient modes against JAX's scatter mode) at atol 5e-4 /
  rtol 5e-3; the same in bfloat16 (the weights from float32 offsets,
  rounded) against JAX bf16 (max 1e-2, mean 1e-3 of max |JAX bf16|, the
  mean at most half that against JAX float32);
* the plain versions against a float64 numpy oracle of the weights, the
  projection and the conv, within 1e-5 of each output's largest value.

The JAX reference runs as ``test_torch_conv_acts.jax_reference`` sets it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_conv_acts as acts
from torch_port_helpers import t, to_torch_cloud

from se3conv3d_tpu.nn.conv import _kernel_points as jkernel_points
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.nn.conv import _kernel_points
from se3conv3d_tpu_torch.ops import pne_conv as ops

torch.set_num_threads(2)

KP_TYPES = ("kp_gauss", "kp_linear", "kp_box", "kp_gauss_double", "kp_linear_double", "kp_box_double")
ND, NN = 1.5, 0.11
LEAVES = acts.LEAVES


def _corr(pne_type):
    return "gauss" if "gauss" in pne_type else "box" if "box" in pne_type else "linear"


@functools.lru_cache(maxsize=None)
def kp_case(pne_type):
    """The standard case's clouds, neighborhood and features, the kernel
    points of ``pne_type`` and parameters with ``proj_axes [P, Q]``."""
    pc_in, pc_out, neigh, feats = acts.case("standard")[:4]
    points, sigma = jkernel_points(pne_type)
    rng = np.random.default_rng(70 + KP_TYPES.index(pne_type))
    pa = (rng.normal(size=(points.shape[0], acts.Q)) * 0.3).astype(np.float32)
    pb = (rng.normal(size=(acts.Q,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(acts.C, acts.Q, acts.O)) * 0.1).astype(np.float32)
    return pc_in, pc_out, neigh, feats, pa, pb, w, np.asarray(points), sigma


def port_kp_conv(pne_type, params, cdt=None):
    pc_in, pc_out, neigh = kp_case(pne_type)[:3]
    points, sigma = _kernel_points(pne_type)
    return ops.fused_kp_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), acts.port_neigh(neigh),
                             params[0], points, sigma, _corr(pne_type), *params[1:],
                             torch.tensor(ND), torch.tensor(NN), compute_dtype=cdt)


def _jax_kp(pne_type, params, cdt):
    pc_in, pc_out, neigh = kp_case(pne_type)[:3]
    points, sigma = kp_case(pne_type)[7:]
    return jops.fused_kp_conv(pc_in, pc_out, neigh, params[0], jnp.asarray(points), sigma, _corr(pne_type),
                              *params[1:], jnp.asarray(ND), jnp.asarray(NN), tile_m=acts.TILE,
                              compute_dtype=cdt)


@functools.lru_cache(maxsize=None)
def jax_out(pne_type, cdt=None):
    with acts.jax_reference():
        return np.asarray(_jax_kp(pne_type, [jnp.asarray(x) for x in kp_case(pne_type)[3:7]], cdt))


@functools.lru_cache(maxsize=None)
def jax_grads(pne_type, cdt, mode):
    def jloss(params):
        out = _jax_kp(pne_type, params, cdt)
        return jnp.sum(out * jnp.cos(out))

    with acts.jax_reference(mode):
        return tuple(np.asarray(x) for x in jax.grad(jloss)(
            tuple(jnp.asarray(x) for x in kp_case(pne_type)[3:7])))


def port_grads(pne_type, cdt, mode, monkeypatch):
    monkeypatch.setattr(ops, "BWD_SCATTER_MODE", mode)
    params = [t(x).requires_grad_() for x in kp_case(pne_type)[3:7]]
    out = port_kp_conv(pne_type, params, cdt)
    (out * torch.cos(out)).sum().backward()
    return [p.grad for p in params]


@pytest.mark.parametrize("pne_type", KP_TYPES)
def test_kernel_points_and_weights_match_jax(pne_type):
    """The port's kernel points and sigma are JAX's (float32, bitwise); its
    weights are ``_kp_geo_chunk``'s on every edge of the case: gauss and
    linear within 1e-6, and no edge whose box one-hot differs."""
    pc_in, pc_out, neigh = kp_case(pne_type)[:3]
    points, sigma = _kernel_points(pne_type)
    want_points, want_sigma = kp_case(pne_type)[7:]
    np.testing.assert_array_equal(points.numpy(), want_points)
    assert points.dtype == torch.float32 and sigma == want_sigma
    b, m, k = neigh.idx.shape
    gp = jax.vmap(lambda v, i: v[i])(pc_in.positions, neigh.idx)
    want = np.asarray(jops._kp_geo_chunk(gp, pc_out.positions, jnp.asarray(want_points), sigma,
                                         _corr(pne_type), jnp.asarray(ND), jnp.float32))
    want = want[:, :-1].reshape(b, points.shape[0], m, k).transpose(0, 2, 3, 1)
    rel = ops.std_geometry(to_torch_cloud(pc_in), to_torch_cloud(pc_out), acts.port_neigh(neigh))
    got = kfe.kp_weights(rel, kfe.KernelPoints(points, sigma, _corr(pne_type), torch.tensor(ND)))[:, :, :, 0]
    assert got.shape == want.shape
    if _corr(pne_type) == "box":
        differ = int((got.numpy() != want).any(-1).sum())
        assert differ == 0 and (got.sum(-1) == 1).all(), differ
    else:
        assert want.max() > 0.5 and (want > 0).sum() > 100  # non-trivial weights
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pne_type", KP_TYPES)
def test_kp_conv_forward_matches_jax_fused(pne_type, dtype):
    """The forward against JAX's ``fused_kp_conv``; rows with no valid edge
    give zero; CPU tensors launch no kernel."""
    cdt = torch.bfloat16 if dtype == "bfloat16" else None
    before = kfe.fused_equiv_fwd.launches
    with torch.no_grad():
        got = port_kp_conv(pne_type, [t(x) for x in kp_case(pne_type)[3:7]], cdt).numpy()
    assert kfe.fused_equiv_fwd.launches == before
    assert not got[~np.asarray(kp_case(pne_type)[2].mask).any(-1)].any()
    want = jax_out(pne_type)
    assert np.abs(want).max() > 0.1
    if cdt is None:
        np.testing.assert_allclose(got, want, atol=acts.ATOL, rtol=acts.RTOL)
    else:
        acts.hold_bf16(got, jax_out(pne_type, jnp.bfloat16), want, pne_type)


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
@pytest.mark.parametrize("pne_type", KP_TYPES)
def test_kp_conv_gradients_match_jax_pallas_backward(pne_type, mode, monkeypatch):
    """The four gradients (``proj_axes [P, Q]``), both feature-gradient
    modes, against ``jax.grad`` through JAX's kp conv (scatter mode)."""
    want = jax_grads(pne_type, None, "scatter")
    for g, ref, leaf in zip(port_grads(pne_type, None, mode, monkeypatch), want, LEAVES):
        assert np.abs(ref).max() > 0, leaf
        np.testing.assert_allclose(g.numpy(), ref, atol=acts.GRAD_ATOL, rtol=acts.GRAD_RTOL, err_msg=leaf)


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
@pytest.mark.parametrize("pne_type", KP_TYPES)
def test_bf16_kp_conv_gradients_match_jax_fused_bf16(pne_type, mode, monkeypatch):
    """The bfloat16 gradients against JAX bf16 in the same mode, apart from
    JAX float32 (the control)."""
    want_bf16, want_f32 = jax_grads(pne_type, jnp.bfloat16, mode), jax_grads(pne_type, None, "scatter")
    grads = port_grads(pne_type, torch.bfloat16, mode, monkeypatch)
    assert torch.equal(grads[0], grads[0].to(torch.bfloat16).float())
    for g, wb, wf, leaf in zip(grads, want_bf16, want_f32, LEAVES):
        acts.hold_bf16(g.numpy(), wb, wf, f"{pne_type} {mode} {leaf}")


@pytest.mark.parametrize("pne_type", KP_TYPES)
def test_kp_plain_versions_match_a_float64_oracle(pne_type):
    """``fused_equiv_fwd_reference`` / ``fused_equiv_bwd_reference`` in the
    kernel-point geometry against the same function in float64 numpy (the
    weights from the float32 offsets, the box one-hot by float64 argmin)."""
    rng = np.random.default_rng(80 + KP_TYPES.index(pne_type))
    points, sigma = _kernel_points(pne_type)
    p, q, c, o = points.shape[0], acts.Q, acts.C, acts.O
    b, m, n, k = 2, 30, 40, 6
    rel = (rng.normal(size=(b, m, k, 1, 3)) * 0.4).astype(np.float32)
    feats = rng.normal(size=(b, n, 1, c)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, m, k))
    mask = rng.uniform(size=(b, m, k)) < 0.7
    mask[:, -4:] = False
    pa, pb = (rng.normal(size=(p, q)) * 0.3).astype(np.float32), (rng.normal(size=(q,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(c, q, o)) * 0.1).astype(np.float32)
    gout = rng.normal(size=(b, m, 1, o)).astype(np.float32)
    nd = np.float32(1.3)

    r = rel.astype(np.float64) * float(nd)
    d2 = ((r[..., None, :] - points.double().numpy()) ** 2).sum(-1) / sigma ** 2  # [b,m,k,1,p]
    corr = _corr(pne_type)
    if corr == "gauss":
        geo = np.exp(-d2 / 2)
    elif corr == "linear":
        geo = np.maximum(1 - np.sqrt(d2), 0)
    else:
        geo = np.eye(p)[d2.argmin(-1)]
    geo = geo[:, :, :, :, None, :]  # [b,m,k,1,1,p]
    pne = (geo @ pa + pb) * mask[:, :, :, None, None, None]
    gathered = feats.astype(np.float64)[np.arange(b)[:, None, None], idx]
    basis = np.einsum("bmkfc,bmkgfq->bmgcq", gathered, pne)
    want_out = np.einsum("bmgcq,cqo->bmgo", basis, w)
    dbasis = np.einsum("bmgo,cqo->bmgcq", gout, w)
    d_feats = np.zeros(feats.shape)
    np.add.at(d_feats, (np.arange(b)[:, None, None], idx), np.einsum("bmkgfq,bmgcq->bmkfc", pne, dbasis))
    dpre = np.einsum("bmkfc,bmgcq->bmkgfq", gathered * mask[..., None, None], dbasis)
    want = (want_out, d_feats, np.einsum("bmkgfq,bmkgfd->dq", dpre, geo), dpre.sum((0, 1, 2, 3, 4)),
            np.einsum("bmgcq,bmgo->cqo", basis, gout))

    kp = kfe.KernelPoints(points, sigma, corr, torch.tensor(nd))
    args = (torch.from_numpy(rel), None, torch.from_numpy(feats), torch.from_numpy(idx),
            torch.from_numpy(mask), torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(w))
    got = (kfe.fused_equiv_fwd_reference(*args, act="linear", kp=kp),
           *kfe.fused_equiv_bwd_reference(*args, torch.from_numpy(gout), act="linear", kp=kp))
    assert tuple(got[2].shape) == (p, q)
    for what, x, y in zip(("out",) + LEAVES, got, want):
        np.testing.assert_allclose(x.double().numpy(), y, rtol=0, atol=1e-5 * np.abs(y).max(),
                                   err_msg=f"{pne_type} {what}")
