"""The conv kernels' activations (relu, sin, linear) against the JAX package.

The JAX package runs every mlp activation but softmax through its Pallas
kernels (``se3conv3d_tpu/ops/pallas/fused_equiv.py:_ACTS``,
``_act_and_grad``); the port runs them through its CUDA kernels, whose
plain versions run here.  On the same numpy inputs (a masked tail in both
clouds, and one valid query point far from every source, so it has no valid
edge), for the equivariant geometry (6D, G = F = 2) and the standard one:

* ``ops.pne_conv.fused_equiv_conv`` / ``fused_conv`` with ``act`` against
  the JAX functions of the same name with the Pallas kernels in interpret
  mode (``FUSED_INTERPRET``): the forward at atol 2e-4 / rtol 5e-5, its
  four gradients (``feats``, ``proj_axes``, ``proj_biases``,
  ``conv_weights``; both feature-gradient modes against JAX's scatter mode)
  at atol 5e-4 / rtol 5e-3 (``tests/test_torch_standard.py``'s bounds);
* the same in bfloat16 against JAX's ``compute_dtype=bfloat16``: max error
  1e-2 and mean error 1e-3 of max |JAX bf16|, and the mean error at most
  half that against JAX float32 (``tests/test_torch_bf16.py``'s bounds);
* the kernels' plain versions against a float64 numpy oracle of each
  activation and its closed-form derivative (relu's a step with 0 at 0),
  float32 within 1e-5 of the largest value.

XLA on the CPU cannot run the ``BF16 x BF16 = F32`` dot into which it folds
JAX's identity activation (``tests/test_fused_kp.py`` notes the same), so
the JAX reference runs the identity behind ``jax.lax.optimization_barrier``
(:func:`jax_reference`): the same function, computed by the same kernel.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

K, Q, C, O = 8, 16, 12, 10
ND, NN = 3.0, 0.11
TILE = 32
ACTS = ("relu", "sin", "linear")
LEAVES = ("feats", "proj_axes", "proj_biases", "conv_weights")
ATOL, RTOL = 2e-4, 5e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
MAX_RTOL, MEAN_RTOL = 1e-2, 1e-3
# geometry: (frames per point, numpy seed)
GEOMETRIES = {"equivariant": (2, 50), "standard": (0, 51)}


@functools.lru_cache(maxsize=None)
def case(geometry):
    """Source cloud of 96 points and query cloud of 70 (masked tails; query
    point 5 moved far from every source: no valid edge), random frames for
    the equivariant geometry, a ball-query neighborhood, features and
    parameters (numpy seed)."""
    f, seed = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)

    def cloud(n, tail, key):
        pts = rng.uniform(size=(2, n, 3)).astype(np.float32) * 2.0
        mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
        if n == 70:
            pts[0, 5] = 10.0
        frames = jrandom_frames(key, 2, n, f) if f else None
        return JCloud(jnp.asarray(pts), jnp.asarray(mask), frames)

    pc_in = cloud(96, (0, 7), jax.random.PRNGKey(seed))
    pc_out = cloud(70, (9, 0), jax.random.PRNGKey(seed + 1))
    neigh = jax.jit(jball, static_argnums=(2, 3))(pc_in, pc_out, 0.5, K)
    assert not np.asarray(neigh.mask)[0, 5].any() and np.asarray(neigh.query_mask)[0, 5]
    feats = rng.normal(size=(2, 96, f, C) if f else (2, 96, C)).astype(np.float32)
    pa = (rng.normal(size=(9 if f else 3, Q)) * 0.3).astype(np.float32)
    pb = (rng.normal(size=(Q,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(C, Q, O)) * 0.1).astype(np.float32)
    return pc_in, pc_out, neigh, feats, pa, pb, w


@contextlib.contextmanager
def jax_reference(mode="scatter"):
    """The JAX package's fused path as the tests run it on the CPU: the
    Pallas kernels in interpret mode, feature-gradient mode ``mode``, and
    the identity activation behind an optimization barrier (the module
    note); everything restored after."""
    saved = fe.FUSED_INTERPRET, jops.BWD_SCATTER_MODE, fe._ACTS["linear"]
    fe.FUSED_INTERPRET, jops.BWD_SCATTER_MODE = True, mode
    fe._ACTS["linear"] = jax.lax.optimization_barrier
    try:
        yield
    finally:
        fe.FUSED_INTERPRET, jops.BWD_SCATTER_MODE, fe._ACTS["linear"] = saved


def port_neigh(neigh):
    return Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.5)


def port_conv(geometry, act, params, cdt=None):
    pc_in, pc_out, neigh = case(geometry)[:3]
    conv = ops.fused_equiv_conv if geometry == "equivariant" else ops.fused_conv
    return conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), port_neigh(neigh), *params,
                torch.tensor(ND), torch.tensor(NN), compute_dtype=cdt, act=act)


def _jax_conv(geometry):
    return jops.fused_equiv_conv if geometry == "equivariant" else jops.fused_conv


@functools.lru_cache(maxsize=None)
def jax_out(geometry, act, cdt=None):
    pc_in, pc_out, neigh, feats, pa, pb, w = case(geometry)
    with jax_reference():
        return np.asarray(_jax_conv(geometry)(
            pc_in, pc_out, neigh, *(jnp.asarray(x) for x in (feats, pa, pb, w)), jnp.asarray(ND),
            jnp.asarray(NN), act=act, tile_m=TILE, compute_dtype=cdt))


@functools.lru_cache(maxsize=None)
def jax_grads(geometry, act, cdt, mode):
    """Gradients of ``sum(out * cos(out))`` through the lean VJP (the Pallas
    backward in interpret mode) in feature-gradient mode ``mode``."""
    pc_in, pc_out, neigh, feats, pa, pb, w = case(geometry)

    def jloss(params):
        out = _jax_conv(geometry)(pc_in, pc_out, neigh, *params, jnp.asarray(ND), jnp.asarray(NN),
                                  act=act, tile_m=TILE, compute_dtype=cdt, lean_vjp=True)
        return jnp.sum(out * jnp.cos(out))

    with jax_reference(mode):
        return tuple(np.asarray(x) for x in jax.grad(jloss)(
            tuple(jnp.asarray(x) for x in (feats, pa, pb, w))))


def hold_bf16(got, want_bf16, want_f32, what):
    """The bf16 bounds and their float32 control (tests/test_torch_bf16.py)."""
    scale = np.abs(want_bf16).max()
    assert scale > 0, what
    err = np.abs(got - want_bf16)
    assert err.max() <= MAX_RTOL * scale, (what, err.max(), scale)
    assert err.mean() <= MEAN_RTOL * scale, (what, err.mean(), scale)
    assert err.mean() <= 0.5 * np.abs(got - want_f32).mean(), (what, err.mean(),
                                                               np.abs(got - want_f32).mean())


def port_grads(geometry, act, cdt, mode, monkeypatch):
    monkeypatch.setattr(ops, "BWD_SCATTER_MODE", mode)
    params = [t(x).requires_grad_() for x in case(geometry)[3:]]
    out = port_conv(geometry, act, params, cdt)
    (out * torch.cos(out)).sum().backward()
    return [p.grad for p in params]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_activation_conv_forward_matches_jax_fused(geometry, act, dtype):
    """The forward of each activation against JAX's Pallas kernel; rows
    with no valid edge give zero; CPU tensors launch no kernel."""
    cdt = torch.bfloat16 if dtype == "bfloat16" else None
    before = kfe.fused_equiv_fwd.launches
    with torch.no_grad():
        got = port_conv(geometry, act, [t(x) for x in case(geometry)[3:]], cdt).numpy()
    assert kfe.fused_equiv_fwd.launches == before
    neigh = case(geometry)[2]
    assert not got[~np.asarray(neigh.mask).any(-1)].any()
    want = jax_out(geometry, act)
    assert np.abs(want).max() > 0.1
    if cdt is None:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        hold_bf16(got, jax_out(geometry, act, jnp.bfloat16), want, f"{geometry} {act}")


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_activation_conv_gradients_match_jax_pallas_backward(geometry, act, mode, monkeypatch):
    """The four gradients of each activation, both feature-gradient modes,
    against ``jax.grad`` through the Pallas backward (scatter mode)."""
    want = jax_grads(geometry, act, None, "scatter")
    for g, ref, leaf in zip(port_grads(geometry, act, None, mode, monkeypatch), want, LEAVES):
        assert np.abs(ref).max() > 0, leaf
        np.testing.assert_allclose(g.numpy(), ref, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=leaf)


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_bf16_activation_conv_gradients_match_jax_fused_bf16(geometry, act, mode, monkeypatch):
    """The bfloat16 gradients against JAX bf16 in the same mode, apart from
    JAX float32 (the control); the feature gradient rounded to bfloat16."""
    want_bf16, want_f32 = jax_grads(geometry, act, jnp.bfloat16, mode), jax_grads(geometry, act, None,
                                                                                  "scatter")
    grads = port_grads(geometry, act, torch.bfloat16, mode, monkeypatch)
    assert torch.equal(grads[0], grads[0].to(torch.bfloat16).float())
    for g, wb, wf, leaf in zip(grads, want_bf16, want_f32, LEAVES):
        hold_bf16(g.numpy(), wb, wf, f"{geometry} {act} {mode} {leaf}")


def _act64(act, x):
    return {"relu": np.maximum(x, 0.0), "sin": np.sin(x), "linear": x}[act]


def _dact64(act, x):
    return {"relu": (x > 0).astype(np.float64), "sin": np.cos(x), "linear": np.ones_like(x)}[act]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_activation_plain_versions_match_a_float64_oracle(geometry, act):
    """``fused_equiv_fwd_reference`` / ``fused_equiv_bwd_reference`` with
    ``act`` against the same function in float64 numpy; the bias is tilted
    so that some pre-activations sit exactly at 0 (relu's step takes 0
    there)."""
    g = 2 if geometry == "equivariant" else 1
    d = 9 if g == 2 else 3
    rng = np.random.default_rng(60 + g)
    b, m, n, k = 2, 30, 40, 6
    rel = rng.normal(size=(b, m, k, g, 3)) * 0.5
    rot6 = rng.normal(size=(b, m, k, g, g, 6)) * 0.5 if g == 2 else None
    feats = rng.normal(size=(b, n, g, C))
    idx = rng.integers(0, n, size=(b, m, k))
    mask = rng.uniform(size=(b, m, k)) < 0.7
    mask[:, -4:] = False
    pa, pb = rng.normal(size=(d, Q)) * 0.3, rng.normal(size=(Q,)) * 0.1
    pa[:, 0], pb[0] = 0.0, 0.0  # pre = 0 in column 0
    w, gout = rng.normal(size=(C, Q, O)) * 0.1, rng.normal(size=(b, m, g, O))
    rel, rot6, feats, pa, pb, w, gout = (None if x is None else x.astype(np.float32).astype(np.float64)
                                         for x in (rel, rot6, feats, pa, pb, w, gout))

    geo = np.broadcast_to(rel[:, :, :, :, None, :], (b, m, k, g, g, 3))
    if rot6 is not None:
        geo = np.concatenate([geo, rot6], -1)
    pre = geo @ pa + pb
    pne = _act64(act, pre) * mask[:, :, :, None, None, None]
    gathered = feats[np.arange(b)[:, None, None], idx]
    basis = np.einsum("bmkfc,bmkgfq->bmgcq", gathered, pne)
    want_out = np.einsum("bmgcq,cqo->bmgo", basis, w)
    dbasis = np.einsum("bmgo,cqo->bmgcq", gout, w)
    d_gath = np.einsum("bmkgfq,bmgcq->bmkfc", pne, dbasis)
    d_feats = np.zeros_like(feats)
    np.add.at(d_feats, (np.arange(b)[:, None, None], idx), d_gath)
    dpre = np.einsum("bmkfc,bmgcq->bmkgfq", gathered * mask[..., None, None], dbasis) * _dact64(act, pre)
    want = (want_out, d_feats, np.einsum("bmkgfq,bmkgfd->dq", dpre, geo), dpre.sum((0, 1, 2, 3, 4)),
            np.einsum("bmgcq,bmgo->cqo", basis, gout))

    def f32(x):
        return None if x is None else torch.from_numpy(np.asarray(x, np.float32))

    args = (f32(rel), f32(rot6), f32(feats), torch.from_numpy(idx), torch.from_numpy(mask),
            f32(pa), f32(pb), f32(w))
    got = (kfe.fused_equiv_fwd_reference(*args, act=act),
           *kfe.fused_equiv_bwd_reference(*args, f32(gout), act=act))
    for what, x, y in zip(("out",) + LEAVES, got, want):
        np.testing.assert_allclose(x.double().numpy(), y, rtol=0, atol=1e-5 * np.abs(y).max(),
                                   err_msg=f"{geometry} {act} {what}")
