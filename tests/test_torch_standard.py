"""The port's standard (non-equivariant) conv and models against the JAX package.

The standard conv is the fused kernels' standard geometry: G = F = 1 and the
3 raw edge offsets as the pne inputs (``ops.pne_conv.fused_conv``, the
kernels' ``kD = 3`` instantiations on the card, their plain versions here).
On the same numpy inputs:

* the conv forward against ``se3conv3d_tpu.ops.pne_conv.fused_conv`` (the
  Pallas kernel in interpret mode, as ``tests/test_fused_equiv.py`` runs
  it) and against the XLA path (``PNEConv(use_fused=False)``), at atol
  2e-4 / rtol 5e-5, on ragged, masked-tail cases;
* its four gradients against ``jax.grad`` through the Pallas backward in
  interpret mode (atol 5e-4, rtol 5e-3, ``tests/test_fused_equiv.py``'s
  gradient bounds), and the plain versions against a float64 ``gradcheck``;
* the bfloat16 conv against JAX ``fused_conv(compute_dtype=bfloat16)`` at
  ``tests/test_torch_bf16.py``'s bounds, with its float32 control;
* a tiny FPNSegUNetMLPGeluFAUST (weights carried over by ``from_flax``):
  calibration, logits within 2e-4, and one train-mode step (loss and
  per-leaf parameter gradients, injected DropPath masks) against JAX's
  trainer; the standard model has no frame axis, so JAX's BN row count is
  the reference's;
* a tiny FPNSegUNetMLPGeluScanNet's bfloat16 logits against JAX's fused
  bf16 path;
* the hierarchy without frames, the three pinned standard recipes against
  their YAML, and ``build_model_from_config`` on each.
"""
import dataclasses
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_scannet as scannet
from torch_port_helpers import (HCFG, NUM_CLASSES, TINY, capture_grads, droppath_interceptor,
                                flat_tree, jax_hierarchy_draws, pop_keep_masks, randomize, t,
                                tiny_batch, to_torch_cloud, to_torch_hierarchy)

import se3conv3d_tpu.ops.pallas.fused_equiv as fe
from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.core.neighborhoods import ball_query_neighborhood as jball
from se3conv3d_tpu.core.neighborhoods import knn_neighborhood as jknn
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.nn.conv import PNEConv as JPNEConv
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu.train.trainer import TrainSettings, TrainState
from se3conv3d_tpu_torch.core import hierarchy as thier
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec, presets
from se3conv3d_tpu_torch.models.spec import NeighborhoodProvider
from se3conv3d_tpu_torch.nn.conv import PNEConv
from se3conv3d_tpu_torch.ops import pne_conv as ops
from se3conv3d_tpu_torch.train import config, schedule
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-4, 5e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
# bfloat16 against JAX bf16 (tests/test_torch_bf16.py): max and mean error
# relative to max |JAX|, and at most half the error against JAX float32
MAX_RTOL, MEAN_RTOL = 1e-2, 1e-3
# whole train step, per gradient leaf (tests/test_torch_train.py)
STEP_GRAD_TOL, GRAD_FLOOR, BN_RTOL = 1e-4, 1e-2, 1e-5
K, Q, C, O = 8, 16, 24, 20
ND, NN = 3.0, 0.11
LEAVES = ("feats", "proj_axes", "proj_biases", "conv_weights")
CASES = {
    # name: (seed, M_out, masked query tail, neighborhood, Pallas tile_m)
    "self_ball": (0, 96, 0, "ball", 32),
    "ragged_m_masked_tail": (1, 70, 9, "ball", 64),
    "knn_masked_tail": (2, 50, 6, "knn", 32),
}


def _cloud(rng, b, n, tail):
    pts = rng.uniform(size=(b, n, 3)).astype(np.float32) * 2.0
    mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
    return JCloud(jnp.asarray(pts), jnp.asarray(mask))


@functools.lru_cache(maxsize=None)
def _case(name):
    """Source cloud of 96 points (masked tail), query cloud of ``M_out``
    points (masked tail), ball-query or kNN neighborhood, features ``[B,
    N, C]`` and parameters (numpy seed)."""
    seed, m_out, q_tail, kind, _ = CASES[name]
    rng = np.random.default_rng(seed)
    pc_in = _cloud(rng, 2, 96, (0, 7))
    pc_out = _cloud(rng, 2, m_out, (q_tail, 0))
    neigh = jball(pc_in, pc_out, 0.5, K) if kind == "ball" else jknn(pc_in, pc_out, K)
    feats = rng.normal(size=(2, 96, C)).astype(np.float32)
    pa = (rng.normal(size=(3, Q)) * 0.3).astype(np.float32)
    pb = (rng.normal(size=(Q,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(C, Q, O)) * 0.1).astype(np.float32)
    return pc_in, pc_out, neigh, feats, pa, pb, w


def _port_neigh(neigh):
    return Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), neigh.method, neigh.radius)


def _port_conv(name, params, compute_dtype=None):
    pc_in, pc_out, neigh = _case(name)[:3]
    return ops.fused_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), _port_neigh(neigh), *params,
                          torch.tensor(ND), torch.tensor(NN), compute_dtype=compute_dtype)


def _jax_out(name, cdt=None):
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(name)
    return np.asarray(jops.fused_conv(
        pc_in, pc_out, neigh, *(jnp.asarray(x) for x in (feats, pa, pb, w)), jnp.asarray(ND),
        jnp.asarray(NN), tile_m=CASES[name][4], compute_dtype=cdt))


@functools.lru_cache(maxsize=None)
def _jax_grads(name, cdt, mode):
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(name)
    saved = jops.BWD_SCATTER_MODE
    jops.BWD_SCATTER_MODE = mode
    try:
        def jloss(params):
            out = jops.fused_conv(pc_in, pc_out, neigh, *params, jnp.asarray(ND), jnp.asarray(NN),
                                  tile_m=CASES[name][4], compute_dtype=cdt, lean_vjp=True)
            return jnp.sum(out * jnp.cos(out))

        return tuple(np.asarray(x) for x in jax.grad(jloss)(
            tuple(jnp.asarray(x) for x in (feats, pa, pb, w))))
    finally:
        jops.BWD_SCATTER_MODE = saved


# --- the conv -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_conv_matches_jax_pallas_and_xla_paths(name, monkeypatch):
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    pc_in, pc_out, neigh, feats, pa, pb, w = _case(name)
    jconv = JPNEConv(C, O, Q, "mlp_gelu", equivariant=False, use_fused=False)
    calib = {"norm_neigh_dist": jnp.asarray(ND), "norm_num_neighs": jnp.asarray(NN),
             "initialized": jnp.asarray(True), "trunc_frac": jnp.zeros(())}
    xla = np.asarray(jconv.apply(
        {"params": {"proj_axes": jnp.asarray(pa), "proj_biases": jnp.asarray(pb),
                    "conv_weights": jnp.asarray(w)}, "calib": calib},
        pc_in, pc_out, jnp.asarray(feats), neigh))
    pallas = _jax_out(name)
    before = kfe.fused_equiv_fwd.launches
    with torch.no_grad():
        got = _port_conv(name, [t(x) for x in (feats, pa, pb, w)]).numpy()
    assert kfe.fused_equiv_fwd.launches == before  # CPU tensors launch no kernel
    assert got.shape == (2, CASES[name][1], O)
    assert np.abs(xla).max() > 0.1
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, xla, atol=ATOL, rtol=RTOL)
    # the masked query rows have no valid edge: zero output
    assert not got[~np.asarray(neigh.mask).any(-1)].any()


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
@pytest.mark.parametrize("name", ["self_ball", "ragged_m_masked_tail"])
def test_fused_conv_gradients_match_jax_pallas_backward(name, mode, monkeypatch):
    """Gradients of ``sum(out * cos(out))`` to the features, ``proj_axes``
    (through the ``norm_dist`` fold on all three rows), ``proj_biases`` and
    ``conv_weights``, in both feature-gradient modes, against ``jax.grad``
    through the lean VJP (the Pallas ``_bwd_kernel`` in interpret mode); the
    calibration buffers get none."""
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    monkeypatch.setattr(ops, "BWD_SCATTER_MODE", mode)
    want = _jax_grads(name, None, "scatter")
    params = [t(x).requires_grad_() for x in _case(name)[3:]]
    pc_in, pc_out, neigh = _case(name)[:3]
    nd, nn_ = torch.tensor(ND), torch.tensor(NN)
    out = ops.fused_conv(to_torch_cloud(pc_in), to_torch_cloud(pc_out), _port_neigh(neigh), *params,
                         nd, nn_)
    (out * torch.cos(out)).sum().backward()
    assert nd.grad is None and nn_.grad is None
    for p, ref, leaf in zip(params, want, LEAVES):
        assert np.abs(ref).max() > 0, leaf
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=leaf)


def test_standard_kernel_function_gradcheck_float64():
    """``torch.autograd.gradcheck`` of the differentiable op's plain path at
    the standard geometry (``rot6`` None, D = 3) in float64, with masked and
    repeated neighbors (the scatter feature gradient: the prefix sum of the
    'sorted' one takes float32 or bfloat16 rows); its residuals are its
    inputs."""
    gen = torch.Generator().manual_seed(0)
    b, m, n, k, q, c, o = 2, 5, 7, 4, 3, 3, 4

    def rnd(*s):
        return torch.randn(*s, generator=gen, dtype=torch.float64)

    idx = torch.randint(0, n, (b, m, k), generator=gen)
    mask = torch.rand(b, m, k, generator=gen) < 0.7
    mask[1, -1] = False
    rel = rnd(b, m, k, 1, 3)
    feats, pa, pb, w = (x.requires_grad_() for x in (rnd(b, n, 1, c), rnd(3, q), rnd(q), rnd(c, q, o)))
    args = (rel, None, feats, idx, mask, pa, pb, w)
    assert torch.autograd.gradcheck(kfe.fused_equiv, args)
    saved = kfe.fused_equiv(*args).grad_fn.saved_tensors
    assert len(saved) == len(args) and saved[1] is None
    for s, a in zip(saved, args):
        assert a is None or s.data_ptr() == a.data_ptr()


def test_standard_geometry_contract_and_cpu_dispatch():
    """The wrappers' checks take the standard shapes (D = 3 from
    ``proj_axes``, G = F = 1, Q <= 64) and reject the equivariant ones
    without ``rot6``; CPU tensors run the plain versions and count no
    launch."""
    pc_in, pc_out, neigh, feats, pa, pb, w = _case("ragged_m_masked_tail")
    tn = _port_neigh(neigh)
    rel = ops.std_geometry(to_torch_cloud(pc_in), to_torch_cloud(pc_out), tn)
    assert tuple(rel.shape) == (2, 70, K, 1, 3) and rel.dtype == torch.float32
    want_rel = np.asarray(pc_in.positions)[np.arange(2)[:, None, None], np.asarray(neigh.idx)] \
        - np.asarray(pc_out.positions)[:, :, None]
    np.testing.assert_array_equal(rel[:, :, :, 0].numpy(), want_rel)
    args = [rel, None, t(feats)[:, :, None], tn.idx, tn.mask, t(pa), t(pb), t(w)]
    assert kfe._check(*args)[-1] == 3
    assert kfe._check(*args)[4:6] == (1, 1)
    with pytest.raises(ValueError, match="proj_axes"):
        kfe._check(*args[:5], torch.zeros(9, Q), *args[6:])
    with pytest.raises(ValueError, match="proj_axes"):  # the equivariant conv takes 9 rows
        kfe._check(args[0], torch.zeros(2, 70, K, 1, 1, 6), *args[2:])
    with pytest.raises(ValueError, match="standard geometry"):  # Q > 64
        kfe._check(*args[:5], torch.zeros(3, 65), torch.zeros(65), torch.zeros(C, 65, O))
    with pytest.raises(ValueError, match="standard geometry"):  # G = 2
        kfe._check(rel.expand(-1, -1, -1, 2, -1).contiguous(), *args[1:])
    gout = torch.randn(2, 70, 1, O, generator=torch.Generator().manual_seed(1))
    before = dict(kfe.fused_equiv_fwd.launches_by_d), dict(kfe.fused_equiv_bwd.launches_by_d)
    np.testing.assert_array_equal(kfe.fused_equiv_fwd(*args).numpy(),
                                  kfe.fused_equiv_fwd_reference(*args).numpy())
    got, ref = kfe.fused_equiv_bwd(*args, gout), kfe.fused_equiv_bwd_reference(*args, gout)
    assert tuple(got[1].shape) == (3, Q)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (kfe.fused_equiv_fwd.launches_by_d, kfe.fused_equiv_bwd.launches_by_d) == before


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_fused_conv_matches_jax_fused_bf16(name, monkeypatch):
    """The bfloat16 standard conv (raw offsets rounded to bfloat16 once,
    before the ``norm_dist`` scale in the projection; features rounded
    before the gather) against JAX's fused bf16 path, and apart from JAX's
    float32 path, the control."""
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    with torch.no_grad():
        got = _port_conv(name, [t(x) for x in _case(name)[3:]], torch.bfloat16)
    assert got.dtype == torch.float32 and got.shape == (2, CASES[name][1], O)
    _hold(got.numpy(), _jax_out(name, jnp.bfloat16), _jax_out(name), name)


@pytest.mark.parametrize("mode", ["scatter", "sorted"])
def test_bf16_fused_conv_gradients_match_jax_pallas_backward(mode, monkeypatch):
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    monkeypatch.setattr(ops, "BWD_SCATTER_MODE", mode)
    name = "ragged_m_masked_tail"
    want_bf16, want_f32 = _jax_grads(name, jnp.bfloat16, mode), _jax_grads(name, None, "scatter")
    params = [t(x).requires_grad_() for x in _case(name)[3:]]
    out = _port_conv(name, params, torch.bfloat16)
    (out * torch.cos(out)).sum().backward()
    d_feats = params[0].grad
    assert torch.equal(d_feats, d_feats.to(torch.bfloat16).float())  # rounded to bfloat16
    for p, wb, wf, leaf in zip(params, want_bf16, want_f32, LEAVES):
        _hold(p.grad.numpy(), wb, wf, f"{mode} {leaf}")


def _hold(got, want_bf16, want_f32, what):
    """The bf16 bounds and their float32 control (tests/test_torch_bf16.py)."""
    scale = np.abs(want_bf16).max()
    assert scale > 0, what
    err = np.abs(got - want_bf16)
    assert err.max() <= MAX_RTOL * scale, (what, err.max(), scale)
    assert err.mean() <= MEAN_RTOL * scale, (what, err.mean(), scale)
    assert err.mean() <= 0.5 * np.abs(got - want_f32).mean(), (what, err.mean(),
                                                               np.abs(got - want_f32).mean())


# --- the hierarchy without frames -------------------------------------------------


def test_hierarchy_without_frames_matches_jax(monkeypatch):
    """A standard recipe's hierarchy: no PCA and no frame draws (the frame
    code is never called), ``frames`` None on every level and on the output
    cloud, the same clouds as JAX's; the trainer's level-0 features stay
    ``[B, N, C]`` whatever frame count it is asked for."""
    def no_frames(*a, **kw):
        raise AssertionError("a standard hierarchy attached frames")

    monkeypatch.setattr(thier, "attach_frames", no_frames)
    pts, mask, feats, labels = tiny_batch()
    jcfg = jhier.HierarchyConfig(**HCFG)
    assert jcfg.frames is None
    key = jax.random.PRNGKey(3)
    h, f0, out_pc, out_labels, _ = jax.jit(jhier.build_hierarchy, static_argnums=(4,))(
        key, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats), jcfg, jnp.asarray(labels))
    tcfg = thier.HierarchyConfig(**HCFG)
    draws = thier.draw_hierarchy(tcfg, 2, pts.shape[1], torch.Generator().manual_seed(0))
    assert draws.level_frames == [] and draws.out_frames is None
    th, tf0, tout, tlabels, _ = thier.build_hierarchy(
        t(pts), t(mask), t(feats), tcfg, t(labels), draws=jax_hierarchy_draws(key, jcfg, 2, pts.shape[1]))
    assert all(pc.frames is None for pc in th.levels) and tout.frames is None
    for ours, ref in zip(th.levels + (tout,), h.levels + (out_pc,)):
        np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_allclose(ours.positions.numpy(), np.asarray(ref.positions), atol=1e-6)
    np.testing.assert_allclose(tf0.numpy(), np.asarray(f0), atol=1e-6)
    np.testing.assert_array_equal(tlabels.numpy(), np.asarray(out_labels))
    trainer = Trainer(torch.nn.Linear(1, 1), tcfg)
    batch = {"positions": t(pts), "mask": t(mask), "features": t(feats)}
    for n_frames in (None, 4):
        f_in = trainer.build(batch, torch.Generator().manual_seed(1), n_frames=n_frames)[1]
        assert tuple(f_in.shape) == (2, HCFG["capacities"][0], 1)


# --- the tiny DFaust standard model ------------------------------------------------


def _jax_dfaust():
    spec = dataclasses.replace(jget_spec("FPNSegUNetMLPGeluFAUST"), **TINY, max_path_drop=0.5)
    return JNet(spec, num_in_feats=1, num_classes=NUM_CLASSES)


@pytest.fixture(scope="module")
def jax_dfaust():
    """The tiny JAX standard model's randomized, calibrated state on one
    JAX-built hierarchy, its eval logits, and its training state."""
    cfg = jhier.HierarchyConfig(**HCFG)
    pts, mask, feats, labels = tiny_batch()
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
              "features": jnp.asarray(feats), "labels": jnp.asarray(labels)}
    model = _jax_dfaust()
    jtrainer = JTrainer(model, cfg, capture_grads(), TrainSettings(label_smoothing=0.2),
                        donate_state=False)
    key = jax.random.PRNGKey(3)
    h, f0, out_pc, out_labels, raw_to_out = jax.jit(jtrainer._build)(key, jbatch)
    assert f0.ndim == 3  # no frame axis
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc,
        train=False)
    rng = np.random.default_rng(4)
    params, stats = randomize(v["params"], rng), randomize(v["batch_stats"], rng)
    apply = jax.jit(model.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply({"params": params, "batch_stats": stats, "calib": v["calib"]}, h, f0, out_pc,
                   train=False, calibrate=True, mutable=("calib",))
    variables = {"params": params, "batch_stats": stats, "calib": mut["calib"]}
    logits = np.asarray(apply(variables, h, f0, out_pc, train=False))
    return dict(cfg=cfg, key=key, jbatch=jbatch, jtrainer=jtrainer, h=h, f0=f0, out_pc=out_pc,
                out_labels=out_labels, raw_to_out=raw_to_out, v=v, variables=variables,
                logits=logits)


def _port_dfaust(variables):
    spec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluFAUST"), **TINY, max_path_drop=0.5)
    model = FPNSegUNet(spec, num_in_feats=1, num_classes=NUM_CLASSES)
    model.load_state_dict(from_flax(*(jax.device_get(variables[c])
                                      for c in ("params", "batch_stats", "calib"))))
    return model


def test_dfaust_standard_calibration_and_logits_match_jax(jax_dfaust):
    """Weights carried over strictly by ``from_flax`` (every proj_axes
    ``[3, 32]``); the calibration pass on the JAX hierarchy gives JAX's
    buffers (rtol 1e-6) and the eval logits agree within 2e-4, with no
    frame pooling over the classes."""
    jm = jax_dfaust
    model = _port_dfaust({**jm["variables"], "calib": jm["v"]["calib"]}).eval()
    convs = [mod for mod in model.modules() if isinstance(mod, PNEConv)]
    assert len(convs) == 9 and all(not c.equivariant and tuple(c.proj_axes.shape) == (3, 32)
                                   for c in convs)
    h, f0, out_pc = to_torch_hierarchy(jm["h"]), t(jm["f0"]), to_torch_cloud(jm["out_pc"])
    with torch.no_grad():
        model(h, f0, out_pc, calibrate=True)
        logits = model(h, f0, out_pc).numpy()
    ref = flat_tree(jm["variables"]["calib"])
    ours = {k: v.numpy() for k, v in model.state_dict().items() if k in ref}
    assert set(ours) == set(ref) and len(ref) == 4 * 9
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)
    assert logits.shape == (2, HCFG["out_capacity"], NUM_CLASSES)
    np.testing.assert_allclose(logits, jm["logits"], atol=2e-4, rtol=0)
    assert np.abs(jm["logits"]).max() > 0.1


def test_dfaust_standard_provider_caches_the_standard_geometry(jax_dfaust):
    """A standard spec's neighborhoods carry the raw offsets (``std_rel``,
    in the convs' operand dtype) and the live-row table, and no equivariant
    geometry."""
    h = to_torch_hierarchy(jax_dfaust["h"])
    spec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluFAUST"), **TINY)
    nb = NeighborhoodProvider(h, spec).get(1, 1, 0.32, "ball_query", 8)
    assert nb.equiv_rel is None and nb.equiv_rot is None and nb.live_rows is not None
    assert nb.std_rel.dtype == torch.float32
    assert torch.equal(nb.std_rel, ops.std_geometry(h.levels[1], h.levels[1], nb))
    bf16 = dataclasses.replace(spec, conv=dataclasses.replace(spec.conv, compute_dtype=torch.bfloat16),
                               conv_blocks=dataclasses.replace(spec.conv_blocks,
                                                               compute_dtype=torch.bfloat16))
    nb16 = NeighborhoodProvider(h, bf16).get(1, 1, 0.32, "ball_query", 8)
    assert torch.equal(nb16.std_rel, nb.std_rel.to(torch.bfloat16))


def test_dfaust_standard_train_step_matches_jax_trainer(jax_dfaust):
    """One train step of the tiny standard model against the JAX trainer's:
    the same weights, hierarchy draws and DropPath keep masks; loss, global
    gradient norm, per-leaf gradients and BN statistics."""
    jm = jax_dfaust
    jtrainer, cfg = jm["jtrainer"], jm["cfg"]
    variables = jm["variables"]
    tx = capture_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], calib=variables["calib"],
                       opt_state=tx.init(variables["params"]))
    order = []
    key = jax.random.PRNGKey(7)
    with fnn.intercept_methods(droppath_interceptor(order, reference_bn=False)):
        new_state, metrics = jtrainer.train_step(state, jm["jbatch"], key)
    keep_masks, new_stats = pop_keep_masks(new_state.batch_stats, order)
    assert len(keep_masks) == 2  # the two skips of the one block with drop probability 0.5

    tmodel = _port_dfaust(variables)
    opt = schedule.make_optimizer(tmodel.parameters(), 5e-3, 100, clip_grad_norm=100.0)
    trainer = Trainer(tmodel, thier.HierarchyConfig(**HCFG), label_smoothing=0.2, optimizer=opt)
    pts, mask, feats, labels = tiny_batch()
    rng_h, _ = jax.random.split(jax.random.fold_in(key, 0))
    out = trainer.train_step(
        {k: t(x) for k, x in zip(("positions", "mask", "features", "labels"), (pts, mask, feats, labels))},
        draws=jax_hierarchy_draws(rng_h, cfg, 2, pts.shape[1]),
        drop_masks=[t(m) for m in keep_masks],
    )
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    assert float(out["grad_norm"]) < 100.0  # unclipped, so p.grad is the raw gradient
    ref_grads = flat_tree(new_state.opt_state)
    ours = {name: p.grad for name, p in tmodel.named_parameters()}
    assert set(ours) == set(ref_grads)
    norm = float(metrics["grad_norm"])
    for name, ref in ref_grads.items():
        err = np.abs(ours[name].numpy() - ref).max()
        assert err <= STEP_GRAD_TOL * max(np.abs(ref).max(), GRAD_FLOOR * norm), (name, err)
    for name, ref in flat_tree(new_stats).items():
        np.testing.assert_allclose(tmodel.get_buffer(name).numpy(), ref, rtol=BN_RTOL, atol=1e-6,
                                   err_msg=name)


# --- the tiny ScanNet standard model, bfloat16 --------------------------------------


def test_scannet_standard_bf16_logits_match_jax_fused_bf16(monkeypatch):
    """The tiny ScanNet-shaped standard model with bfloat16 convs through
    both packages on one JAX-built hierarchy, same weights and calibration,
    at ``tests/test_torch_bf16.py``'s whole-model bound (``2e-2 * max
    |logits|``), its mean error at most half that against JAX's float32
    logits."""
    monkeypatch.setattr(fe, "FUSED_INTERPRET", True)
    name = "FPNSegUNetMLPGeluScanNet"
    pts, mask, feats, labels = scannet._batch()
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
              "features": jnp.asarray(feats), "labels": jnp.asarray(labels)}
    f32_spec = dataclasses.replace(jget_spec(name), **scannet.SMALL)
    jspec = dataclasses.replace(
        f32_spec, conv=dataclasses.replace(f32_spec.conv, compute_dtype="bfloat16", use_fused=True),
        conv_blocks=dataclasses.replace(f32_spec.conv_blocks, compute_dtype="bfloat16", use_fused=True))
    cfg = jhier.HierarchyConfig(**scannet.HCFG)
    f32_model = JNet(f32_spec, num_in_feats=scannet.FEATS, num_classes=scannet.CLASSES)
    jmodel = JNet(jspec, num_in_feats=scannet.FEATS, num_classes=scannet.CLASSES)
    h, f0, out_pc, _, _ = jax.jit(JTrainer(f32_model, cfg, optax.identity(),
                                           donate_state=False)._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(f32_model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc,
        train=False)
    rng = np.random.default_rng(4)
    params, stats = randomize(v["params"], rng), randomize(v["batch_stats"], rng)
    apply = jax.jit(f32_model.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply({"params": params, "batch_stats": stats, "calib": v["calib"]}, h, f0, out_pc,
                   train=False, calibrate=True, mutable=("calib",))
    variables = {"params": params, "batch_stats": stats, "calib": mut["calib"]}
    want = np.asarray(jax.jit(jmodel.apply, static_argnames=("train",))(variables, h, f0, out_pc,
                                                                         train=False))
    want_f32 = np.asarray(apply(variables, h, f0, out_pc, train=False))

    spec = dataclasses.replace(get_model_spec(name), **scannet.SMALL)
    spec = dataclasses.replace(
        spec, conv=dataclasses.replace(spec.conv, compute_dtype=torch.bfloat16),
        conv_blocks=dataclasses.replace(spec.conv_blocks, compute_dtype=torch.bfloat16))
    model = FPNSegUNet(spec, num_in_feats=scannet.FEATS, num_classes=scannet.CLASSES)
    model.load_state_dict(from_flax(*(jax.device_get(x) for x in (params, stats, mut["calib"]))))
    with torch.no_grad():
        got = model.eval()(to_torch_hierarchy(h), t(f0), to_torch_cloud(out_pc)).numpy()
    valid = np.asarray(out_pc.mask)
    scale = np.abs(want[valid]).max()
    err = np.abs(got - want)[valid]
    assert scale > 0.1
    assert err.max() <= 2e-2 * scale, (err.max(), scale)
    assert err.mean() <= 0.5 * np.abs(got - want_f32)[valid].mean()


# --- the pinned recipes -----------------------------------------------------------


RECIPES = {
    # name: (YAML under configs/, pinned Model, pinned Training, input features, classes)
    "dfaust_I_standard": ("dfaust/dfaust_I_standard.yaml", "DFAUST_I_STANDARD", 1,
                          presets.DFAUST_NUM_CLASSES),
    "scannet20_standard_I": ("scannet/scannet20_standard_I.yaml", "SCANNET20_STANDARD_I",
                             presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES),
    "scannet20_standard_SO2": ("scannet/scannet20_standard_SO2.yaml", "SCANNET20_STANDARD_SO2",
                               presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_pinned_standard_recipe_matches_yaml_and_builds(recipe):
    """The pinned ``Model`` and ``Training`` sections equal the YAML file as
    ``train/config.py`` reads it; the spec equals the JAX package's; the
    hierarchy has no frames; ``build_model_from_config`` builds the
    standard model (every conv standard, in the recipe's dtype; ``remat``
    read and ignored) on the CPU when asked."""
    path, pinned, feats, classes = RECIPES[recipe]
    cfg = jconfig.load_yaml_config(os.path.join(REPO, "configs", path))
    model_dict = getattr(presets, f"{pinned}_MODEL")
    assert model_dict == cfg["Model"]
    assert getattr(presets, f"{pinned}_TRAINING") == cfg["Training"]
    ours = presets.spec_from_model_dict(model_dict)
    ref = jconfig.build_model_from_config(cfg["Model"], feats, classes).spec
    assert not ours.equivariant and not ref.equivariant
    for field in dataclasses.fields(ours):
        if field.name in ("conv", "conv_blocks"):
            for k in ("num_basis", "pne_type", "equivariant", "aggregation"):
                assert getattr(getattr(ours, field.name), k) == getattr(getattr(ref, field.name), k)
        else:
            assert getattr(ours, field.name) == getattr(ref, field.name), field.name
    n_points = cfg["Dataset"].get("num_points", presets.SCANNET_SCENE_MAX_POINTS)
    hcfg = presets.hierarchy_config_from_model_dict(model_dict, n_points)
    assert hcfg.frames is None and hcfg.capacities == tuple(model_dict["capacities"])
    model = config.build_model_from_config(model_dict, feats, classes, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    convs = [mod for mod in model.modules() if isinstance(mod, PNEConv)]
    want_dtype = presets.COMPUTE_DTYPES.get(model_dict.get("compute_dtype"))
    assert len(convs) == (21 if recipe.startswith("dfaust") else 32)
    assert all(not c.equivariant and tuple(c.proj_axes.shape) == (3, 32) and c.compute_dtype == want_dtype
               for c in convs)
    assert next(model.parameters()).device.type == "cpu"
