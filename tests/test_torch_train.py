"""The port's training step against the JAX package.

* train-mode ``MaskedBatchNorm`` against numpy over the flat
  ``(valid points x frames, C)`` rows of the reference's ``BatchNorm1d``,
  and a record of the JAX package's deviation from it at F > 1;
* train-mode ``DropPath`` with injected uniforms;
* the one-cycle schedule and the clipped AdamW against the JAX package's
  ``onecycle`` / ``make_optimizer`` optax chain, and gradient accumulation
  against its ``optax.MultiSteps`` wrapper;
* one whole ``Trainer.train_step`` of the tiny FPNSegUNetMLPGeluRotEqFAUST
  against the JAX ``Trainer.train_step``: the same weights (``from_flax``),
  hierarchy draws and DropPath keep masks (captured from the JAX run with
  ``flax.linen.intercept_methods``), with PCA frames at F = 1, 2, 4 and
  random SO(3) frames at F = 4.  At F > 1 the JAX run goes through an
  interceptor that gives its ``MaskedBatchNorm`` the reference's row count;
  no file of the JAX package changes;
* one accumulated optimizer step (two micro-batches, at F = 1 and F = 4,
  random frames) of one port ``Trainer`` against two JAX trainers that
  share one state under ``optax.MultiSteps(k=2)``.
"""
import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import (HCFG, NUM_CLASSES, TINY, capture_grads, droppath_interceptor,
                                flat_tree, jax_hierarchy_draws, pop_keep_masks, randomize, t,
                                tiny_batch)

from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.nn.norm import MaskedBatchNorm as JBatchNorm
from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu.train import schedule as jschedule
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu.train.trainer import TrainSettings, TrainState
from se3conv3d_tpu_torch.core import hierarchy as thier
from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec, presets
from se3conv3d_tpu_torch.nn.blocks import DropPath, DropPathDraws
from se3conv3d_tpu_torch.nn.norm import MaskedBatchNorm
from se3conv3d_tpu_torch.train import schedule
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- batch norm ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 30, 8), (2, 30, 1, 8), (2, 30, 2, 8)])
def test_train_batchnorm_matches_numpy_over_valid_point_frame_rows(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 2.0 + 0.5
    mask = np.arange(shape[1])[None] < np.array([30, 21])[:, None]
    bn = MaskedBatchNorm(shape[-1])
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=shape[-1]).astype(np.float32)))
    y = bn.train()(t(x), t(mask)).detach().numpy()

    rows = x[mask].reshape(-1, shape[-1]).astype(np.float64)  # (valid points x frames, C)
    mean, var = rows.mean(0), rows.var(0)
    want = (x - mean) / np.sqrt(var + 1e-5) * bn.scale.detach().numpy() + bn.bias.detach().numpy()
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), 0.2 * mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), 0.8 + 0.2 * rows.var(0, ddof=1), rtol=1e-5)
    # eval mode normalises with the running statistics and leaves them alone
    before = bn.mean.clone()
    bn.eval()(t(x), t(mask))
    assert torch.equal(bn.mean, before)


def test_jax_train_batchnorm_counts_points_not_frames():
    """Records the JAX package's deviation (ROADMAP Queue 3): its train-mode
    BN divides by the valid *points*, not points x frames, so at F=2 a
    constant input of 5 moves its running mean to 2.0 where the reference's
    ``BatchNorm1d(momentum=0.2)`` over ``(n*F, C)`` rows gives 1.0, and it
    normalises to -0.707 instead of 0.  This fails once the JAX side is
    fixed; then the F=2 train-step test can drop its interceptor."""
    x = np.full((1, 4, 2, 3), 5.0, np.float32)
    mask = np.ones((1, 4), bool)
    jbn = JBatchNorm(3)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False)
    jy, mut = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask), True, mutable=["batch_stats"])
    bn = MaskedBatchNorm(3).train()
    y = bn(t(x), t(mask))
    np.testing.assert_allclose(bn.mean.numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(mut["batch_stats"]["mean"]), 2.0 * bn.mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jy), -0.70710677, rtol=1e-4)


# --- drop path ----------------------------------------------------------------


def test_train_droppath_formula_and_per_example_scope():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 7, 2, 3)).astype(np.float32))
    dp = DropPath(0.3).train()
    u = torch.rand(5, generator=torch.Generator().manual_seed(4))
    got = dp(x, DropPathDraws(generator=torch.Generator().manual_seed(4)))
    keep = torch.floor(0.7 + u)
    assert 0 < keep.sum() < 5  # both kept and dropped examples
    want = x / 0.7 * keep[:, None, None, None]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # injected keep masks are consumed in call order, one per example
    draws = DropPathDraws(keep_masks=[torch.tensor([1., 0., 1., 1., 0.]), torch.tensor([0., 1., 1., 0., 0.])])
    first, second = dp(x, draws), dp(x, draws)
    for out, m in ((first, [1, 0, 1, 1, 0]), (second, [0, 1, 1, 0, 0])):
        for i, keep_i in enumerate(m):
            np.testing.assert_array_equal(out[i].numpy(), (x[i] / 0.7 * keep_i).numpy())
    with pytest.raises(ValueError):
        dp(x, draws)  # no mask left
    with pytest.raises(ValueError):
        dp(x)  # never the global RNG
    assert dp.eval()(x) is x
    assert DropPath(0.0).train()(x) is x


# --- schedule and optimizer ---------------------------------------------------


@pytest.mark.parametrize("total", [2, 3, 7, 1000])
def test_onecycle_matches_jax(total):
    for kw in (dict(pct_start=0.05, div_factor=10.0, final_div_factor=1000.0), {}):
        ours = schedule.onecycle(5e-3, total, **kw)
        ref = jschedule.onecycle(5e-3, total, **kw)
        steps = np.arange(total + 3)
        got = np.array([ours(int(s)) for s in steps])
        want = np.array([float(ref(jnp.asarray(s))) for s in steps])
        assert np.all(np.isfinite(got))
        # optax interpolates in float32: agreement to its rounding of max_lr
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=4 * 2.0**-23 * 5e-3, err_msg=str(kw))


def test_clipped_adamw_matches_the_jax_optax_chain():
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jschedule.make_optimizer(5e-3, total_steps=12, weight_decay=1e-4, clip_grad_norm=1.5,
                                  pct_start=0.25)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = schedule.make_optimizer(tparams.values(), 5e-3, total_steps=12, weight_decay=1e-4,
                                  clip_grad_norm=1.5, pct_start=0.25)
    norms = []
    for step in range(5):
        grads = {k: (rng.normal(size=s) * (0.2 if step % 2 else 1.0)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = t(grads[k])
        norms.append(float(opt.step()))
        np.testing.assert_allclose(norms[-1], float(optax.global_norm(grads)), rtol=1e-6)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       err_msg=f"step {step} leaf {k}")
    assert max(norms) > 1.5 > min(norms)  # both clipped and unclipped steps
    with pytest.raises(ValueError):  # accumulation takes at least one micro-batch a step
        schedule.make_optimizer(tparams.values(), 5e-3, 12, accum_steps=0)


@pytest.mark.parametrize("k", [2, 3])
def test_accumulating_adamw_matches_optax_multisteps(k):
    """``make_optimizer(..., accum_steps=k)`` against the JAX package's
    ``make_optimizer(..., accum_steps=k)`` (``optax.MultiSteps``) on the same
    gradients: the calls between updates leave the parameters bitwise
    unchanged and the schedule where it was; every k-th call applies the
    clipped mean, and the one-cycle runs over ``total_steps // k`` updates.
    The mean is a sum over k here and a running mean in optax, so the
    parameters agree to float32 rounding (rtol 1e-6)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    params = {key: rng.normal(size=s).astype(np.float32) for key, s in shapes.items()}
    total = 6 * k
    tx = jschedule.make_optimizer(5e-3, total_steps=total, weight_decay=1e-4, clip_grad_norm=1.0,
                                  accum_steps=k, pct_start=0.25)
    jparams = {key: jnp.asarray(v) for key, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {key: torch.nn.Parameter(t(v)) for key, v in params.items()}
    opt = schedule.make_optimizer(tparams.values(), 5e-3, total_steps=total, weight_decay=1e-4,
                                  clip_grad_norm=1.0, accum_steps=k, pct_start=0.25)
    lrs = [opt.lr]
    for call in range(3 * k):
        grads = {key: (rng.normal(size=s) * (0.1 if call < k else 1.0)).astype(np.float32)
                 for key, s in shapes.items()}
        updates, jstate = tx.update({key: jnp.asarray(v) for key, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {key: p.detach().clone() for key, p in tparams.items()}
        for key, p in tparams.items():
            p.grad = t(grads[key])
        norm = float(opt.step())
        np.testing.assert_allclose(norm, float(optax.global_norm(grads)), rtol=1e-6)
        update = (call + 1) % k == 0
        assert opt.micro_step == (call + 1) % k
        for key, p in tparams.items():
            if not update:
                assert torch.equal(p, before[key]), (call, key)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[key]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"call {call} leaf {key}")
        lrs.append(opt.lr)
    # the schedule advanced once per update, over total // k updates
    want = [schedule.onecycle(5e-3, total // k, 0.25)(call // k) for call in range(3 * k + 1)]
    np.testing.assert_allclose(lrs, want, rtol=1e-12)
    assert len(set(lrs)) == 4
    opt = schedule.optimizer_from_training([torch.nn.Parameter(torch.zeros(3))],
                                           presets.DFAUST_I_ROT_MC_MIXF_TRAINING, 1000)
    assert opt.accum_steps == 2 and opt.clip_grad_norm == 100.0


def test_pinned_training_matches_yaml():
    path = os.path.join(REPO, "configs", "dfaust", "dfaust_I_rot_pca_2F.yaml")
    assert presets.DFAUST_I_ROT_PCA_2F_TRAINING == jconfig.load_yaml_config(path)["Training"]
    opt = schedule.optimizer_from_training([torch.nn.Parameter(torch.zeros(3))],
                                           presets.DFAUST_I_ROT_PCA_2F_TRAINING, 1000)
    assert opt.clip_grad_norm == 100.0 and opt.adamw.defaults["weight_decay"] == 1e-4
    assert opt.lr == pytest.approx(5e-4)  # max_lr / div_factor at step 0


# --- the whole train step -----------------------------------------------------


# max |port - JAX| <= GRAD_TOL * max(max |JAX leaf|, GRAD_FLOOR * grad_norm)
# per gradient leaf: both sides sum float32 in other orders through ~20
# layers and a loss.  The floor covers leaves whose true gradient is 0 (a
# bias just before a train-mode BN, which removes any constant shift): they
# hold only rounding noise.  BN statistics within BN_RTOL (they average a
# few hundred rows).
GRAD_TOL, GRAD_FLOOR, BN_RTOL = 1e-4, 1e-2, 1e-5


def _jax_start(cfg, jbatch, tx):
    """The JAX tiny model's randomized, calibrated state (``tx`` state
    fresh) and the model."""
    spec = dataclasses.replace(jget_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY, max_path_drop=0.5)
    model = JNet(spec, num_in_feats=1, num_classes=NUM_CLASSES)
    jtrainer = JTrainer(model, cfg, tx, TrainSettings(label_smoothing=0.2), donate_state=False)
    h, f0, out_pc, _, _ = jax.jit(jtrainer._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc,
        train=False)
    rng = np.random.default_rng(4)
    params, stats = randomize(v["params"], rng), randomize(v["batch_stats"], rng)
    _, mut = jax.jit(model.apply, static_argnames=("train", "calibrate", "mutable"))(
        {"params": params, "batch_stats": stats, "calib": v["calib"]}, h, f0, out_pc,
        train=False, calibrate=True, mutable=("calib",))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       calib=mut["calib"], opt_state=tx.init(params))
    return model, state


def _port_model(params, stats, calib):
    tspec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY,
                                max_path_drop=0.5)
    tmodel = FPNSegUNet(tspec, num_in_feats=1, num_classes=NUM_CLASSES)
    tmodel.load_state_dict(from_flax(*(jax.device_get(x) for x in (params, stats, calib))))
    return tmodel


def _torch_batch(pts, mask, feats, labels):
    return {k: t(x) for k, x in zip(("positions", "mask", "features", "labels"),
                                    (pts, mask, feats, labels))}


# the train-step cases: (frames F, PCA frames or random SO(3) ones)
TRAIN_STEP_CASES = [pytest.param(1, True, id="1"), pytest.param(2, True, id="2"),
                    pytest.param(4, True, id="4"), pytest.param(4, False, id="4-mc")]


@pytest.mark.parametrize("frames,pca", TRAIN_STEP_CASES)
def test_train_step_matches_jax_trainer(frames, pca):
    fkw = dict(n_frames=frames, neigh_k=8, pca=pca)
    cfg = jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(**fkw))
    pts, mask, feats, labels = tiny_batch()
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
              "features": jnp.asarray(feats), "labels": jnp.asarray(labels)}

    model, state = _jax_start(cfg, jbatch, capture_grads())
    jtrainer = JTrainer(model, cfg, capture_grads(), TrainSettings(label_smoothing=0.2),
                        donate_state=False)
    params, stats, calib = state.params, state.batch_stats, state.calib
    order = []
    key = jax.random.PRNGKey(7)
    with fnn.intercept_methods(droppath_interceptor(order, reference_bn=frames > 1)):
        new_state, metrics = jtrainer.train_step(state, jbatch, key)
    keep_masks, new_stats = pop_keep_masks(new_state.batch_stats, order)
    assert len(keep_masks) == 2  # the two skips of the one block with drop probability 0.5

    tmodel = _port_model(params, stats, calib)
    opt = schedule.make_optimizer(tmodel.parameters(), 5e-3, 100, clip_grad_norm=100.0)
    tcfg = thier.HierarchyConfig(**HCFG, frames=thier.FrameConfig(**fkw))
    trainer = Trainer(tmodel, tcfg, label_smoothing=0.2, optimizer=opt)
    rng_h, _ = jax.random.split(jax.random.fold_in(key, 0))
    out = trainer.train_step(
        _torch_batch(pts, mask, feats, labels),
        draws=jax_hierarchy_draws(rng_h, cfg, 2, pts.shape[1]),
        drop_masks=[t(m) for m in keep_masks],
    )
    assert trainer.step == 1
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    assert float(out["grad_norm"]) < 100.0  # unclipped, so p.grad is the raw gradient

    ref_grads = flat_tree(new_state.opt_state)
    ours = {name: p.grad for name, p in tmodel.named_parameters()}
    assert set(ours) == set(ref_grads)
    norm = float(metrics["grad_norm"])
    for name, ref in ref_grads.items():
        err = np.abs(ours[name].numpy() - ref).max()
        assert err <= GRAD_TOL * max(np.abs(ref).max(), GRAD_FLOOR * norm), (name, err, np.abs(ref).max())
    moved = 0
    for name, ref in flat_tree(new_stats).items():
        got = tmodel.get_buffer(name).numpy()
        np.testing.assert_allclose(got, ref, rtol=BN_RTOL, atol=1e-6, err_msg=name)
        moved += not np.allclose(ref, flat_tree(stats)[name])
    assert moved == len(flat_tree(stats))  # every BN statistic moved


def test_accumulated_step_matches_jax_multisteps():
    """One optimizer step of two micro-batches (``accum_grads: 2``), random
    SO(3) frames, the first at F = 1 and the second at F = 4 (a
    ``mix_n_frames`` draw): one port ``Trainer`` whose ``train_step`` takes
    the frame count, against two JAX trainers (F = 1, F = 4) sharing one
    state under ``optax.MultiSteps(k=2)``, with the same hierarchy draws and
    DropPath keep masks.  After the first micro-batch the parameters are
    bitwise unchanged and the BN statistics equal JAX's; after the second,
    AdamW's first moment (0.1 x the clipped mean gradient) and the
    parameters agree with JAX's within the ``GRAD_TOL`` rule (per leaf, with
    the floor taken from the tree's global norm).  The learning rate is
    small (2e-6 at this step), so a parameter whose mean gradient is only
    rounding noise (a bias before a train-mode BN), which AdamW moves by
    about the learning rate in either direction, stays within the rule; the
    first moment holds the gradients themselves."""
    max_lr, total = 5e-5, 20
    pts, mask, feats, labels = tiny_batch()
    pts2, mask2, feats2, labels2 = tiny_batch(seed=1)
    cfgs = {f: jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(n_frames=f, pca=False))
            for f in (1, 4)}
    batches = [(pts, mask, feats, labels), (pts2, mask2, feats2, labels2)]
    jbatches = [{k: jnp.asarray(x) for k, x in zip(("positions", "mask", "features", "labels"), b)}
                for b in batches]
    tx = jschedule.make_optimizer(max_lr, total, weight_decay=1e-4, clip_grad_norm=100.0,
                                  accum_steps=2)
    model, state = _jax_start(cfgs[1], jbatches[0], tx)
    params0, stats0 = state.params, state.batch_stats
    tmodel = _port_model(params0, stats0, state.calib)
    opt = schedule.make_optimizer(tmodel.parameters(), max_lr, total, weight_decay=1e-4,
                                  clip_grad_norm=100.0, accum_steps=2)
    tcfg = thier.HierarchyConfig(**HCFG, frames=thier.FrameConfig(n_frames=1, pca=False))
    trainer = Trainer(tmodel, tcfg, label_smoothing=0.2, optimizer=opt)
    key = jax.random.PRNGKey(9)
    for step, f in enumerate((1, 4)):
        jtrainer = JTrainer(model, cfgs[f], tx, TrainSettings(label_smoothing=0.2), donate_state=False)
        order = []
        with fnn.intercept_methods(droppath_interceptor(order, reference_bn=f > 1)):
            state, metrics = jtrainer.train_step(state, jbatches[step], key)
        keep_masks, stats = pop_keep_masks(state.batch_stats, order)
        state = state.replace(batch_stats=stats)
        rng_h, _ = jax.random.split(jax.random.fold_in(key, step))
        out = trainer.train_step(_torch_batch(*batches[step]), n_frames=f,
                                 draws=jax_hierarchy_draws(rng_h, cfgs[f], 2, pts.shape[1]),
                                 drop_masks=[t(m) for m in keep_masks])
        np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(out["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
        for name, ref in flat_tree(stats).items():
            np.testing.assert_allclose(tmodel.get_buffer(name).numpy(), ref, rtol=BN_RTOL, atol=1e-6,
                                       err_msg=f"micro-batch {step} {name}")
        ref_params = flat_tree(state.params)
        if step == 0:  # nothing applied yet: both sides hold the first parameters bitwise
            for name, p in tmodel.named_parameters():
                assert np.array_equal(p.detach().numpy(), ref_params[name]), name
                assert np.array_equal(ref_params[name], flat_tree(params0)[name]), name
            assert opt.micro_step == 1 and opt.lr == pytest.approx(max_lr / 25)
    assert trainer.step == 2 and opt.micro_step == 0

    def hold(ours, ref, what):
        norm = float(np.sqrt(sum(np.square(r.astype(np.float64)).sum() for r in ref.values())))
        assert set(ours) == set(ref)
        for name, r in ref.items():
            err = np.abs(ours[name] - r).max()
            assert err <= GRAD_TOL * max(np.abs(r).max(), GRAD_FLOOR * norm), (what, name, err)

    mu = flat_tree(state.opt_state.inner_opt_state[1][0].mu)
    hold({n: opt.adamw.state[p]["exp_avg"].numpy() for n, p in tmodel.named_parameters()}, mu,
         "first moment")
    assert max(np.abs(m).max() for m in mu.values()) > 0
    ref_params = flat_tree(state.params)
    hold({n: p.detach().numpy() for n, p in tmodel.named_parameters()}, ref_params, "parameters")
    moved = sum(not np.array_equal(ref_params[n], flat_tree(params0)[n]) for n in ref_params)
    assert moved == len(ref_params)  # the update reached every leaf
