"""The port's other residual blocks, hidden seg-head layers and plain SegUNet
against the JAX package.

On the same numpy-seeded inputs, with the JAX weights carried over by
``utils.weights.from_flax`` (strict load) and the JAX DropPath keep masks
injected (``torch_port_helpers.droppath_interceptor``, which also gives
JAX's train-mode ``MaskedBatchNorm`` the reference's row count at F = 2):

* ``ResNetB`` and ``ResConvNeXt`` alone on a tiny hierarchy's first trunk
  level (16 channels, F = 2, a ball-query neighborhood from each package's
  ``NeighborhoodProvider``): eval and train-mode outputs within atol 2e-4
  / rtol 5e-5 (``tests/test_torch_standard.py``'s conv bounds) and every
  parameter gradient of a seeded projection within atol 5e-4 / rtol 5e-3;
* the tiny FPNSegUNetMLPGeluRotEqFAUST with ``block_layer`` ``resnetb``
  and ``resconvnext``, with ``num_hidden_seg_head`` 1 and 2, and the plain
  ``SegUNet``: calibration buffers (rtol 1e-6) and eval logits (atol
  2e-4), the repo's whole-model bounds;
* one ``Trainer.train_step`` of each against the JAX trainer's: loss
  rtol 1e-5 and every parameter gradient within ``tests/test_torch_train.py``'s
  rule.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (HCFG, NUM_CLASSES, TINY, capture_grads, droppath_interceptor,
                                flat_tree, jax_hierarchy_draws, pop_keep_masks, randomize, t,
                                tiny_batch, to_torch_cloud, to_torch_hierarchy)

from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.models import FPNSegUNet as JFPN
from se3conv3d_tpu.models import SegUNet as JSegUNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.models.spec import NeighborhoodProvider as JProvider
from se3conv3d_tpu.nn.blocks import ResConvNeXt as JResConvNeXt
from se3conv3d_tpu.nn.blocks import ResNetB as JResNetB
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu.train.trainer import TrainSettings, TrainState
from se3conv3d_tpu_torch.core import hierarchy as thier
from se3conv3d_tpu_torch.models import BLOCK_LAYERS, FPNSegUNet, SegUNet, get_model_spec
from se3conv3d_tpu_torch.models.spec import NeighborhoodProvider
from se3conv3d_tpu_torch.nn.blocks import DropPathDraws, ResConvNeXt, ResNetB, ResNetFormer
from se3conv3d_tpu_torch.train import schedule
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

ATOL, RTOL = 2e-4, 5e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
LOGITS_ATOL = 2e-4
# whole train step, per gradient leaf (tests/test_torch_train.py)
STEP_GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-2
FRAMES = 2
JBLOCKS = {"resnetb": JResNetB, "resconvnext": JResConvNeXt}
TBLOCKS = {"resnetb": ResNetB, "resconvnext": ResConvNeXt}


def _cfgs():
    fkw = dict(n_frames=FRAMES, neigh_k=8)
    return (jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(**fkw)),
            thier.HierarchyConfig(**HCFG, frames=thier.FrameConfig(**fkw)))


@pytest.fixture(scope="module")
def level():
    """A JAX hierarchy of the tiny batch, its first trunk level's
    ball-query neighborhood in both packages, and 16-channel features."""
    jcfg, _ = _cfgs()
    pts, mask, feats, labels = tiny_batch()
    h, *_ = jax.jit(jhier.build_hierarchy, static_argnums=(4,))(
        jax.random.PRNGKey(3), jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats), jcfg)
    jspec = dataclasses.replace(jget_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY)
    tspec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY)
    radius = 2.0 * h.levels_radii[1]
    jneigh = JProvider(h, jspec).get(1, 1, radius, "ball_query", 16)
    th = to_torch_hierarchy(h)
    tneigh = NeighborhoodProvider(th, tspec).get(1, 1, radius, "ball_query", 16)
    n = h.levels[1].mask.shape[1]
    x = np.random.default_rng(5).normal(size=(2, n, FRAMES, 16)).astype(np.float32)
    return dict(jpc=h.levels[1], jneigh=jneigh, jspec=jspec, tpc=th.levels[1], tneigh=tneigh,
                tspec=tspec, x=x)


def _block_case(lv, name, out):
    """The JAX block's randomized, calibrated variables and the port block
    loaded from them."""
    jblock = JBLOCKS[name](16, out, lv["jspec"].conv_blocks, drop_prob=0.4)
    x = jnp.asarray(lv["x"])
    v = jblock.init(jax.random.PRNGKey(1), lv["jpc"], x, lv["jneigh"], False)
    rng = np.random.default_rng(6)
    v = {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng),
         "calib": v["calib"]}
    _, mut = jblock.apply(v, lv["jpc"], x, lv["jneigh"], False, True, mutable=("calib",))
    v = {**v, "calib": mut["calib"]}
    tblock = TBLOCKS[name](16, out, lv["tspec"].conv_blocks, drop_prob=0.4)
    tblock.load_state_dict(from_flax(*(jax.device_get(v[c]) for c in ("params", "batch_stats", "calib"))))
    return jblock, v, tblock


def _hold(got, want, what, atol=ATOL, rtol=RTOL):
    assert got.shape == want.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("out", [16, 12], ids=["same_width", "skip_conv"])
@pytest.mark.parametrize("name", sorted(JBLOCKS))
def test_block_matches_jax_in_eval_and_train_mode(level, name, out):
    """Eval output, train-mode output (injected keep masks, batch
    statistics) and the gradient of every parameter and of the input."""
    lv = level
    jblock, v, tblock = _block_case(lv, name, out)
    x = jnp.asarray(lv["x"])
    proj = np.random.default_rng(8).normal(size=(2, x.shape[1], FRAMES, out)).astype(np.float32)
    want = np.asarray(jblock.apply(v, lv["jpc"], x, lv["jneigh"], False))
    got = tblock.eval()(lv["tpc"], t(lv["x"]), lv["tneigh"]).detach().numpy()
    _hold(got, want, f"{name} eval")

    order = []

    def loss(params, feats):
        out_, mut = jblock.apply({**v, "params": params}, lv["jpc"], feats, lv["jneigh"], True,
                                 mutable=("batch_stats",), rngs={"droppath": jax.random.PRNGKey(9)})
        return jnp.sum(out_ * proj), (out_, mut)

    with fnn.intercept_methods(droppath_interceptor(order, reference_bn=True)):
        (_, (jout, mut)), (jgrads, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            v["params"], x)
    masks, _ = pop_keep_masks(mut["batch_stats"], order)
    assert len(masks) == 1  # the block's one skip path

    tx = t(lv["x"]).requires_grad_()
    tout = tblock.train()(lv["tpc"], tx, lv["tneigh"], drops=DropPathDraws(keep_masks=[t(masks[0])]))
    _hold(tout.detach().numpy(), np.asarray(jout), f"{name} train")
    (tout * t(proj)).sum().backward()
    ref = flat_tree(jgrads)
    ours = {k: p.grad.numpy() for k, p in tblock.named_parameters()}
    assert set(ours) == set(ref)
    for k in ref:
        _hold(ours[k], ref[k], f"{name} d {k}", GRAD_ATOL, GRAD_RTOL)
    _hold(tx.grad.numpy(), np.asarray(jgx), f"{name} d features", GRAD_ATOL, GRAD_RTOL)


def test_block_layers_table_and_unknown_name():
    assert BLOCK_LAYERS == {"resnetformer": ResNetFormer, "resnetb": ResNetB, "resconvnext": ResConvNeXt}
    spec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY,
                               block_layer="resnext")
    with pytest.raises(KeyError):
        FPNSegUNet(spec, 1, NUM_CLASSES)


# the whole-model cases: (net, block_layer, num_hidden_seg_head)
MODEL_CASES = {
    "fpn_resnetb": ("fpn", "resnetb", 0),
    "fpn_resconvnext_hidden2": ("fpn", "resconvnext", 2),
    "fpn_hidden1": ("fpn", "resnetformer", 1),
    "segunet": ("seg", "resnetformer", 0),
}


def _specs(case, **extra):
    net, block, hidden = MODEL_CASES[case]
    kw = dict(TINY, block_layer=block, num_hidden_seg_head=hidden, seg_head_feats=8, **extra)
    return (net, dataclasses.replace(jget_spec("FPNSegUNetMLPGeluRotEqFAUST"), **kw),
            dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), **kw))


def _nets(case, **extra):
    net, jspec, tspec = _specs(case, **extra)
    jnet = (JFPN if net == "fpn" else JSegUNet)(jspec, num_in_feats=1, num_classes=NUM_CLASSES)
    tnet = (FPNSegUNet if net == "fpn" else SegUNet)(tspec, num_in_feats=1, num_classes=NUM_CLASSES)
    return jnet, tnet


def _start(jnet, jcfg, jbatch):
    """The JAX net's hierarchy of the batch, its randomized variables
    before and after calibration, and its jitted apply."""
    jtrainer = JTrainer(jnet, jcfg, capture_grads(), TrainSettings(label_smoothing=0.2),
                        donate_state=False)
    h, f0, out_pc, _, _ = jax.jit(jtrainer._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(jnet.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc,
        train=False)
    rng = np.random.default_rng(4)
    v = {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng),
         "calib": v["calib"]}
    apply = jax.jit(jnet.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply(v, h, f0, out_pc, train=False, calibrate=True, mutable=("calib",))
    return jtrainer, (h, f0, out_pc), v, {**v, "calib": mut["calib"]}, apply


def _load(tnet, v):
    tnet.load_state_dict(from_flax(*(jax.device_get(v[c]) for c in ("params", "batch_stats", "calib"))))
    return tnet


def _jbatch():
    pts, mask, feats, labels = tiny_batch()
    return {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
            "features": jnp.asarray(feats), "labels": jnp.asarray(labels)}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_logits_and_calibration_match_jax(case):
    """Calibration from the initial buffers, then eval logits, on the JAX
    net's hierarchy; the flax names of the new layers in the state dict."""
    jcfg, _ = _cfgs()
    jnet, tnet = _nets(case)
    _, (h, f0, out_pc), v, calibrated, apply = _start(jnet, jcfg, _jbatch())
    logits = np.asarray(apply(calibrated, h, f0, out_pc, train=False))
    tnet = _load(tnet, v).eval()
    th, tout = to_torch_hierarchy(h), to_torch_cloud(out_pc)
    with torch.no_grad():
        tnet(th, t(f0), tout, calibrate=True)
        got = tnet(th, t(f0), tout).numpy()
    ref = flat_tree(calibrated["calib"])
    ours = {k: x.numpy() for k, x in tnet.state_dict().items() if k in ref}
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)
    assert got.shape == (2, HCFG["out_capacity"], NUM_CLASSES)
    np.testing.assert_allclose(got, logits, atol=LOGITS_ATOL, rtol=0)
    assert np.abs(logits).max() > 100 * LOGITS_ATOL  # the comparison is not between near-zeros
    names = set(tnet.state_dict())
    net, block, hidden = MODEL_CASES[case]
    assert all(f"seg_hidden_linear_{i}.kernel" in names for i in range(hidden))
    assert f"seg_hidden_norm_{hidden}.scale" not in names
    if block != "resnetformer":
        assert "encoder.block_1_0.skip_path.gamma" in names and "encoder.block_1_0.norm_2.scale" not in names
    if net == "seg":
        assert {"decoder.conv_0.conv_weights", "seg_norm_1.scale", "seg_norm_2.scale"} <= names


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_train_step_matches_jax_trainer(case):
    jcfg, tcfg = _cfgs()
    jnet, tnet = _nets(case, max_path_drop=0.5)
    jbatch = _jbatch()
    jtrainer, _, _, v, _ = _start(jnet, jcfg, jbatch)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
                       calib=v["calib"], opt_state=capture_grads().init(v["params"]))
    order = []
    key = jax.random.PRNGKey(7)
    with fnn.intercept_methods(droppath_interceptor(order, reference_bn=True)):
        new_state, metrics = jtrainer.train_step(state, jbatch, key)
    keep_masks, _ = pop_keep_masks(new_state.batch_stats, order)
    assert len(keep_masks) >= 1

    tnet = _load(tnet, v)
    opt = schedule.make_optimizer(tnet.parameters(), 5e-3, 100, clip_grad_norm=100.0)
    trainer = Trainer(tnet, tcfg, label_smoothing=0.2, optimizer=opt)
    assert trainer.task == "segmentation"
    pts, mask, feats, labels = tiny_batch()
    rng_h, _ = jax.random.split(jax.random.fold_in(key, 0))
    out = trainer.train_step(
        {"positions": t(pts), "mask": t(mask), "features": t(feats), "labels": t(labels)},
        draws=jax_hierarchy_draws(rng_h, jcfg, 2, pts.shape[1]),
        drop_masks=[t(m) for m in keep_masks])
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-5)
    assert float(out["grad_norm"]) < 100.0  # unclipped, so p.grad is the raw gradient
    ref_grads = flat_tree(new_state.opt_state)
    ours = {name: p.grad for name, p in tnet.named_parameters()}
    assert set(ours) == set(ref_grads)
    norm = float(metrics["grad_norm"])
    for name, ref in ref_grads.items():
        err = np.abs(ours[name].numpy() - ref).max()
        assert err <= STEP_GRAD_TOL * max(np.abs(ref).max(), GRAD_FLOOR * norm), (name, err)
