"""Models built with other conv kinds against the JAX package.

A user picks a conv kind with ``get_model_spec(name, conv=ConvFactory(...),
conv_blocks=ConvFactory(...))`` in both packages (``ModelSpec`` copies
``conv`` into ``conv_blocks`` when it is built, so a ``dataclasses.replace``
of ``conv`` alone would leave the block stack on ``mlp_gelu``: both are
replaced here).  On the tiny segmentation model of
``tests/torch_port_helpers.py``, on one JAX-built hierarchy:

* the standard ``FPNSegUNetMLPGeluFAUST`` with ``kp_gauss`` (P = 13) and the
  equivariant ``FPNSegUNetMLPGeluRotEqFAUST`` with ``mlp_sin`` (PCA frames,
  F = 2): weights carried over strictly by ``from_flax``, the calibration
  buffers against JAX's (rtol 1e-6), the eval logits within 2e-4 (no conv
  rebuilding its geometry: no warning), and one ``Trainer.train_step``
  against the JAX trainer's (the same hierarchy draws and DropPath keep
  masks; loss rtol 1e-5, gradient norm rtol 1e-4, each gradient leaf within
  1e-4 of max(its largest value, 1e-2 x the norm), BN statistics rtol
  1e-5), as ``tests/test_torch_train.py`` holds the gelu models.

``tests/test_torch_model_payloads.py`` holds the other kinds' parameters and
the neighborhood provider's payloads.
"""
import dataclasses
import warnings

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
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu.train.trainer import TrainSettings, TrainState
from se3conv3d_tpu_torch.core import hierarchy as thier
from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec
from se3conv3d_tpu_torch.nn.conv import PNEConv
from se3conv3d_tpu_torch.train import schedule
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

GRAD_TOL, GRAD_FLOOR, BN_RTOL = 1e-4, 1e-2, 1e-5
# name: (preset, conv kind overrides, frames F (None: the standard model))
MODELS = {
    "standard_kp_gauss": ("FPNSegUNetMLPGeluFAUST", dict(pne_type="kp_gauss"), None),
    "equivariant_mlp_sin": ("FPNSegUNetMLPGeluRotEqFAUST", dict(pne_type="mlp_sin"), 2),
}


def with_convs(spec, **kind):
    """``spec`` with both conv factories of the other kind."""
    return dataclasses.replace(spec, conv=dataclasses.replace(spec.conv, **kind),
                               conv_blocks=dataclasses.replace(spec.conv_blocks, **kind))


def _hcfgs(frames):
    if frames is None:
        return jhier.HierarchyConfig(**HCFG), thier.HierarchyConfig(**HCFG)
    fkw = dict(n_frames=frames, neigh_k=8, pca=True)
    return (jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(**fkw)),
            thier.HierarchyConfig(**HCFG, frames=thier.FrameConfig(**fkw)))


@pytest.fixture(scope="module", params=sorted(MODELS))
def jax_model(request):
    """The JAX tiny model of the other conv kind, randomized and calibrated
    on one JAX-built hierarchy, its eval logits and its training state."""
    preset, kind, frames = MODELS[request.param]
    cfg = _hcfgs(frames)[0]
    pts, mask, feats, labels = tiny_batch()
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
              "features": jnp.asarray(feats), "labels": jnp.asarray(labels)}
    spec = with_convs(dataclasses.replace(jget_spec(preset), **TINY, max_path_drop=0.5), **kind)
    model = JNet(spec, num_in_feats=1, num_classes=NUM_CLASSES)
    jtrainer = JTrainer(model, cfg, capture_grads(), TrainSettings(label_smoothing=0.2), donate_state=False)
    h, f0, out_pc, _, _ = jax.jit(jtrainer._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc, train=False)
    rng = np.random.default_rng(4)
    params, stats = randomize(v["params"], rng), randomize(v["batch_stats"], rng)
    apply = jax.jit(model.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply({"params": params, "batch_stats": stats, "calib": v["calib"]}, h, f0, out_pc,
                   train=False, calibrate=True, mutable=("calib",))
    variables = {"params": params, "batch_stats": stats, "calib": mut["calib"]}
    logits = np.asarray(apply(variables, h, f0, out_pc, train=False))
    return dict(name=request.param, cfg=cfg, jbatch=jbatch, jtrainer=jtrainer, h=h, f0=f0,
                out_pc=out_pc, v=v, variables=variables, logits=logits)


def _port_model(name, variables):
    preset, kind, _ = MODELS[name]
    spec = with_convs(dataclasses.replace(get_model_spec(preset), **TINY, max_path_drop=0.5), **kind)
    model = FPNSegUNet(spec, num_in_feats=1, num_classes=NUM_CLASSES)
    model.load_state_dict(from_flax(*(jax.device_get(variables[c]) for c in ("params", "batch_stats", "calib"))))
    return model


def test_calibration_and_logits_match_jax(jax_model):
    jm = jax_model
    model = _port_model(jm["name"], {**jm["variables"], "calib": jm["v"]["calib"]}).eval()
    kind = MODELS[jm["name"]][1]["pne_type"]
    convs = [mod for mod in model.modules() if isinstance(mod, PNEConv)]
    assert len(convs) == 9 and all(c.pne_type == kind and c.fused for c in convs)
    h, f0, out_pc = to_torch_hierarchy(jm["h"]), t(jm["f0"]), to_torch_cloud(jm["out_pc"])
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)  # no conv rebuilds its geometry
        with torch.no_grad():
            model(h, f0, out_pc, calibrate=True)
            logits = model(h, f0, out_pc).numpy()
    ref = flat_tree(jm["variables"]["calib"])
    ours = {k: v.numpy() for k, v in model.state_dict().items() if k in ref}
    assert set(ours) == set(ref) and len(ref) == 4 * 9
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(logits, jm["logits"], atol=2e-4, rtol=0)
    assert np.abs(jm["logits"]).max() > 0.1


def test_train_step_matches_jax_trainer(jax_model):
    jm = jax_model
    jtrainer, cfg, variables = jm["jtrainer"], jm["cfg"], jm["variables"]
    frames = MODELS[jm["name"]][2]
    tx = capture_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], calib=variables["calib"],
                       opt_state=tx.init(variables["params"]))
    order = []
    key = jax.random.PRNGKey(7)
    with fnn.intercept_methods(droppath_interceptor(order, reference_bn=(frames or 1) > 1)):
        new_state, metrics = jtrainer.train_step(state, jm["jbatch"], key)
    keep_masks, new_stats = pop_keep_masks(new_state.batch_stats, order)

    tmodel = _port_model(jm["name"], variables)
    opt = schedule.make_optimizer(tmodel.parameters(), 5e-3, 100, clip_grad_norm=100.0)
    trainer = Trainer(tmodel, _hcfgs(frames)[1], label_smoothing=0.2, optimizer=opt)
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
        assert err <= GRAD_TOL * max(np.abs(ref).max(), GRAD_FLOOR * norm), (name, err)
    for name, ref in flat_tree(new_stats).items():
        np.testing.assert_allclose(tmodel.get_buffer(name).numpy(), ref, rtol=BN_RTOL, atol=1e-6,
                                   err_msg=name)
