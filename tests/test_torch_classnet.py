"""The port's classification path against the JAX package.

On the same numpy inputs:

* ``global_pool`` with each of the masked poolers (``sum``, ``avg``,
  ``max``, ``min``) on ``[B, N, C]`` and ``[B, N, F, C]`` features, with
  padded rows and one all-masked cloud (the JAX fill values and the
  ``max(count, 1)`` of ``avg`` give the same numbers for it);
* the classification loss, with and without an example mask;
* ``hierarchy_config_from_model_dict`` on the ModelNet40 recipes (no
  ``output_subsample``) and a DFaust one, with ``with_output`` unset, True
  and False;
* a tiny ClassNet (two trunk levels of widths 8 and 16, one block each,
  small capacities) of each classification preset, the equivariant one
  with PCA and with random SO(3) frames (weights carried over by
  ``from_flax``): calibration buffers and logits within 2e-4 on one
  JAX-built hierarchy;
* one classification train step of the port's ``Trainer`` against the JAX
  ``Trainer(TrainSettings(task="classification"))`` on a batch with one
  all-masked filler cloud: loss, gradient norm, per-leaf gradients and BN
  statistics, with the DropPath keep masks of the JAX run injected.  At
  F = 2 the JAX run goes through the interceptor that gives its
  ``MaskedBatchNorm`` the reference's (points x frames) row count
  (``tests/test_torch_train.py::test_jax_train_batchnorm_counts_points_not_frames``);
* the three pinned ModelNet40 recipes against their YAML, each built on the
  CPU when asked, and ``build_model_from_config`` raising without a card.
"""
import dataclasses
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (TINY, capture_grads, droppath_interceptor, flat_tree,
                                jax_hierarchy_draws, pop_keep_masks, randomize, t,
                                to_torch_hierarchy)

from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.core import pointcloud as jpc
from se3conv3d_tpu.models import ClassNet as JClassNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu.train import losses as jlosses
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu.train.trainer import TrainSettings, TrainState
from se3conv3d_tpu_torch.core import hierarchy as thier
from se3conv3d_tpu_torch.core.pointcloud import PointCloud, global_pool
from se3conv3d_tpu_torch.models import ClassNet, FPNSegUNet, get_model_spec, presets
from se3conv3d_tpu_torch.nn.conv import PNEConv
from se3conv3d_tpu_torch.train import config, losses, schedule
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole-model logits (the repo's bound), and the whole train step per leaf
# (tests/test_torch_train.py)
LOGITS_ATOL = 2e-4
STEP_GRAD_TOL, GRAD_FLOOR, BN_RTOL = 1e-4, 1e-2, 1e-5
CLASSES = 7


# --- global pooling -----------------------------------------------------------


@pytest.mark.parametrize("frames", [0, 3])
@pytest.mark.parametrize("method", ["sum", "avg", "max", "min"])
def test_global_pool_matches_jax(method, frames):
    """``[3, 10, (F,) 5]`` features: the second cloud has 4 padded rows
    (holding large values the pool must not see), the third is all masked."""
    rng = np.random.default_rng(0)
    shape = (3, 10) + ((frames,) if frames else ()) + (5,)
    x = rng.normal(size=shape).astype(np.float32)
    mask = np.arange(10)[None] < np.array([10, 6, 0])[:, None]
    x[1, 6:] = 100.0
    pos = rng.normal(size=(3, 10, 3)).astype(np.float32)
    want = np.asarray(jpc.global_pool(jpc.PointCloud(jnp.asarray(pos), jnp.asarray(mask)),
                                      jnp.asarray(x), method))
    got = global_pool(PointCloud(t(pos), t(mask)), t(x), method).numpy()
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got[1]).max() < 100.0  # the padded rows stayed out
    np.testing.assert_array_equal(got[2], want[2])  # the all-masked cloud: the fill value, or 0
    with pytest.raises(ValueError):
        global_pool(PointCloud(t(pos), t(mask)), t(x), "median")


# --- the classification loss ----------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_classification_loss_matches_jax(masked):
    """Label-smoothed cross entropy of ``[4, 6]`` logits over the batch, the
    last example masked out where ``masked``: the parts and the mean."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 6)).astype(np.float32) * 3.0
    labels = np.array([0, 5, 2, 2], np.int32)
    mask = np.array([True, True, True, not masked])
    kw = dict(label_smoothing=0.2, example_mask=jnp.asarray(mask) if masked else None)
    want = jlosses.classification_loss_parts(jnp.asarray(logits), jnp.asarray(labels), **kw)
    want_mean = jlosses.classification_loss(jnp.asarray(logits), jnp.asarray(labels), **kw)
    kw["example_mask"] = t(mask) if masked else None
    got = losses.classification_loss_parts(t(logits), t(labels), **kw)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-6)
    np.testing.assert_allclose(float(losses.classification_loss(t(logits), t(labels), **kw)),
                               float(want_mean), rtol=1e-6)
    assert float(got[1]) == (3.0 if masked else 4.0)


# --- the repaired hierarchy config --------------------------------------------


HCFG_RECIPES = ["MODELNET40_PCA_2F", "MODELNET40_MC_2F", "MODELNET40_STANDARD", "DFAUST_I_ROT_PCA_2F"]


@pytest.mark.parametrize("with_output", [None, True, False])
@pytest.mark.parametrize("recipe", HCFG_RECIPES)
def test_hierarchy_config_matches_jax(recipe, with_output):
    """The port's ``hierarchy_config_from_model_dict`` equals the JAX
    package's: a recipe without ``output_subsample`` (ModelNet40) or
    ``with_output=False`` has no output subsample (the raw cloud is the
    output); a segmentation recipe keeps its output cell otherwise."""
    model = getattr(presets, f"{recipe}_MODEL")
    for train in (True, False):
        ours = presets.hierarchy_config_from_model_dict(model, 4096, train, with_output=with_output)
        ref = jconfig.hierarchy_config_from_model_dict(model, 4096, train, with_output=with_output)
        for field in dataclasses.fields(ours):
            a, b = getattr(ours, field.name), getattr(ref, field.name)
            if field.name == "frames" and a is not None:
                assert {f.name: getattr(a, f.name) for f in dataclasses.fields(a)} == {
                    f.name: getattr(b, f.name) for f in dataclasses.fields(a)}
            else:
                assert a == b, (field.name, a, b)
    out_cell = presets.hierarchy_config_from_model_dict(model, 4096, with_output=with_output).out_cell_size
    assert (out_cell is None) == (with_output is False or "output_subsample" not in model)


# --- the tiny ClassNet ----------------------------------------------------------


# name: (preset, frames: None, or (F, PCA frames))
TINY_CASES = {
    "standard": ("ClassNetMLPGELU19Former", None),
    "equiv_pca": ("ClassNetRotEquivMLPGELU19Former", (2, True)),
    "equiv_mc": ("ClassNetRotEquivMLPGELU19Former", (2, False)),
    "equiv_max_pca": ("ClassNetRotEquivMLPGELU19FormerMax", (2, True)),
}
# the classification hierarchy: no output subsample (the raw cloud is the output)
CLASS_HCFG = dict(init_cell_size=0.08, cell_sizes=(0.16, 0.32), capacities=(128, 64, 32))


def _class_batch(filler: bool):
    """Numpy ``(positions, mask, features, labels)`` of 3 clouds of 200
    points; the second has a masked tail of 30 points; with ``filler`` the
    third has none (a filler cloud), else it is full."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(3, 200, 3)).astype(np.float32)
    pts[..., 1] *= 1.5
    mask = np.arange(200)[None] < np.array([200, 170, 0 if filler else 200])[:, None]
    feats = np.ones((3, 200, 1), np.float32)
    labels = np.array([3, 0, 5], np.int32)
    return pts, mask, feats, labels


def _configs(frames):
    fj = ft = None
    if frames is not None:
        fkw = dict(n_frames=frames[0], neigh_k=8, pca=frames[1])
        fj, ft = jhier.FrameConfig(**fkw), thier.FrameConfig(**fkw)
    return jhier.HierarchyConfig(**CLASS_HCFG, frames=fj), thier.HierarchyConfig(**CLASS_HCFG, frames=ft)


@functools.lru_cache(maxsize=None)
def _jax_case(name, filler=False):
    """The tiny JAX ClassNet of ``name`` with randomized, calibrated state on
    one JAX-built hierarchy, and its eval logits."""
    preset, frames = TINY_CASES[name]
    cfg, _ = _configs(frames)
    spec = dataclasses.replace(jget_spec(preset), **TINY, max_path_drop=0.5)
    model = JClassNet(spec, num_in_feats=1, num_classes=CLASSES)
    pts, mask, feats, labels = _class_batch(filler)
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
              "features": jnp.asarray(feats), "labels": jnp.asarray(labels)}
    settings = TrainSettings(label_smoothing=0.2, task="classification")
    jtrainer = JTrainer(model, cfg, capture_grads(), settings, donate_state=False)
    h, f0, out_pc, out_labels, _ = jax.jit(jtrainer._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, train=False)
    rng = np.random.default_rng(4)
    params, stats = randomize(v["params"], rng), randomize(v["batch_stats"], rng)
    apply = jax.jit(model.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply({"params": params, "batch_stats": stats, "calib": v["calib"]}, h, f0,
                   train=False, calibrate=True, mutable=("calib",))
    variables = {"params": params, "batch_stats": stats, "calib": mut["calib"]}
    logits = np.asarray(apply(variables, h, f0, train=False))
    return dict(cfg=cfg, jbatch=jbatch, jtrainer=jtrainer, h=h, f0=f0, out_pc=out_pc,
                out_labels=out_labels, v=v, variables=variables, logits=logits)


def _port_model(preset, variables):
    spec = dataclasses.replace(get_model_spec(preset), **TINY, max_path_drop=0.5)
    model = ClassNet(spec, num_in_feats=1, num_classes=CLASSES)
    model.load_state_dict(from_flax(*(jax.device_get(variables[c])
                                      for c in ("params", "batch_stats", "calib"))))
    return model


@pytest.mark.parametrize("name", sorted(TINY_CASES))
def test_tiny_classnet_calibration_and_logits_match_jax(name):
    """Weights carried over strictly by ``from_flax`` (the flax names
    ``encoder``, ``class_norm``, ``class_head``); the calibration pass on
    the JAX hierarchy gives JAX's buffers (rtol 1e-6) and the eval logits
    ``[B, classes]`` agree within 2e-4."""
    preset, frames = TINY_CASES[name]
    jm = _jax_case(name)
    model = _port_model(preset, {**jm["variables"], "calib": jm["v"]["calib"]}).eval()
    convs = [mod for mod in model.modules() if isinstance(mod, PNEConv)]
    assert len(convs) == 2 + 2 + 1  # patch stem, one block per level, one down conv
    assert all(c.equivariant == (frames is not None) for c in convs)
    h, f0 = to_torch_hierarchy(jm["h"]), t(jm["f0"])
    assert f0.dim() == (3 if frames is None else 4)
    with torch.no_grad():
        model(h, f0, calibrate=True)
        logits = model(h, f0).numpy()
    ref = flat_tree(jm["variables"]["calib"])
    ours = {k: v.numpy() for k, v in model.state_dict().items() if k in ref}
    assert set(ours) == set(ref) and len(ref) == 4 * len(convs)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)
    assert logits.shape == (3, CLASSES)
    np.testing.assert_allclose(logits, jm["logits"], atol=LOGITS_ATOL, rtol=0)
    assert np.abs(jm["logits"]).max() > 0.1


def test_global_equiv_featurevector_is_not_ported():
    """The option once raised here; it now builds the global feature-vector
    layers in place of the classification head
    (``tests/test_torch_global_featurevector.py`` holds them against JAX)."""
    spec = dataclasses.replace(get_model_spec("ClassNetRotEquivMLPGELU19Former"), **TINY,
                               global_equiv_featurevector=True)
    names = set(ClassNet(spec, num_in_feats=1, num_classes=CLASSES).state_dict())
    assert "global_conv_down.conv_weights" in names
    assert not any(k.startswith(("class_norm.", "class_head.")) for k in names)


# --- one classification train step ------------------------------------------------


@pytest.mark.parametrize("name", ["standard", "equiv_pca"])
def test_classification_train_step_matches_jax_trainer(name):
    """One train step of the tiny ClassNet against the JAX trainer's, on 3
    clouds of which the last is an all-masked filler (left out of the loss
    by ``any(out_pc.mask, 1)``, as in JAX): the same weights, hierarchy
    draws and DropPath keep masks; loss, global gradient norm, per-leaf
    gradients (``test_dfaust_standard_train_step_matches_jax_trainer``'s
    bound) and BN statistics."""
    preset, frames = TINY_CASES[name]
    jm = _jax_case(name, filler=True)
    jtrainer, cfg, variables = jm["jtrainer"], jm["cfg"], jm["variables"]
    tx = capture_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], calib=variables["calib"],
                       opt_state=tx.init(variables["params"]))
    order = []
    key = jax.random.PRNGKey(7)
    with fnn.intercept_methods(droppath_interceptor(order, reference_bn=frames is not None)):
        new_state, metrics = jtrainer.train_step(state, jm["jbatch"], key)
    keep_masks, new_stats = pop_keep_masks(new_state.batch_stats, order)
    assert len(keep_masks) == 2  # the two skips of the one block with drop probability 0.5

    tmodel = _port_model(preset, variables)
    opt = schedule.make_optimizer(tmodel.parameters(), 5e-3, 100, clip_grad_norm=100.0)
    _, tcfg = _configs(frames)
    trainer = Trainer(tmodel, tcfg, label_smoothing=0.2, optimizer=opt)
    assert trainer.task == "classification"
    pts, mask, feats, labels = _class_batch(filler=True)
    rng_h, _ = jax.random.split(jax.random.fold_in(key, 0))
    out = trainer.train_step(
        {k: t(x) for k, x in zip(("positions", "mask", "features", "labels"), (pts, mask, feats, labels))},
        draws=jax_hierarchy_draws(rng_h, cfg, 3, pts.shape[1]),
        drop_masks=[t(m) for m in keep_masks],
    )
    assert np.isfinite(float(metrics["loss"]))
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    assert float(out["grad_norm"]) < 100.0  # unclipped, so p.grad is the raw gradient
    ref_grads = flat_tree(new_state.opt_state)
    ours = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(ours) == set(ref_grads)
    norm = float(metrics["grad_norm"])
    for n, ref in ref_grads.items():
        err = np.abs(ours[n].numpy() - ref).max()
        assert err <= STEP_GRAD_TOL * max(np.abs(ref).max(), GRAD_FLOOR * norm), (n, err)
    for n, ref in flat_tree(new_stats).items():
        np.testing.assert_allclose(tmodel.get_buffer(n).numpy(), ref, rtol=BN_RTOL, atol=1e-6, err_msg=n)

    # the loss leaves the filler cloud out: with its label changed it stays the same
    ev = trainer.eval_step({k: t(x) for k, x in zip(("positions", "mask", "features", "labels"),
                                                    (pts, mask, feats, labels))},
                           draws=jax_hierarchy_draws(rng_h, cfg, 3, pts.shape[1]))
    relabelled = trainer.eval_step({k: t(x) for k, x in zip(("positions", "mask", "features", "labels"),
                                                            (pts, mask, feats, np.array([3, 0, 1])))},
                                   draws=jax_hierarchy_draws(rng_h, cfg, 3, pts.shape[1]))
    assert ev["logits"].shape == (3, CLASSES) and torch.equal(ev["labels"], t(labels))
    assert float(ev["loss"]) == float(relabelled["loss"])


def test_classification_rejects_scan_scenes():
    """The trainer takes its task from the model, rejects ``scan_scenes``
    for a ClassNet, and a ClassNet takes no output cloud: a third
    positional argument (a segmentation call) raises instead of being read
    as ``calibrate``."""
    spec = dataclasses.replace(get_model_spec("ClassNetMLPGELU19Former"), **TINY)
    model = ClassNet(spec, 1, CLASSES)
    with pytest.raises(ValueError, match="scan_scenes"):
        Trainer(model, _configs(None)[1], scan_scenes=True)
    trainer = Trainer(model, _configs(None)[1])
    assert trainer.task == "classification"
    seg_spec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluFAUST"), **TINY)
    assert Trainer(FPNSegUNet(seg_spec, 1, CLASSES), _configs(None)[1]).task == "segmentation"
    pts, mask, feats, _ = _class_batch(filler=False)
    h, f0, out_pc, _, _ = trainer.build({"positions": t(pts), "mask": t(mask), "features": t(feats)})
    with pytest.raises(TypeError):
        model(h, f0, out_pc)


# --- the pinned recipes -----------------------------------------------------------


RECIPES = ("modelnet40_MC_2F", "modelnet40_pca_2F", "modelnet40_standard")


@pytest.mark.parametrize("recipe", RECIPES)
def test_pinned_modelnet40_recipe_matches_yaml_and_builds(recipe):
    """The pinned ``Model`` and ``Training`` sections equal the YAML file as
    ``train/config.py`` reads it; the spec equals the JAX package's; the
    hierarchy has no output subsample; ``build_model_from_config`` builds a
    ClassNet of 25 convs (2 patch, 19 block, 4 down) on the CPU when asked."""
    pinned = recipe.upper()
    cfg = jconfig.load_yaml_config(os.path.join(REPO, "configs", "modelnet40", f"{recipe}.yaml"))
    model_dict = getattr(presets, f"{pinned}_MODEL")
    assert model_dict == cfg["Model"]
    assert getattr(presets, f"{pinned}_TRAINING") == cfg["Training"]
    assert cfg["Dataset"]["num_points"] == presets.MODELNET40_NUM_POINTS
    ours = presets.spec_from_model_dict(model_dict)
    ref = jconfig.build_model_from_config(cfg["Model"], presets.MODELNET40_NUM_FEATURES,
                                          presets.MODELNET40_NUM_CLASSES).spec
    for field in dataclasses.fields(ours):
        if field.name in ("conv", "conv_blocks"):
            for k in ("num_basis", "pne_type", "equivariant", "aggregation"):
                assert getattr(getattr(ours, field.name), k) == getattr(getattr(ref, field.name), k)
        else:
            assert getattr(ours, field.name) == getattr(ref, field.name), field.name
    hcfg = presets.hierarchy_config_from_model_dict(model_dict, presets.MODELNET40_NUM_POINTS)
    assert hcfg.out_cell_size is None and hcfg.capacities == tuple(model_dict["capacities"])
    assert (hcfg.frames is None) == ("RefFrames" not in model_dict)
    model = config.build_model_from_config(model_dict, presets.MODELNET40_NUM_FEATURES,
                                           presets.MODELNET40_NUM_CLASSES, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    assert isinstance(model, ClassNet) and next(model.parameters()).device.type == "cpu"
    convs = [mod for mod in model.modules() if isinstance(mod, PNEConv)]
    assert len(convs) == 25
    assert all(c.equivariant == ours.equivariant and c.compute_dtype is None for c in convs)
    assert tuple(model.class_head.kernel.shape) == (512, presets.MODELNET40_NUM_CLASSES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config.build_model_from_config(model_dict, presets.MODELNET40_NUM_FEATURES,
                                           presets.MODELNET40_NUM_CLASSES)
