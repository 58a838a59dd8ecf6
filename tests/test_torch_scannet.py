"""The port's ScanNet-20 segmentation path against the JAX package.

A tiny ScanNet-shaped FPNSegUNetMLPGeluRotEqScanNet (no patch stem, three
trunk levels of widths <= 16, one PCA frame, six input features, 21
classes with label 0 ignored), weights carried over by
``utils.weights.from_flax``:

* one JAX-built hierarchy through both models, with ``GRID_AUTO_THRESHOLD``
  lowered in both packages so every ball query inside the models (self,
  down, decoder, FPN and the query-side output-cloud head) takes the grid:
  logits within 2e-4, the repo's whole-model bound;
* one ``scan_scenes`` train step at B=2 against the JAX package's
  ``_train_step_scan``: the port in 'sorted' backward mode, JAX on its
  default path (the modes are gradient-equal, ``tests/test_torch_segsum.py``;
  the JAX whole-model sorted test runs interpret-mode Pallas and is marked
  slow).  Same weights, per-scene hierarchy draws and DropPath keep masks;
  loss, gradients, BN statistics and the parameters after the AdamW step
  are compared;
* the pinned ScanNet dicts against the YAML file, and the model-building
  entry point's device rule.
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

from torch_port_helpers import (droppath_interceptor, flat_tree, jax_hierarchy_draws,
                                pop_keep_masks, randomize, t, to_torch_cloud, to_torch_hierarchy)

from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.core import neighborhoods as jneigh
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu.train import schedule as jschedule
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu.train.trainer import TrainSettings, TrainState
from se3conv3d_tpu_torch.core import hierarchy as thier
from se3conv3d_tpu_torch.core import neighborhoods
from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec, presets
from se3conv3d_tpu_torch.ops import pne_conv as ops
from se3conv3d_tpu_torch.train import config, schedule
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "FPNSegUNetMLPGeluRotEqScanNet"
SMALL = dict(num_blocks=(1, 1, 2), num_features=(8, 16, 16), fpn_dec_feats=8, max_neighbors=8,
             max_path_drop=0.5)
HCFG = dict(init_cell_size=0.08, cell_sizes=(0.16, 0.32), capacities=(128, 64, 32),
            out_cell_size=0.1, out_capacity=128)
FEATS, CLASSES, IGNORE = presets.SCANNET_NUM_FEATURES, presets.SCANNET20_NUM_CLASSES, 0
# gradients per leaf, as tests/test_torch_train.py: max |port - JAX| <=
# GRAD_TOL * max(max |JAX leaf|, GRAD_FLOOR * grad_norm); BN statistics
# within BN_RTOL
GRAD_TOL, GRAD_FLOOR, BN_RTOL = 1e-4, 1e-2, 1e-5


def _batch(seed=0, b=2, n=200):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(b, n, 3)).astype(np.float32)
    pts[..., 1] *= 1.5
    mask = np.arange(n)[None] < np.array([n, n - 30])[:, None]
    feats = rng.normal(size=(b, n, FEATS)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=(b, n)).astype(np.int32)  # ~5% ignored label 0
    return pts, mask, feats, labels


def _port_model(params, stats, calib):
    spec = dataclasses.replace(get_model_spec(NAME), **SMALL)
    model = FPNSegUNet(spec, num_in_feats=FEATS, num_classes=CLASSES)
    model.load_state_dict(from_flax(*(jax.device_get(x) for x in (params, stats, calib))))
    return model


@pytest.fixture(scope="module")
def jax_model():
    pts, mask, feats, labels = _batch()
    jbatch = {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask),
              "features": jnp.asarray(feats), "labels": jnp.asarray(labels)}
    spec = dataclasses.replace(jget_spec(NAME), **SMALL)
    cfg = jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(n_frames=1, neigh_k=8))
    model = JNet(spec, num_in_feats=FEATS, num_classes=CLASSES)
    jtrainer = JTrainer(model, cfg, optax.identity(), donate_state=False)
    h, f0, out_pc, _, _ = jax.jit(jtrainer._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc,
        train=False)
    rng = np.random.default_rng(4)
    params, stats = randomize(v["params"], rng), randomize(v["batch_stats"], rng)
    apply = jax.jit(model.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply({"params": params, "batch_stats": stats, "calib": v["calib"]}, h, f0, out_pc,
                   train=False, calibrate=True, mutable=("calib",))
    return dict(cfg=cfg, model=model, jtrainer=jtrainer, jbatch=jbatch, h=h, f0=f0, out_pc=out_pc,
                params=params, stats=stats, calib=mut["calib"], batch=(pts, mask, feats, labels))


def test_logits_match_jax_with_grid_neighborhoods(jax_model, monkeypatch):
    jm = jax_model
    monkeypatch.setattr(neighborhoods, "GRID_AUTO_THRESHOLD", 32)
    monkeypatch.setattr(jneigh, "GRID_AUTO_THRESHOLD", 32)
    calls = []
    real = neighborhoods.grid_ball_query_neighborhood
    monkeypatch.setattr(neighborhoods, "grid_ball_query_neighborhood",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    variables = {"params": jm["params"], "batch_stats": jm["stats"], "calib": jm["calib"]}
    ref = np.asarray(jax.jit(jm["model"].apply, static_argnames=("train",))(
        variables, jm["h"], jm["f0"], jm["out_pc"], train=False))
    model = _port_model(jm["params"], jm["stats"], jm["calib"]).eval()
    with torch.no_grad():
        got = model(to_torch_hierarchy(jm["h"]), t(jm["f0"]), to_torch_cloud(jm["out_pc"])).numpy()
    # 9 neighborhoods (3 self, 2 down, 2 decoder, 1 more FPN, the head), all
    # through the grid; the head's query side is the 128-point output cloud
    assert len(calls) == 9
    assert got.shape == (2, HCFG["out_capacity"], CLASSES)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    assert np.abs(ref).max() > 0.1


def _adamw_keeping_grads(tx):
    """``tx`` whose state also keeps the gradients it was handed."""
    return optax.GradientTransformation(
        init=lambda p: (tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        update=lambda g, s, p=None: (lambda u: (u[0], (u[1], g)))(tx.update(g, s[0], p)),
    )


def test_scan_scenes_train_step_matches_jax(jax_model, monkeypatch):
    jm = jax_model
    pts, mask, feats, labels = jm["batch"]
    tx = jschedule.make_optimizer(5e-3, total_steps=100, weight_decay=1e-4, clip_grad_norm=100.0)
    jtrainer = JTrainer(jm["model"], jm["cfg"], _adamw_keeping_grads(tx),
                        TrainSettings(label_smoothing=0.2, ignore_label=IGNORE, scan_scenes=True),
                        donate_state=False)
    params = jm["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=jm["stats"],
                       calib=jm["calib"], opt_state=_adamw_keeping_grads(tx).init(params))
    key = jax.random.PRNGKey(7)
    new_state, metrics = jtrainer.train_step(state, jm["jbatch"], key)

    # the DropPath keep masks the scan drew, scene by scene: flax derives
    # them from (rng, module path), so an intercepted apply of scene i with
    # the scan's per-scene rng draws the same ones
    rng_h, rng_d = jax.random.split(jax.random.fold_in(key, 0))
    draws, masks = [], []
    for i in range(2):
        scene = {k: v[i : i + 1] for k, v in jm["jbatch"].items()}
        h, f0, out_pc, _, _ = jtrainer._build(jax.random.fold_in(rng_h, i), scene)
        order = []
        with fnn.intercept_methods(droppath_interceptor(order, reference_bn=False)):
            _, mut = jm["model"].apply(
                {"params": params, "batch_stats": jm["stats"], "calib": jm["calib"]},
                h, f0, out_pc, train=True, mutable=["batch_stats"],
                rngs={"droppath": jax.random.fold_in(rng_d, i)})
        keep, _ = pop_keep_masks(mut["batch_stats"], order)
        assert len(keep) == 6  # two skips in each of the 3 blocks with drop probability > 0
        masks.append([t(m) for m in keep])
        draws.append(jax_hierarchy_draws(jax.random.fold_in(rng_h, i), jm["cfg"], 1, pts.shape[1]))

    monkeypatch.setattr(ops, "BWD_SCATTER_MODE", "sorted")
    tmodel = _port_model(params, jm["stats"], jm["calib"])
    opt = schedule.make_optimizer(tmodel.parameters(), 5e-3, 100, weight_decay=1e-4,
                                  clip_grad_norm=100.0)
    tcfg = thier.HierarchyConfig(**HCFG, frames=thier.FrameConfig(n_frames=1, neigh_k=8))
    trainer = Trainer(tmodel, tcfg, label_smoothing=0.2, ignore_label=IGNORE, optimizer=opt,
                      scan_scenes=True)
    batch = {k: t(x) for k, x in zip(("positions", "mask", "features", "labels"),
                                     (pts, mask, feats, labels))}
    out = trainer.train_step(batch, draws=draws, drop_masks=masks)
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    norm = float(metrics["grad_norm"])
    assert norm < 100.0  # unclipped, so p.grad is the raw count-weighted gradient

    ref_grads = flat_tree(new_state.opt_state[1])
    ref_params = flat_tree(new_state.params)
    before = flat_tree(params)
    lr = 5e-3 / 25.0  # the step's learning rate: max_lr / div_factor
    moved = 0
    for name, p in tmodel.named_parameters():
        ref_g, g = ref_grads[name], p.grad.numpy()
        scale = max(np.abs(ref_g).max(), GRAD_FLOOR * norm)
        assert np.abs(g - ref_g).max() <= GRAD_TOL * scale, (name, np.abs(g - ref_g).max(), scale)
        # AdamW's first step moves each weight by lr * g / (|g| + eps) (+ decay):
        # equal wherever the gradient stands above the rounding that separates
        # the two, at most 2 lr apart where it is rounding noise
        sure = np.abs(ref_g) > 10 * GRAD_TOL * scale
        diff = np.abs(p.detach().numpy() - ref_params[name])
        assert diff[sure].max(initial=0.0) <= 1e-6, name
        assert diff.max() <= 2 * lr + 1e-6, name
        if np.abs(ref_g).max() > 0:  # (a branch dropped in both scenes has none)
            assert not np.array_equal(ref_params[name], before[name]), name
            moved += 1
    assert moved > len(ref_params) // 2
    for name, ref in flat_tree(new_state.batch_stats).items():
        np.testing.assert_allclose(tmodel.get_buffer(name).numpy(), ref, rtol=BN_RTOL, atol=1e-6,
                                   err_msg=name)


def test_pinned_scannet_recipe_matches_yaml():
    path = os.path.join(REPO, "configs", "scannet", "scannet20_rot_pca_I.yaml")
    cfg = jconfig.load_yaml_config(path)
    assert presets.SCANNET20_ROT_PCA_I_MODEL == cfg["Model"]
    assert presets.SCANNET20_ROT_PCA_I_TRAINING == cfg["Training"]
    assert presets.SCANNET_SCENE_MAX_POINTS == cfg["Dataset"]["train_scene_max_pts"]
    model = presets.SCANNET20_ROT_PCA_I_MODEL
    n = presets.SCANNET_SCENE_MAX_POINTS
    for train in (True, False):
        ours = presets.hierarchy_config_from_model_dict(model, n, train)
        ref = jconfig.hierarchy_config_from_model_dict(cfg["Model"], n, train)
        for field in dataclasses.fields(ours):
            if field.name != "frames":
                assert getattr(ours, field.name) == getattr(ref, field.name), field.name
        for field in dataclasses.fields(ours.frames):
            assert getattr(ours.frames, field.name) == getattr(ref.frames, field.name), field.name
    ours = presets.spec_from_model_dict(model)
    ref = jconfig.build_model_from_config(cfg["Model"], FEATS, CLASSES).spec
    for field in dataclasses.fields(ours):
        if field.name in ("conv", "conv_blocks"):
            for k in ("num_basis", "pne_type", "equivariant", "rel_rot_type", "aggregation"):
                assert getattr(getattr(ours, field.name), k) == getattr(getattr(ref, field.name), k)
        else:
            assert getattr(ours, field.name) == getattr(ref, field.name), field.name


def test_build_model_from_config_runs_on_the_card_unless_asked_for_the_cpu():
    f32 = {**presets.SCANNET20_ROT_PCA_I_MODEL, "compute_dtype": "float32"}
    if torch.cuda.is_available():
        model = config.build_model_from_config(f32, FEATS, CLASSES)
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            config.build_model_from_config(f32, FEATS, CLASSES)
    model = config.build_model_from_config(f32, FEATS, CLASSES, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    assert next(model.parameters()).device.type == "cpu"
    assert model.spec.patch_num_levels == 0 and model.spec.num_features == (64, 128, 192, 256, 320)
    convs = [m for m in model.modules() if hasattr(m, "conv_weights")]
    assert len(convs) == 32  # 19 blocks, 4 down, 4 decoder, 4 FPN, 1 head
    trainer = Trainer(model, presets.hierarchy_config_from_model_dict(f32, 1000))
    assert trainer.device.type == "cpu"
    # the recipe's compute_dtype (bfloat16) builds (tests/test_torch_bf16.py); a
    # dtype the port's convs do not compute in raises
    with pytest.raises(NotImplementedError):
        config.build_model_from_config({**presets.SCANNET20_ROT_PCA_I_MODEL, "compute_dtype": "float16"},
                                       FEATS, CLASSES, device="cpu")
