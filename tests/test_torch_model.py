"""The port's DFaust segmentation slice against the JAX package.

A tiny FPNSegUNetMLPGeluRotEqFAUST (two trunk levels, widths <= 16, B=2,
200 points) with weights carried over by ``utils.weights.from_flax``:

* one JAX-built hierarchy through both models: calibration buffers agree
  to float32 rounding (rtol 1e-6) and eval logits within 2e-4, the repo's
  whole-model bound;
* the whole eval path -- hierarchy build from the JAX package's injected
  draws, calibration step, eval step -- against the JAX package's;
* the pinned recipe dict equals the YAML file as ``train/config.py`` reads it.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (HCFG, NUM_CLASSES, TINY, jax_hierarchy_draws, randomize, t,
                                tiny_batch, to_torch_cloud, to_torch_hierarchy)

from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu.train.losses import masked_segmentation_loss
from se3conv3d_tpu_torch.core import hierarchy as thier
from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec
from se3conv3d_tpu_torch.models import presets
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_model():
    spec = dataclasses.replace(jget_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY)
    cfg = jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(n_frames=2, neigh_k=8))
    pts, mask, feats, labels = tiny_batch()
    build = jax.jit(jhier.build_hierarchy, static_argnums=(4,))
    key = jax.random.PRNGKey(3)
    h, f0, out_pc, out_labels, raw_to_out = build(
        key, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats), cfg, jnp.asarray(labels)
    )
    f0 = jnp.repeat(f0[:, :, None, :], 2, axis=2)
    model = JNet(spec, num_in_feats=1, num_classes=NUM_CLASSES)
    init = jax.jit(model.init, static_argnames=("train",))
    v = init({"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)},
             h, f0, out_pc, train=False)
    rng = np.random.default_rng(4)
    v = {"params": randomize(v["params"], rng),
         "batch_stats": randomize(v["batch_stats"], rng), "calib": v["calib"]}
    apply = jax.jit(model.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply(v, h, f0, out_pc, train=False, calibrate=True, mutable=("calib",))
    calibrated = {**v, "calib": mut["calib"]}
    logits = apply(calibrated, h, f0, out_pc, train=False)
    return dict(spec=spec, cfg=cfg, key=key, h=h, f0=f0, out_pc=out_pc, out_labels=out_labels,
                raw_to_out=raw_to_out, v=v, calibrated=calibrated, logits=np.asarray(logits))


def _port_model(v):
    spec = dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY)
    model = FPNSegUNet(spec, num_in_feats=1, num_classes=NUM_CLASSES,
                       generator=torch.Generator().manual_seed(0))
    model.load_state_dict(from_flax(*(jax.device_get(v[c]) for c in ("params", "batch_stats", "calib"))))
    return model.eval()


def _calib_dict(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.rsplit(".", 1)[-1] in ("norm_neigh_dist", "norm_num_neighs", "initialized", "trunc_frac")}


def _flat_calib(calib):
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(calib))[0]
    return {".".join(p.key for p in path): np.asarray(x) for path, x in flat}


def test_calibration_and_logits_on_one_jax_hierarchy(jax_model):
    jm = jax_model
    model = _port_model(jm["v"])
    h = to_torch_hierarchy(jm["h"])
    f0, out_pc = t(jm["f0"]), to_torch_cloud(jm["out_pc"])
    with torch.no_grad():
        model(h, f0, out_pc, calibrate=True)
        logits = model(h, f0, out_pc).numpy()
    ours, ref = _calib_dict(model), _flat_calib(jm["calibrated"]["calib"])
    assert set(ours) == set(ref) and len(ours) == 4 * 9  # 9 convs in the tiny model
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)
    assert logits.shape == (2, HCFG["out_capacity"], NUM_CLASSES)
    np.testing.assert_allclose(logits, jm["logits"], atol=2e-4, rtol=0)
    assert np.abs(jm["logits"]).max() > 0.1  # the comparison is not between near-zeros


def test_trainer_eval_slice_matches_jax(jax_model):
    jm = jax_model
    model = _port_model(jm["v"])
    tcfg = thier.HierarchyConfig(**HCFG, frames=thier.FrameConfig(n_frames=2, neigh_k=8))
    trainer = Trainer(model, tcfg, label_smoothing=0.2)
    pts, mask, feats, labels = tiny_batch()
    batch = {"positions": t(pts), "mask": t(mask), "features": t(feats), "labels": t(labels)}
    draws = jax_hierarchy_draws(jm["key"], jm["cfg"], 2, pts.shape[1])
    trainer.calibration_step(batch, draws=draws)
    out = trainer.eval_step(batch, draws=draws)
    ref_calib = _flat_calib(jm["calibrated"]["calib"])
    for k, v in _calib_dict(model).items():
        np.testing.assert_allclose(v, ref_calib[k], rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(jm["out_pc"].mask))
    np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(jm["out_labels"]))
    np.testing.assert_array_equal(out["out_idx"].numpy(), np.asarray(jm["raw_to_out"].chosen_idx))
    np.testing.assert_allclose(out["logits"].numpy(), jm["logits"], atol=2e-4, rtol=0)
    ref_loss = masked_segmentation_loss(jnp.asarray(jm["logits"]), jm["out_labels"],
                                        jm["out_pc"].mask, 0.2)
    np.testing.assert_allclose(float(out["loss"]), float(ref_loss), rtol=1e-5)


def test_pinned_recipe_matches_yaml():
    path = os.path.join(REPO, "configs", "dfaust", "dfaust_I_rot_pca_2F.yaml")
    cfg = jconfig.load_yaml_config(path)
    assert presets.DFAUST_I_ROT_PCA_2F_MODEL == cfg["Model"]
    assert presets.DFAUST_NUM_POINTS == cfg["Dataset"]["num_points"]
    for train in (True, False):
        ours = presets.hierarchy_config_from_model_dict(
            presets.DFAUST_I_ROT_PCA_2F_MODEL, presets.DFAUST_NUM_POINTS, train)
        ref = jconfig.hierarchy_config_from_model_dict(cfg["Model"], cfg["Dataset"]["num_points"], train)
        for field in dataclasses.fields(ours):
            if field.name != "frames":
                assert getattr(ours, field.name) == getattr(ref, field.name), field.name
        for field in dataclasses.fields(ours.frames):
            assert getattr(ours.frames, field.name) == getattr(ref.frames, field.name), field.name
    ours = presets.spec_from_model_dict(presets.DFAUST_I_ROT_PCA_2F_MODEL)
    ref = jconfig.build_model_from_config(cfg["Model"], 1, presets.DFAUST_NUM_CLASSES).spec
    for field in dataclasses.fields(ours):
        if field.name in ("conv", "conv_blocks"):
            for k in ("num_basis", "pne_type", "equivariant", "rel_rot_type", "aggregation"):
                assert getattr(getattr(ours, field.name), k) == getattr(getattr(ref, field.name), k)
        else:
            assert getattr(ours, field.name) == getattr(ref, field.name), field.name
