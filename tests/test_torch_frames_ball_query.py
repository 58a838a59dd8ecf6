"""PCA frames over a ball-query neighborhood against the JAX package.

``RefFrames.neigh_method: ball_query`` (``neigh_kwargs.bq_radius``): each
point's PCA frames come from up to ``neigh_k`` points, nearest first,
strictly within the radius, and ``n_frames`` of the candidates are kept
per point by ``argsort`` of the same draws the kNN branch uses.  JAX's ball
query carries no neighbor positions, so its ``attach_frames`` takes the
``pca_frames`` branch, as the port does.  On the same numpy inputs and the
JAX package's injected draws:

* the hierarchy's frames on every level and on the output cloud (atol
  1e-5 where the neighborhood's PCA axes are determined: eigenvalues apart
  by more than 5% of their span), at F = 1 and 2, free and fixed-axis;
* ``hierarchy_config_from_model_dict`` on a DFaust recipe dict with
  ``neigh_method: ball_query`` against the JAX package's;
* the tiny FPNSegUNetMLPGeluRotEqFAUST on such a hierarchy through the
  ``Trainer``'s calibration and eval steps: calibration buffers (rtol 1e-6)
  and logits (atol 2e-4) against the JAX model's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (HCFG, NUM_CLASSES, TINY, flat_tree, jax_hierarchy_draws, randomize, t,
                                tiny_batch)

from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu_torch.core import hierarchy as thier
from se3conv3d_tpu_torch.core.neighborhoods import ball_query_neighborhood
from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec, presets
from se3conv3d_tpu_torch.train.trainer import Trainer
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

RADIUS = 0.3
FRAME_ATOL, LOGITS_ATOL = 1e-5, 2e-4


def _configs(**fkw):
    fkw = dict(neigh_method="ball_query", bq_radius=RADIUS, neigh_k=8, **fkw)
    return (jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(**fkw)),
            thier.HierarchyConfig(**HCFG, frames=thier.FrameConfig(**fkw)))


def _well_posed(pc, fixed_axis, rel_gap=5e-2):
    """Points whose ball-query covariance (invalid neighbors filled with
    the center, as both solvers fill them) has eigenvalues apart by more
    than ``rel_gap`` of their span: elsewhere (a ball of one or two points,
    a symmetric one) the PCA axes are not determined by the data, and the
    two packages' float32 rounding picks different ones
    (``tests/test_torch_core.py::test_pca_frames_with_injected_selection``
    masks such points the same way, at a gap of 1e-2 and atol 1e-4: an
    axis moves by about the rounding over the relative gap, so a gap of 5%
    keeps float32 axes within 1e-5)."""
    nb = ball_query_neighborhood(pc, pc, RADIUS, 8)
    pts = pc.positions.numpy().astype(np.float64)
    x = pts[np.arange(pts.shape[0])[:, None, None], nb.idx.numpy()]
    x = np.where(nb.mask.numpy()[..., None], x, pts[:, :, None, :])
    if fixed_axis:
        x[..., int(fixed_axis)] = 0.0
    c = x - x.mean(2, keepdims=True)
    w = np.linalg.eigvalsh(np.einsum("bnki,bnkj->bnij", c, c))
    span = np.maximum(w[..., 2] - w[..., 0], 1e-30)
    return (np.diff(w, axis=-1).min(-1) / span > rel_gap) & pc.mask.numpy(), nb.mask.sum(-1).numpy()


@pytest.mark.parametrize("fkw", [dict(n_frames=1), dict(n_frames=2), dict(n_frames=2, fixed_axis=2)],
                         ids=["F1", "F2", "F2_fixed_z"])
def test_ball_query_frames_match_jax(fkw):
    """Every level's and the output cloud's frames at each well-posed point
    (at least 85% of the valid ones) within 1e-5 of JAX's, every frame a
    rotation."""
    jcfg, tcfg = _configs(**fkw)
    pts, mask, feats, labels = tiny_batch()
    key = jax.random.PRNGKey(5)
    h, _, out_pc, _, _ = jax.jit(jhier.build_hierarchy, static_argnums=(4,))(
        key, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats), jcfg, jnp.asarray(labels))
    th, _, tout, _, _ = thier.build_hierarchy(
        t(pts), t(mask), t(feats), tcfg, t(labels), draws=jax_hierarchy_draws(key, jcfg, 2, pts.shape[1]))
    counts = []
    for i, (a, b) in enumerate(zip(th.levels + (tout,), h.levels + (out_pc,))):
        want = np.asarray(b.frames)
        got = a.frames.numpy()
        assert got.shape == want.shape == a.mask.shape + (fkw["n_frames"], 3, 3), i
        ok, count = _well_posed(a, fkw.get("fixed_axis", False))
        counts.append(count[a.mask.numpy()])
        if i in (0, len(th.levels)):  # the dense levels: level 0 and the output cloud
            assert ok.sum() >= 0.85 * a.mask.sum().item(), (i, ok.mean())
        np.testing.assert_allclose(got[ok], want[ok], atol=FRAME_ATOL, rtol=0, err_msg=f"level {i}")
        valid = a.mask.numpy()
        np.testing.assert_allclose(np.linalg.det(got[valid].astype(np.float64)), 1.0, atol=1e-4)
    # balls capped at neigh_k and balls holding fewer points, on level 0
    assert counts[0].min() < 8 and counts[0].max() == 8 and counts[0].mean() > 6


def test_recipe_dict_reads_ball_query_like_jax():
    model = {**presets.DFAUST_I_ROT_PCA_2F_MODEL,
             "RefFrames": {**presets.DFAUST_I_ROT_PCA_2F_MODEL["RefFrames"], "neigh_method": "ball_query",
                           "neigh_kwargs": {"neigh_k": 16, "bq_radius": 0.1}}}
    for train in (True, False):
        ours = presets.hierarchy_config_from_model_dict(model, presets.DFAUST_NUM_POINTS, train)
        ref = jconfig.hierarchy_config_from_model_dict(model, presets.DFAUST_NUM_POINTS, train)
        assert (ours.frames.neigh_method, ours.frames.bq_radius, ours.frames.neigh_k) == ("ball_query", 0.1, 16)
        for field in dataclasses.fields(ours.frames):
            assert getattr(ours.frames, field.name) == getattr(ref.frames, field.name), field.name


def test_tiny_dfaust_model_on_ball_query_frames_matches_jax():
    jcfg, tcfg = _configs(n_frames=2)
    spec = dataclasses.replace(jget_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY)
    pts, mask, feats, labels = tiny_batch()
    key = jax.random.PRNGKey(3)
    h, f0, out_pc, _, _ = jax.jit(jhier.build_hierarchy, static_argnums=(4,))(
        key, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats), jcfg, jnp.asarray(labels))
    f0 = jnp.repeat(f0[:, :, None, :], 2, axis=2)
    net = JNet(spec, num_in_feats=1, num_classes=NUM_CLASSES)
    v = jax.jit(net.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc, train=False)
    rng = np.random.default_rng(4)
    v = {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng),
         "calib": v["calib"]}
    apply = jax.jit(net.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply(v, h, f0, out_pc, train=False, calibrate=True, mutable=("calib",))
    logits = np.asarray(apply({**v, "calib": mut["calib"]}, h, f0, out_pc, train=False))

    model = FPNSegUNet(dataclasses.replace(get_model_spec("FPNSegUNetMLPGeluRotEqFAUST"), **TINY),
                       num_in_feats=1, num_classes=NUM_CLASSES)
    model.load_state_dict(from_flax(*(jax.device_get(v[c]) for c in ("params", "batch_stats", "calib"))))
    trainer = Trainer(model, tcfg, label_smoothing=0.2)
    batch = {"positions": t(pts), "mask": t(mask), "features": t(feats), "labels": t(labels)}
    draws = jax_hierarchy_draws(key, jcfg, 2, pts.shape[1])
    trainer.calibration_step(batch, draws=draws)
    out = trainer.eval_step(batch, draws=draws)
    ref = flat_tree(mut["calib"])
    ours = {k: x.numpy() for k, x in model.state_dict().items() if k in ref}
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(out["logits"].numpy(), logits, atol=LOGITS_ATOL, rtol=0)
    assert np.abs(logits).max() > 100 * LOGITS_ATOL
