"""The port's random (Monte-Carlo) and global PCA frames against the JAX
package, and the recipes that use them.

* ``planar_rotations`` / ``random_frames`` equal JAX's on the same injected
  draws (JAX's normals or uniforms from the same key), atol 1e-6: both
  compute the same float32 expressions;
* the generator path by distribution (``jax.random`` and ``torch`` draw
  other streams): SO(3) frames' rotation angle against the Haar density
  ``(1 - cos t) / pi`` by chi-square and ``E[R] = 0``; planar frames keep
  their axis exactly and have uniform angles; ``shuffle_and_select_frames``
  is uniform over the ordered outcomes (``PARITY.md`` "Frame parity");
* ``global_pca_frames`` equal JAX's at 1e-5 (the same closed-form solver,
  compared after canonical column signs);
* ``build_hierarchy`` with ``pca: false`` (free and about z) and with
  global PCA frames, at F = 1, 2, 4, equal to JAX's with the same key
  (``torch_port_helpers.jax_hierarchy_draws``);
* ``draw_n_frames`` gives the sequence of ``train/run.py``'s expression;
* the four newly pinned recipes equal their YAML files, and their
  ``RefFrames`` are read with the JAX package's defaults.
"""
import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from torch_port_helpers import HCFG, jax_hierarchy_draws, t, tiny_batch

from se3conv3d_tpu.core import frames as jframes
from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.core import rotation as jrot
from se3conv3d_tpu.train import config as jconfig
from se3conv3d_tpu.train import run as jrun
from se3conv3d_tpu_torch.core import frames, hierarchy, rotation
from se3conv3d_tpu_torch.models import presets
from se3conv3d_tpu_torch.train.trainer import draw_n_frames

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a chi-square test fails below this p-value
P_MIN = 1e-3


def _chi2_p(counts, expected):
    stat = float(((counts - expected) ** 2 / expected).sum())
    return chi2.sf(stat, len(counts) - 1)


# --- injected draws ------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_planar_rotations_match_jax(axis):
    key = jax.random.PRNGKey(10 + axis)
    want = np.asarray(jrot.planar_rotations(key, 500, axis))
    u = t(jax.random.uniform(key, (500,)))
    got = rotation.planar_rotations(500, axis, uniforms=u).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        rotation.planar_rotations(3, 3, uniforms=u[:3])


@pytest.mark.parametrize("fixed_axis", [False, 0, 1, 2])
@pytest.mark.parametrize("n_frames", [1, 2, 4])
def test_random_frames_match_jax_on_injected_draws(fixed_axis, n_frames):
    """``fixed_axis=0`` is free SO(3) in both (the reference's truthiness)."""
    b, n = 2, 37
    key = jax.random.PRNGKey(20 + n_frames)
    want = np.asarray(jframes.random_frames(key, b, n, n_frames, fixed_axis))
    total = b * n * n_frames
    if fixed_axis:
        got = frames.random_frames(b, n, n_frames, fixed_axis,
                                   uniforms=t(jax.random.uniform(key, (total,))))
    else:
        got = frames.random_frames(b, n, n_frames, fixed_axis,
                                   normals=t(jax.random.normal(key, (total, 4))))
    assert got.shape == (b, n, n_frames, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# --- the generator path, by distribution ----------------------------------------


def test_so3_random_frames_from_a_generator_are_haar_uniform():
    """Rotation angles ``t = arccos((tr R - 1) / 2)`` of Haar-uniform
    rotations have density ``(1 - cos t) / pi`` on ``[0, pi]``; 20 bins of
    equal probability, chi-square at 19 dof; ``E[R] = 0`` within 5 standard
    errors (each entry has variance 1/3)."""
    n = 60_000
    mats = frames.random_frames(2, 300, 100, False, generator=torch.Generator().manual_seed(0))
    r = mats.reshape(-1, 3, 3).double()
    assert r.shape[0] == n
    eye = torch.eye(3, dtype=torch.float64)
    assert (r @ r.transpose(-1, -2) - eye).abs().max() < 1e-5
    assert (torch.linalg.det(r) - 1).abs().max() < 1e-5
    trace = r.diagonal(dim1=-2, dim2=-1).sum(-1)
    angle = torch.arccos(((trace - 1) / 2).clamp(-1, 1)).numpy()
    # CDF (t - sin t) / pi: the bin edges of equal probability
    grid = np.linspace(0, np.pi, 200_001)
    cdf = (grid - np.sin(grid)) / np.pi
    edges = np.interp(np.linspace(0, 1, 21), cdf, grid)
    counts = np.histogram(angle, bins=edges)[0]
    assert _chi2_p(counts, np.full(20, n / 20)) > P_MIN
    mean = r.mean(0)
    assert mean.abs().max() < 5 * (1 / 3 / n) ** 0.5, mean


@pytest.mark.parametrize("axis", [1, 2])
def test_planar_random_frames_from_a_generator_keep_the_axis_and_are_uniform(axis):
    n = 40_000
    mats = frames.random_frames(4, 1000, 10, axis, generator=torch.Generator().manual_seed(axis))
    r = mats.reshape(-1, 3, 3)
    unit = torch.zeros(3)
    unit[axis] = 1.0
    # the fixed axis is kept exactly: its column and its row are the unit vector
    assert torch.equal(r[:, :, axis], unit.expand(n, 3))
    assert torch.equal(r[:, axis, :], unit.expand(n, 3))
    i, j = [a for a in range(3) if a != axis]
    angle = torch.atan2(r[:, j, i], r[:, i, i]).double().numpy() % (2 * np.pi)
    counts = np.histogram(angle, bins=24, range=(0, 2 * np.pi))[0]
    assert _chi2_p(counts, np.full(24, n / 24)) > P_MIN


def test_shuffle_and_select_frames_is_uniform_over_ordered_outcomes():
    """Candidate identity rides in the frame payload; the ordered pairs of
    2 of 4 candidates are uniform over the 12 outcomes (chi-square, 11
    dof), drawn without replacement."""
    cand = torch.arange(4, dtype=torch.float32)[None, :, None, None].expand(20_000, 4, 3, 3)
    sel = frames.shuffle_and_select_frames(cand, 2, generator=torch.Generator().manual_seed(3))
    ids = sel[:, :, 0, 0].long().numpy()
    counts = np.zeros((4, 4))
    np.add.at(counts, (ids[:, 0], ids[:, 1]), 1)
    assert np.trace(counts) == 0
    off = counts[~np.eye(4, dtype=bool)]
    assert _chi2_p(off, np.full(12, off.sum() / 12)) > P_MIN
    with pytest.raises(ValueError):
        frames.shuffle_and_select_frames(cand, 5, generator=torch.Generator())


def test_shuffle_and_select_frames_matches_jax_on_injected_scores():
    rng = np.random.default_rng(5)
    cand = rng.normal(size=(3, 50, 4, 3, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jframes.shuffle_and_select_frames(key, jnp.asarray(cand), 3))
    scores = t(jax.random.uniform(key, cand.shape[:-2]))
    got = frames.shuffle_and_select_frames(t(cand), 3, scores=scores)
    np.testing.assert_array_equal(got.numpy(), want)


# --- global PCA frames ------------------------------------------------------------


def _canonical(f):
    """Each frame's columns signed so that their largest entry is positive."""
    idx = np.abs(f).argmax(-2)[..., None, :]
    return f * np.sign(np.take_along_axis(f, idx, -2))


def test_global_pca_frames_match_jax():
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(3, 300, 3)) * np.array([1.0, 0.5, 0.2])).astype(np.float32)
    rot = np.asarray(jrot.random_rotations(jax.random.PRNGKey(8), 3))
    pts = np.einsum("bij,bnj->bni", rot, pts).astype(np.float32) + 2.0
    mask = np.arange(300)[None] < np.array([300, 250, 120])[:, None]
    want = np.asarray(jframes.global_pca_frames(jnp.asarray(pts), jnp.asarray(mask)))
    got = frames.global_pca_frames(t(pts), t(mask)).numpy()
    assert got.shape == (3, 4, 3, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(_canonical(got), _canonical(want), atol=1e-5)
    det = np.linalg.det(got.astype(np.float64))
    np.testing.assert_allclose(det, 1.0, atol=1e-5)


# --- the hierarchy ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["so3", "about_z", "global_pca"])
@pytest.mark.parametrize("n_frames", [1, 2, 4])
def test_build_hierarchy_with_random_frames_matches_jax(kind, n_frames):
    fcfg = dict(so3=dict(pca=False), about_z=dict(pca=False, fixed_axis=2),
                global_pca=dict(global_frames=True))[kind]
    jcfg = jhier.HierarchyConfig(**HCFG, frames=jhier.FrameConfig(n_frames=n_frames, **fcfg))
    tcfg = hierarchy.HierarchyConfig(**HCFG, frames=hierarchy.FrameConfig(n_frames=n_frames, **fcfg))
    pts, mask, feats, labels = tiny_batch(seed=n_frames)
    key = jax.random.PRNGKey(30 + n_frames)
    jh, jf0, jout, jlabels, _ = jax.jit(jhier.build_hierarchy, static_argnums=(4,))(
        key, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feats), jcfg, jnp.asarray(labels))
    draws = jax_hierarchy_draws(key, jcfg, 2, pts.shape[1])
    h, f0, out_pc, out_labels, _ = hierarchy.build_hierarchy(
        t(pts), t(mask), t(feats), tcfg, t(labels), draws=draws)
    for lvl, (pc, jpc) in enumerate(zip(h.levels + (out_pc,), jh.levels + (jout,))):
        np.testing.assert_array_equal(pc.mask.numpy(), np.asarray(jpc.mask), err_msg=str(lvl))
        np.testing.assert_allclose(pc.positions.numpy(), np.asarray(jpc.positions), atol=1e-6)
        assert pc.frames.shape == tuple(jpc.frames.shape) == (2, pc.capacity, n_frames, 3, 3)
        np.testing.assert_allclose(pc.frames.numpy(), np.asarray(jpc.frames), atol=1e-5,
                                   err_msg=f"level {lvl}")
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), atol=1e-6)
    np.testing.assert_array_equal(out_labels.numpy(), np.asarray(jlabels))
    if kind == "about_z":  # every frame keeps the world z axis
        assert torch.equal(h.levels[0].frames[..., :, 2], torch.tensor([0.0, 0.0, 1.0]).expand(
            2, h.levels[0].capacity, n_frames, 3))


def test_draw_hierarchy_gives_each_frame_kind_its_draws():
    for fcfg, shape in ((dict(), (2, 128, 4)), (dict(fixed_axis=2), (2, 128, 2)),
                        (dict(pca=False), (2, 128, 3, 4)), (dict(pca=False, fixed_axis=1), (2, 128, 3)),
                        (dict(global_frames=True), (2, 4))):
        cfg = hierarchy.HierarchyConfig(**HCFG, frames=hierarchy.FrameConfig(n_frames=3 if not fcfg.get(
            "pca", True) else 1, **fcfg))
        d = hierarchy.draw_hierarchy(cfg, 2, 200, torch.Generator().manual_seed(0))
        assert tuple(d.level_frames[0].shape) == shape, fcfg
        assert len(d.level_frames) == 3 and d.out_uniforms.shape == (2, 128)
    # the PCA frames' ball-query neighborhood builds (held against JAX in
    # tests/test_torch_frames_ball_query.py); an unknown method raises
    pts, mask, feats, _ = tiny_batch()
    cfg = hierarchy.HierarchyConfig(**HCFG, frames=hierarchy.FrameConfig(
        neigh_method="ball_query", bq_radius=0.2))
    h = hierarchy.build_hierarchy(t(pts), t(mask), t(feats), cfg, generator=torch.Generator())[0]
    assert tuple(h.levels[0].frames.shape) == (2, 128, 2, 3, 3)
    cfg = hierarchy.HierarchyConfig(**HCFG, frames=hierarchy.FrameConfig(neigh_method="radius"))
    with pytest.raises(ValueError):
        hierarchy.build_hierarchy(t(pts), t(mask), t(feats), cfg, generator=torch.Generator())


# --- the frame count per micro-batch -------------------------------------------


def test_draw_n_frames_gives_the_sequence_of_the_jax_run_loop():
    """The draw of ``se3conv3d_tpu/train/run.py`` (three lines, checked
    verbatim in its source), and the port's, from the same numpy seed."""
    lines = ("fs = sorted(self.mix_frames)",
             "probs = np.asarray([self.mix_frames[f] for f in fs])",
             "f = int(self.rng.choice(fs, p=probs / probs.sum()))")
    src = inspect.getsource(jrun)
    assert all(line in src for line in lines)
    mix = presets.mix_n_frames(presets.DFAUST_I_ROT_MC_MIXF_MODEL)
    assert mix == {4: 0.15, 2: 0.35, 1: 0.5}

    class Run:  # the attributes the run loop's expression reads
        mix_frames = mix
        rng = np.random.default_rng(11)

    self, want = Run(), []
    for _ in range(400):
        scope = {"self": self, "np": np}
        exec("\n".join(lines), scope)
        want.append(scope["f"])
    rng = np.random.default_rng(11)
    got = [draw_n_frames(mix, rng) for _ in range(400)]
    assert got == want
    assert set(got) == {1, 2, 4}
    assert presets.mix_n_frames(presets.DFAUST_I_ROT_PCA_2F_MODEL) is None


# --- the recipes ---------------------------------------------------------------------


RECIPES = {
    # name: (YAML file, Model dict, Training dict)
    "dfaust_I_rot_MC_mixF": ("configs/dfaust/dfaust_I_rot_MC_mixF.yaml",
                             presets.DFAUST_I_ROT_MC_MIXF_MODEL, presets.DFAUST_I_ROT_MC_MIXF_TRAINING),
    "dfaust_I_rot_MC_2F": ("configs/dfaust/dfaust_I_rot_MC_2F.yaml",
                           presets.DFAUST_I_ROT_MC_2F_MODEL, presets.DFAUST_I_ROT_MC_2F_TRAINING),
    "dfaust_I_rot_pca_mixF": ("configs/dfaust/dfaust_I_rot_pca_mixF.yaml",
                              presets.DFAUST_I_ROT_PCA_MIXF_MODEL, presets.DFAUST_I_ROT_PCA_MIXF_TRAINING),
    "scannet20_rot_I": ("configs/scannet/scannet20_rot_I.yaml",
                        presets.SCANNET20_ROT_I_MODEL, presets.SCANNET20_ROT_I_TRAINING),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_pinned_recipe_matches_yaml_and_reads_its_frames_the_jax_way(name):
    path, model, training = RECIPES[name]
    cfg = jconfig.load_yaml_config(os.path.join(REPO, path))
    assert model == cfg["Model"]
    assert training == cfg["Training"]
    n = cfg["Dataset"].get("num_points", presets.SCANNET_SCENE_MAX_POINTS)
    for train in (True, False):
        ours = presets.hierarchy_config_from_model_dict(model, n, train)
        ref = jconfig.hierarchy_config_from_model_dict(cfg["Model"], n, train)
        for field in dataclasses.fields(ours):
            if field.name != "frames":
                assert getattr(ours, field.name) == getattr(ref, field.name), field.name
        assert {f.name for f in dataclasses.fields(ours.frames)} == {
            f.name for f in dataclasses.fields(ref.frames)}
        for field in dataclasses.fields(ours.frames):
            assert getattr(ours.frames, field.name) == getattr(ref.frames, field.name), field.name
    mix = cfg["Model"]["RefFrames"].get("mix_n_frames")
    assert presets.mix_n_frames(model) == ({int(k): float(v) for k, v in mix.items()} if mix else None)
    assert presets.frame_config_from_dict(None) is None
