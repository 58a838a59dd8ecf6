"""``ClassNet``'s global equivariant feature vector against the JAX package.

``ModelSpec.global_equiv_featurevector``: the last trunk level's features
through ``almost_last_norm``, a conv into one extra hierarchy level whose
kNN neighborhood holds every point of the trunk level (k = its capacity;
``global_conv_down``, C -> 2C), ``last_norm`` and ``last_linear``; the
output is ``[B, M_extra, F, 2C]`` in the extra level's frames.  On the
ClassNet of ``tests/test_components.py::test_class_net_global_equiv_featurevector``
(two trunk levels of 8 and 16 channels, one extra level of 16 points), with
the JAX weights carried over strictly by ``from_flax``:

* calibration buffers (rtol 1e-6) and the output (atol 2e-4, the
  whole-model bound) on one JAX-built hierarchy;
* the gradient of a seeded projection of the output with respect to every
  parameter, per leaf within ``tests/test_torch_train.py``'s rule;
* the state dict has no ``class_norm`` / ``class_head`` keys;
* the output follows a global rotation: with positions and frames rotated
  the features (in the frames) are unchanged within 1e-4 of max |out| and
  the extra level's frames are the rotated ones; with the frames left
  unrotated, the control, the output moves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import flat_tree, randomize, t, to_torch_hierarchy

from se3conv3d_tpu.core import hierarchy as jhier
from se3conv3d_tpu.models import ClassNet as JClassNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu_torch.core.hierarchy import Hierarchy, rotate_hierarchy
from se3conv3d_tpu_torch.core.pointcloud import PointCloud
from se3conv3d_tpu_torch.core.rotation import random_rotations
from se3conv3d_tpu_torch.models import ClassNet, get_model_spec
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

ATOL = 2e-4
STEP_GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-2
ROT_RTOL = 1e-4
SPEC = dict(patch_num_levels=1, patch_num_features=(8,), num_blocks=(1, 1), num_features=(8, 16),
            max_neighbors=8, global_equiv_featurevector=True)


@pytest.fixture(scope="module")
def jax_net():
    cfg = jhier.HierarchyConfig(
        init_cell_size=0.08, cell_sizes=(0.16, 0.32, 0.5), capacities=(128, 64, 32, 16),
        frames=jhier.FrameConfig(n_frames=2, neigh_k=8))
    kp, kh = jax.random.split(jax.random.PRNGKey(23))
    pts = jax.random.uniform(kp, (2, 160, 3))
    h, f0, *_ = jax.jit(jhier.build_hierarchy, static_argnums=(4,))(
        kh, pts, jnp.ones((2, 160), bool), jnp.ones((2, 160, 3)), cfg)
    f0 = jnp.repeat(f0[:, :, None, :], 2, axis=2)
    spec = dataclasses.replace(get_model_spec("ClassNetRotEquivMLPGELU19Former"), **SPEC)
    model = JClassNet(dataclasses.replace(jget_spec("ClassNetRotEquivMLPGELU19Former"), **SPEC),
                      num_in_feats=3, num_classes=4)
    v = model.init({"params": jax.random.PRNGKey(24)}, h, f0, train=False)
    rng = np.random.default_rng(4)
    v = {"params": randomize(v["params"], rng), "batch_stats": randomize(v["batch_stats"], rng),
         "calib": v["calib"]}
    apply = jax.jit(model.apply, static_argnames=("train", "calibrate", "mutable"))
    _, mut = apply(v, h, f0, train=False, calibrate=True, mutable=("calib",))
    calibrated = {**v, "calib": mut["calib"]}
    out = np.asarray(apply(calibrated, h, f0, train=False))
    proj = np.random.default_rng(7).normal(size=out.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(apply({**calibrated, "params": p}, h, f0, train=False) * proj))(
        calibrated["params"])
    return dict(spec=spec, h=h, f0=f0, v=v, calibrated=calibrated, out=out, proj=proj,
                grads=flat_tree(grads))


def _port(v, spec):
    model = ClassNet(spec, num_in_feats=3, num_classes=4)
    model.load_state_dict(from_flax(*(jax.device_get(v[c]) for c in ("params", "batch_stats", "calib"))))
    return model.eval()


def test_output_and_calibration_match_jax(jax_net):
    jn = jax_net
    model = _port(jn["v"], jn["spec"])
    h, f0 = to_torch_hierarchy(jn["h"]), t(jn["f0"])
    with torch.no_grad():
        model(h, f0, calibrate=True)
        out = model(h, f0).numpy()
    ref = flat_tree(jn["calibrated"]["calib"])
    ours = {k: x.numpy() for k, x in model.state_dict().items() if k in ref}
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)
    assert out.shape == (2, 16, 2, 32)  # [B, M_extra, F, 2C]
    np.testing.assert_allclose(out, jn["out"], atol=ATOL, rtol=0)
    assert np.abs(jn["out"]).max() > 100 * ATOL


def test_strict_load_has_no_classification_head(jax_net):
    names = set(_port(jax_net["v"], jax_net["spec"]).state_dict())
    assert not any(k.split(".")[0] in ("class_norm", "class_head") for k in names)
    assert {"almost_last_norm.scale", "global_conv_down.conv_weights", "last_norm.var",
            "last_linear.kernel"} <= names
    assert tuple(_port(jax_net["v"], jax_net["spec"]).global_conv_down.conv_weights.shape[::2]) == (16, 32)


def test_parameter_gradients_match_jax(jax_net):
    jn = jax_net
    model = _port(jn["calibrated"], jn["spec"])
    out = model(to_torch_hierarchy(jn["h"]), t(jn["f0"]))
    (out * t(jn["proj"])).sum().backward()
    ref = jn["grads"]
    ours = {k: p.grad for k, p in model.named_parameters()}
    assert set(ours) == set(ref)
    norm = float(np.sqrt(sum(np.square(r.astype(np.float64)).sum() for r in ref.values())))
    for k, r in ref.items():
        err = np.abs(ours[k].numpy() - r).max()
        assert err <= STEP_GRAD_TOL * max(np.abs(r).max(), GRAD_FLOOR * norm), (k, err)
    assert np.abs(ref["global_conv_down.conv_weights"]).max() > 0


def test_output_follows_a_global_rotation(jax_net):
    jn = jax_net
    model = _port(jn["calibrated"], jn["spec"])
    h, f0 = to_torch_hierarchy(jn["h"]), t(jn["f0"])
    rot = random_rotations(1, torch.Generator().manual_seed(3))[0]
    h_rot = rotate_hierarchy(h, rot)
    unrotated_frames = Hierarchy(
        tuple(PointCloud(r.positions, r.mask, p.frames) for r, p in zip(h_rot.levels, h.levels)),
        h.maps, h.levels_radii)
    with torch.no_grad():
        out, out_rot, control = (model(x, f0) for x in (h, h_rot, unrotated_frames))
    scale = out.abs().max().item()
    assert (out_rot - out).abs().max().item() <= ROT_RTOL * scale
    assert (control - out).abs().max().item() > 100 * ROT_RTOL * scale
    want = torch.einsum("ij,bnfjk->bnfik", rot, h.levels[-1].frames)
    torch.testing.assert_close(h_rot.levels[-1].frames, want)
