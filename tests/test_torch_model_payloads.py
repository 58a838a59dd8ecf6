"""Models of other conv kinds: their JAX parameters and their geometry.

* the parameters of JAX models with ``kp_linear_double`` (``proj_axes [55,
  Q]``), with quaternion rotations (``[7, Q]``) and with matrix rotations and
  'max' aggregation (``[12, Q]``) load strictly into the port's models
  (``from_flax``; both conv factories replaced, as
  ``tests/test_torch_model_modes.py`` explains);
* the neighborhood provider's payload for each mix of consumers: kernel-path
  and plain-path equivariant convs, rotation types, dtypes, kernel-point
  and plain standard convs, as ``se3conv3d_tpu/models/spec.py`` decides it
  from ``fused_dispatch`` of each factory.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_model_modes import _hcfgs, with_convs
from torch_port_helpers import NUM_CLASSES, TINY, capture_grads, tiny_batch, to_torch_hierarchy

from se3conv3d_tpu.models import FPNSegUNet as JNet
from se3conv3d_tpu.models import get_model_spec as jget_spec
from se3conv3d_tpu.train.trainer import Trainer as JTrainer
from se3conv3d_tpu.train.trainer import TrainSettings
from se3conv3d_tpu_torch.models import FPNSegUNet, get_model_spec
from se3conv3d_tpu_torch.models.spec import NeighborhoodProvider
from se3conv3d_tpu_torch.nn.conv import PNEConv
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)


def _jbatch():
    pts, mask, feats, labels = tiny_batch()
    return {"positions": jnp.asarray(pts), "mask": jnp.asarray(mask), "features": jnp.asarray(feats),
            "labels": jnp.asarray(labels)}


@pytest.mark.parametrize("preset,kind,rows", [
    ("FPNSegUNetMLPGeluFAUST", dict(pne_type="kp_linear_double"), 55),
    ("FPNSegUNetMLPGeluRotEqFAUST", dict(rel_rot_type="quaternion"), 7),
    ("FPNSegUNetMLPGeluRotEqFAUST", dict(rel_rot_type="matrix", aggregation="max"), 12),
])
def test_jax_params_of_other_kinds_load_strictly(preset, kind, rows):
    frames = 2 if "RotEq" in preset else None
    jbatch = _jbatch()
    jspec = with_convs(dataclasses.replace(jget_spec(preset), **TINY), **kind)
    model = JNet(jspec, num_in_feats=1, num_classes=NUM_CLASSES)
    jtrainer = JTrainer(model, _hcfgs(frames)[0], capture_grads(), TrainSettings(), donate_state=False)
    h, f0, out_pc, _, _ = jax.jit(jtrainer._build)(jax.random.PRNGKey(3), jbatch)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}, h, f0, out_pc, train=False)
    tspec = with_convs(dataclasses.replace(get_model_spec(preset), **TINY), **kind)
    tmodel = FPNSegUNet(tspec, num_in_feats=1, num_classes=NUM_CLASSES)
    tmodel.load_state_dict(from_flax(*(jax.device_get(v[c]) for c in ("params", "batch_stats", "calib"))))
    convs = [mod for mod in tmodel.modules() if isinstance(mod, PNEConv)]
    assert convs and all(tuple(c.proj_axes.shape) == (rows, 32) for c in convs)


@functools.lru_cache(maxsize=None)
def _hierarchy(frames):
    """The tiny batch's hierarchy, built by JAX (``frames`` PCA frames per
    point, or none)."""
    jspec = dataclasses.replace(jget_spec("FPNSegUNetMLPGeluFAUST"), **TINY)
    jtrainer = JTrainer(JNet(jspec, num_in_feats=1, num_classes=NUM_CLASSES), _hcfgs(frames)[0],
                        capture_grads(), donate_state=False)
    return to_torch_hierarchy(jax.jit(jtrainer._build)(jax.random.PRNGKey(3), _jbatch())[0])


def _provider(spec):
    return NeighborhoodProvider(_hierarchy(2 if spec.equivariant else None), spec)


BF16 = torch.bfloat16
# name: (preset, conv kind, conv_blocks kind, the self neighborhood's payload,
# the cross-level one's); a payload names each geometry field with its
# dtype and its last dimension (std_rel: 3)
PAYLOADS = {
    "kernel_6d": ("FPNSegUNetMLPGeluRotEqFAUST", {}, {},
                  {"equiv": (torch.float32, 6)}, {"equiv": (torch.float32, 6)}),
    "kernel_6d_bf16_and_plain_quaternion": (
        "FPNSegUNetMLPGeluRotEqFAUST", dict(compute_dtype=BF16), dict(rel_rot_type="quaternion"),
        {"equiv": (BF16, 6), "plain": (torch.float32, 4)}, {"equiv": (BF16, 6)}),
    "plain_softmax_blocks": (
        "FPNSegUNetMLPGeluRotEqFAUST", {}, dict(pne_type="mlp_softmax", rel_rot_type="matrix"),
        {"equiv": (torch.float32, 6), "plain": (torch.float32, 9)}, {"equiv": (torch.float32, 6)}),
    "plain_max_everywhere": (
        "FPNSegUNetMLPGeluRotEqFAUST", dict(aggregation="max"), dict(aggregation="max"),
        {"plain": (torch.float32, 6)}, {"plain": (torch.float32, 6)}),
    "standard_mlp_bf16": ("FPNSegUNetMLPGeluFAUST", dict(compute_dtype=BF16), dict(compute_dtype=BF16),
                          {"std": (BF16, 3)}, {"std": (BF16, 3)}),
    "standard_kp_bf16": ("FPNSegUNetMLPGeluFAUST", dict(pne_type="kp_box", compute_dtype=BF16),
                         dict(pne_type="kp_box", compute_dtype=BF16),
                         {"std": (torch.float32, 3)}, {"std": (torch.float32, 3)}),
    "standard_max_blocks_mlp_bf16": ("FPNSegUNetMLPGeluFAUST", dict(compute_dtype=BF16),
                                     dict(aggregation="max"),
                                     {"std": (torch.float32, 3)}, {"std": (BF16, 3)}),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_provider_payload_serves_each_mix_of_consumers(name):
    """Each neighborhood carries what its consumers read, decided from
    ``fused_dispatch`` of each factory: the self neighborhood for the block
    stack (``conv_blocks``, then ``conv``), the cross-level one for ``conv``."""
    preset, conv_kind, blocks_kind, want_self, want_cross = PAYLOADS[name]
    spec = dataclasses.replace(get_model_spec(preset), **TINY)
    spec = dataclasses.replace(spec, conv=dataclasses.replace(spec.conv, **conv_kind),
                               conv_blocks=dataclasses.replace(spec.conv_blocks, **blocks_kind))
    provider = _provider(spec)
    fields = {"equiv": ("equiv_rel", "equiv_rot"), "plain": ("plain_rel", "plain_rot"), "std": ("std_rel",)}
    for nb, want in ((provider.get(1, 1, 0.32, "ball_query", 8), want_self),
                     (provider.get(0, 1, 0.32, "ball_query", 8), want_cross)):
        assert nb.live_rows is not None
        for key, names in fields.items():
            tensors = [getattr(nb, n) for n in names]
            if key not in want:
                assert all(x is None for x in tensors), (name, key)
                continue
            dtype, last = want[key]
            assert all(x is not None and x.dtype == dtype for x in tensors), (name, key)
            assert tensors[-1].shape[-1] == last, (name, key)
