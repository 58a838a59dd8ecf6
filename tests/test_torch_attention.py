"""The attention convs ``MultiHeadAttConv`` and ``LoRAttConv`` against the
JAX package.

On ``tests/test_components.py::test_attention_conv_layers``'s set-up (two
clouds of 48 points, the second with 16 padded, features ``[2, 48, 16]``,
16 -> 12 channels, 8 basis functions, 4 heads), with a kNN neighborhood of
8 and a ball query of radius 0.3, the JAX weights carried over strictly by
``from_flax`` (biases and ``pe`` randomized, so every term shows):

* the kernel points equal JAX's bitwise, for both ``kp_res`` and three
  seeds (a numpy ``RandomState`` draw of the Euler angles);
* the calibration buffers after two passes (the first sets them, the
  second an EMA) within rtol 1e-6;
* the output within atol 2e-4 / rtol 5e-5 and the gradients of a seeded
  projection with respect to every parameter and the features within atol
  5e-4 / rtol 5e-3 (``tests/test_torch_standard.py``'s conv bounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import flat_tree, randomize, t, to_torch_cloud

from se3conv3d_tpu.core import knn_neighborhood as jknn
from se3conv3d_tpu.core.neighborhoods import ball_query_neighborhood as jball
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.nn import LoRAttConv as JLoRA
from se3conv3d_tpu.nn import MultiHeadAttConv as JMHA
from se3conv3d_tpu.nn.attention import _rotated_kernel_points
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.nn import LoRAttConv, MultiHeadAttConv
from se3conv3d_tpu_torch.nn.attention import rotated_kernel_points
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

ATOL, RTOL = 2e-4, 5e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
LAYERS = {"mha": (JMHA, MultiHeadAttConv), "lora": (JLoRA, LoRAttConv)}


def _setup(neigh_type):
    key = jax.random.PRNGKey(3)
    pts = jax.random.uniform(key, (2, 48, 3))
    mask = jnp.arange(48)[None] < jnp.asarray([48, 32])[:, None]
    pc = JCloud(positions=pts, mask=mask)
    nb = jknn(pc, pc, 8) if neigh_type == "knn" else jball(pc, pc, 0.3, 8)
    feats = jax.random.normal(jax.random.PRNGKey(4), (2, 48, 16))
    return pc, nb, feats


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("kp_res", ["single", "double"])
def test_kernel_points_equal_jax_bitwise(kp_res, seed):
    got, sigma = rotated_kernel_points(seed, kp_res)
    want, want_sigma = _rotated_kernel_points(seed, kp_res)
    assert got.dtype == want.dtype == np.float32 and got.shape == ((55, 3) if kp_res == "double" else (13, 3))
    np.testing.assert_array_equal(got, want)
    assert sigma == want_sigma
    layer = LoRAttConv(16, 12, kp_res=kp_res, kp_seed=seed)
    np.testing.assert_array_equal(layer.kernel_points.numpy(), want)
    assert "kernel_points" not in layer.state_dict()


CASES = [("mha", "knn", "single"), ("lora", "knn", "single"), ("mha", "ball_query", "single"),
         ("lora", "ball_query", "double")]


@pytest.mark.parametrize("name,neigh_type,kp_res", CASES, ids=["-".join(c) for c in CASES])
def test_attention_layer_matches_jax(name, neigh_type, kp_res):
    jcls, tcls = LAYERS[name]
    pc, nb, feats = _setup(neigh_type)
    layer = jcls(in_features=16, out_features=12, num_basis=8, num_heads=4, kp_res=kp_res, kp_seed=5)
    v = layer.init({"params": jax.random.PRNGKey(5)}, pc, pc, feats, nb)
    v = {"params": randomize(v["params"], np.random.default_rng(6)), "calib": v["calib"]}
    v["params"]["pe"] = v["params"]["pe"] * 4.0
    calib = v["calib"]
    for _ in range(2):
        _, mut = layer.apply({**v, "calib": calib}, pc, pc, feats, nb, calibrate=True, mutable=["calib"])
        calib = mut["calib"]
    proj = np.random.default_rng(7).normal(size=(2, 48, 12)).astype(np.float32)

    def loss(params, x):
        out = layer.apply({"params": params, "calib": calib}, pc, pc, x, nb)
        return jnp.sum(out * proj), out

    (_, want), (jgrads, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(v["params"], feats)

    ours = tcls(16, 12, num_basis=8, num_heads=4, kp_res=kp_res, kp_seed=5)
    ours.load_state_dict(from_flax(jax.device_get(v["params"]), {}, jax.device_get(v["calib"])))
    tpc = to_torch_cloud(pc)
    tnb = Neighborhood(t(nb.idx), t(nb.mask), t(nb.query_mask), nb.method, nb.radius)
    with torch.no_grad():
        for _ in range(2):
            ours(tpc, tpc, t(feats), tnb, calibrate=True)
    ref_calib = flat_tree(calib)
    got_calib = {k: x.numpy() for k, x in ours.state_dict().items() if k in ref_calib}
    assert set(got_calib) == set(ref_calib) == {"norm_neigh_dist", "norm_num_neighs", "initialized"}
    for k in ref_calib:
        np.testing.assert_allclose(got_calib[k], ref_calib[k], rtol=1e-6, err_msg=k)
    if neigh_type == "ball_query":
        assert float(got_calib["norm_neigh_dist"]) == pytest.approx(1 / 0.3, rel=1e-6)

    x = t(feats).requires_grad_()
    out = ours(tpc, tpc, x, tnb)
    assert out.shape == (2, 48, 12)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert np.abs(np.asarray(want)).max() > 100 * ATOL  # the comparison is not between near-zeros
    (out * t(proj)).sum().backward()
    ref = flat_tree(jgrads)
    grads = {k: p.grad.numpy() for k, p in ours.named_parameters()}
    assert set(grads) == set(ref)
    assert ("conv_weights" in ref) == (name == "lora")
    for k in ref:
        assert np.abs(ref[k]).max() > 0, k
        np.testing.assert_allclose(grads[k], ref[k], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), atol=GRAD_ATOL, rtol=GRAD_RTOL)
