"""Every conv kind of the JAX ``PNEConv`` in the port: dispatch, forward,
gradients and errors.

* The port's ``fused_dispatch`` against the JAX package's over the whole
  grid of ``pne_type`` x ``aggregation`` x ``equivariant`` x
  ``rel_rot_type``: the port takes its kernel path exactly where the JAX
  package takes its Pallas path on a TPU (``use_fused`` None or True), and
  neither with ``use_fused=False``.
* ``PNEConv`` for every combination that the JAX ``PNEConv`` accepts
  (``mlp_{relu,gelu,sin,softmax,linear}``, ``kp_{gauss,linear,box}`` and
  their ``_double`` forms; 'add' and 'max'; 6D, quaternion and matrix
  rotations; equivariant and standard), its weights and calibration
  buffers carried over by ``from_flax`` (strict), against the JAX conv on
  the same numpy inputs: the forward at atol 2e-4 / rtol 5e-5 and, on the
  port's other path (``use_fused`` flipped), the same within the same
  bounds; the four gradients of the plain-path kinds (softmax, 'max',
  quaternion, matrix) against ``jax.grad`` at atol 5e-4 / rtol 5e-3.
* An equivariant kernel-point conv raises ``NotImplementedError`` in both
  packages, an unknown rotation type ``KeyError``.

JAX runs on the CPU, where its ``PNEConv`` takes the XLA path; its Pallas
path computes the same function (``tests/test_fused_equiv.py``,
``tests/test_fused_kp.py``), and the port's kernel path is held against it
in ``tests/test_torch_conv_acts.py`` and ``tests/test_torch_conv_kp.py``.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t, to_torch_cloud

from se3conv3d_tpu.core.frames import random_frames as jrandom_frames
from se3conv3d_tpu.core.neighborhoods import ball_query_neighborhood as jball
from se3conv3d_tpu.core.pointcloud import PointCloud as JCloud
from se3conv3d_tpu.nn import conv as jconv
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.nn.conv import PNEConv, fused_dispatch
from se3conv3d_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

PNE_TYPES = ("mlp_relu", "mlp_gelu", "mlp_sin", "mlp_softmax", "mlp_linear", "kp_gauss", "kp_linear",
             "kp_box", "kp_gauss_double", "kp_linear_double", "kp_box_double")
AGGREGATIONS = ("add", "max")
ROTATIONS = ("6D", "quaternion", "matrix")
K, Q, C, O = 6, 8, 10, 6
ND, NN = 1.5, 0.13
ATOL, RTOL = 2e-4, 5e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
LEAVES = ("proj_axes", "proj_biases", "conv_weights")
ACCEPTED = [(p, a, e, r) for p, a, e, r in itertools.product(PNE_TYPES, AGGREGATIONS, (True, False), ROTATIONS)
            if not (e and p.startswith("kp"))]


def test_dispatch_predicate_matches_jax_over_every_kind():
    kinds = itertools.product(PNE_TYPES, AGGREGATIONS + ("mean",), (True, False), ROTATIONS)
    taken = 0
    for pne_type, agg, equivariant, rot in kinds:
        on_tpu = jconv.fused_dispatch(pne_type, agg, equivariant, rot, True)
        assert fused_dispatch(pne_type, agg, equivariant, rot, None) == on_tpu
        assert fused_dispatch(pne_type, agg, equivariant, rot, True) == on_tpu
        assert not fused_dispatch(pne_type, agg, equivariant, rot, False)
        assert not jconv.fused_dispatch(pne_type, agg, equivariant, rot, False)
        taken += on_tpu
    # mlp but softmax: 4 x (3 standard + 1 equivariant 6D); kp: 6 x 3 standard
    assert taken == 4 * 4 + 6 * 3


@functools.lru_cache(maxsize=None)
def _case(equivariant):
    """Source cloud of 60 points, query cloud of 40 (masked tails; query
    point 3 far from every source), two random frames per point where
    equivariant, a ball-query neighborhood and features (numpy seed)."""
    rng = np.random.default_rng(90 + equivariant)
    f = 2 if equivariant else 0

    def cloud(n, tail, key):
        pts = rng.uniform(size=(2, n, 3)).astype(np.float32) * 1.5
        if n == 40:
            pts[1, 3] = 9.0
        mask = np.arange(n)[None] < (n - np.asarray(tail))[:, None]
        return JCloud(jnp.asarray(pts), jnp.asarray(mask), jrandom_frames(key, 2, n, f) if f else None)

    pc_in = cloud(60, (0, 5), jax.random.PRNGKey(91))
    pc_out = cloud(40, (4, 0), jax.random.PRNGKey(92))
    neigh = jax.jit(jball, static_argnums=(2, 3))(pc_in, pc_out, 0.6, K)
    feats = rng.normal(size=(2, 60, f, C) if f else (2, 60, C)).astype(np.float32)
    return pc_in, pc_out, neigh, feats


def _jax_variables(jmod, equivariant, seed):
    pc_in, pc_out, neigh, feats = _case(equivariant)
    v = jmod.init(jax.random.PRNGKey(seed), pc_in, pc_out, jnp.asarray(feats), neigh)
    rng = np.random.default_rng(seed)
    params = {**v["params"], "proj_biases": jnp.asarray(rng.normal(size=(Q,)).astype(np.float32) * 0.1)}
    calib = {**v["calib"], "norm_neigh_dist": jnp.asarray(ND, jnp.float32),
             "norm_num_neighs": jnp.asarray(NN, jnp.float32), "initialized": jnp.asarray(True)}
    return {"params": params, "calib": calib}


def _port(kind, variables, use_fused=None):
    pne_type, agg, equivariant, rot = kind
    conv = PNEConv(C, O, Q, pne_type, equivariant, rot, agg, use_fused=use_fused)
    conv.load_state_dict(from_flax(jax.device_get(variables["params"]), {},
                                   jax.device_get(variables["calib"])))
    pc_in, pc_out, neigh = _case(equivariant)[:3]
    return conv, (to_torch_cloud(pc_in), to_torch_cloud(pc_out),
                  Neighborhood(t(neigh.idx), t(neigh.mask), t(neigh.query_mask), "ball_query", 0.6))


@pytest.mark.parametrize("kind", ACCEPTED, ids=["-".join(map(str, k)) for k in ACCEPTED])
def test_every_accepted_kind_matches_jax(kind):
    """The forward of each accepted kind on both of the port's paths
    (:func:`fused_dispatch`'s and, flipped by ``use_fused``, the other)
    against the JAX conv; the plain-path kinds' gradients against
    ``jax.grad``."""
    pne_type, agg, equivariant, rot = kind
    jmod = jconv.PNEConv(C, O, Q, pne_type, equivariant=equivariant, rel_rot_type=rot, aggregation=agg)
    variables = _jax_variables(jmod, equivariant, ACCEPTED.index(kind))
    pc_in, pc_out, neigh, feats = _case(equivariant)
    want = np.asarray(jmod.apply(variables, pc_in, pc_out, jnp.asarray(feats), neigh))
    assert np.abs(want).max() > 1e-3
    conv, clouds = _port(kind, variables)
    assert conv.fused == jconv.fused_dispatch(pne_type, agg, equivariant, rot, True)
    other, _ = _port(kind, variables, use_fused=False if conv.fused else True)
    assert not other.fused
    with torch.no_grad():
        for c in (conv, other):
            np.testing.assert_allclose(c(*clouds[:2], t(feats), clouds[2]).numpy(), want,
                                       atol=ATOL, rtol=RTOL, err_msg=f"fused={c.fused}")
    if conv.fused:
        return

    def jloss(params):
        out = jmod.apply({**variables, "params": params}, pc_in, pc_out, jnp.asarray(feats), neigh)
        return jnp.sum(out * jnp.cos(out))

    want_grads = jax.grad(jloss)(variables["params"])
    out = conv(*clouds[:2], t(feats), clouds[2])
    (out * torch.cos(out)).sum().backward()
    for leaf in LEAVES:
        ref = np.asarray(want_grads[leaf])
        np.testing.assert_allclose(getattr(conv, leaf).grad.numpy(), ref, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=leaf)


@pytest.mark.parametrize("pne_type", [p for p in PNE_TYPES if p.startswith("kp")])
def test_equivariant_kernel_point_conv_raises_in_both_packages(pne_type):
    jmod = jconv.PNEConv(C, O, Q, pne_type, equivariant=True)
    pc_in, pc_out, neigh, feats = _case(True)
    with pytest.raises(NotImplementedError):
        jmod.init(jax.random.PRNGKey(0), pc_in, pc_out, jnp.asarray(feats), neigh)
    with pytest.raises(NotImplementedError):
        PNEConv(C, O, Q, pne_type, equivariant=True)


def test_unknown_rotation_type_raises_in_both_packages():
    jmod = jconv.PNEConv(C, O, Q, "mlp_gelu", equivariant=True, rel_rot_type="euler")
    pc_in, pc_out, neigh, feats = _case(True)
    with pytest.raises(KeyError):
        jmod.init(jax.random.PRNGKey(0), pc_in, pc_out, jnp.asarray(feats), neigh)
    with pytest.raises(KeyError):
        PNEConv(C, O, Q, "mlp_gelu", equivariant=True, rel_rot_type="euler")
