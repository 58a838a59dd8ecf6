"""The standard and kernel-point convs at up to 64 basis functions, and the
equivariant conv at Q = 64, G = F = 2, against the JAX package.

The port's kernels take Q <= 64 in the standard (kD = 3) and kernel-point
(kD = kKP) geometries (``kernels.fused_equiv.STD_MAX_Q``); their plain
versions, which run here, take any Q.  On the numpy inputs of
``tests/test_torch_conv_acts.py``'s cases (masked tails, a valid query row
with no valid edge), with parameters drawn at each Q:

* the standard gelu conv at Q = 8, 16, 64, each kernel-point correlation
  (gauss, linear, box at P = 13 and 55) at Q = 64 and the gauss ones at Q
  = 8, 16, and the equivariant gelu conv at Q = 64 with G = F = 2 (G*Q =
  128): the forward and the four gradients of ``sum(out * cos(out))``
  against JAX's ``fused_conv`` / ``fused_kp_conv`` / ``fused_equiv_conv``
  with the Pallas kernels in interpret mode (``FUSED_INTERPRET``, as
  ``tests/test_torch_standard.py`` runs them): float32 at atol 2e-4 /
  rtol 5e-5 (forward) and 5e-4 / 5e-3 (gradients); bfloat16 against JAX
  bf16 at max 1e-2, mean 1e-3 of max |JAX bf16|, the mean at most half
  that against JAX float32;
* ``_check`` (the CUDA wrappers' argument check) accepts Q = 64 in both
  geometries and refuses Q = 65 there, where the kernels' one pne row of
  64 columns cannot take it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_conv_acts as acts
from torch_port_helpers import t, to_torch_cloud

from se3conv3d_tpu.nn.conv import _kernel_points as jkernel_points
from se3conv3d_tpu.ops import pne_conv as jops
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.nn.conv import _kernel_points
from se3conv3d_tpu_torch.ops import pne_conv as ops

torch.set_num_threads(2)

ATOL, RTOL = acts.ATOL, acts.RTOL
GRAD_ATOL, GRAD_RTOL = acts.GRAD_ATOL, acts.GRAD_RTOL
ND, NN = acts.ND, acts.NN
KP_TYPES = ("kp_gauss", "kp_linear", "kp_box", "kp_gauss_double", "kp_linear_double", "kp_box_double")
# (conv, Q, dtype): the standard mlp conv, a kernel-point type or the
# equivariant conv; bfloat16 at Q = 64 and for the standard conv
CASES = ([("std", q, d) for q in (8, 16, 64) for d in ("float32", "bfloat16")]
         + [(k, 64, d) for k in KP_TYPES for d in ("float32", "bfloat16")]
         + [(k, q, "float32") for k in ("kp_gauss", "kp_gauss_double") for q in (8, 16)]
         + [("equiv", 64, d) for d in ("float32", "bfloat16")])


def _corr(pne_type):
    return "gauss" if "gauss" in pne_type else "box" if "box" in pne_type else "linear"


@functools.lru_cache(maxsize=None)
def conv_case(conv, q):
    """The clouds, neighborhood and features of the acts case, and
    parameters with ``Q = q`` basis functions (``proj_axes`` 9, 3 or P
    rows)."""
    pc_in, pc_out, neigh, feats = acts.case("equivariant" if conv == "equiv" else "standard")[:4]
    d = 9 if conv == "equiv" else 3 if conv == "std" else jkernel_points(conv)[0].shape[0]
    rng = np.random.default_rng(90 + q + (KP_TYPES.index(conv) + 1 if conv.startswith("kp") else 0))
    pa = (rng.normal(size=(d, q)) * 0.3).astype(np.float32)
    pb = (rng.normal(size=(q,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(acts.C, q, acts.O)) * (acts.C * q) ** -0.5).astype(np.float32)
    return pc_in, pc_out, neigh, feats, pa, pb, w


def _port(conv, q, params, cdt):
    pc_in, pc_out, neigh = conv_case(conv, q)[:3]
    pc_in, pc_out, neigh = to_torch_cloud(pc_in), to_torch_cloud(pc_out), acts.port_neigh(neigh)
    nd, nn_ = torch.tensor(ND), torch.tensor(NN)
    if conv.startswith("kp"):
        points, sigma = _kernel_points(conv)
        return ops.fused_kp_conv(pc_in, pc_out, neigh, params[0], points, sigma, _corr(conv),
                                 *params[1:], nd, nn_, compute_dtype=cdt)
    fn = ops.fused_equiv_conv if conv == "equiv" else ops.fused_conv
    return fn(pc_in, pc_out, neigh, *params, nd, nn_, compute_dtype=cdt)


def _jax(conv, q, params, cdt, lean=False):
    pc_in, pc_out, neigh = conv_case(conv, q)[:3]
    nd, nn_ = jnp.asarray(ND), jnp.asarray(NN)
    if conv.startswith("kp"):
        points, sigma = jkernel_points(conv)
        return jops.fused_kp_conv(pc_in, pc_out, neigh, params[0], jnp.asarray(points), sigma, _corr(conv),
                                  *params[1:], nd, nn_, tile_m=acts.TILE, compute_dtype=cdt)
    fn = jops.fused_equiv_conv if conv == "equiv" else jops.fused_conv
    return fn(pc_in, pc_out, neigh, *params, nd, nn_, tile_m=acts.TILE, compute_dtype=cdt,
              **({"lean_vjp": True} if lean else {}))


@functools.lru_cache(maxsize=None)
def jax_out_grads(conv, q, cdt):
    """JAX's forward and the four gradients of ``sum(out * cos(out))``."""
    params = tuple(jnp.asarray(x) for x in conv_case(conv, q)[3:])

    def jloss(p):
        out = _jax(conv, q, p, cdt, lean=True)
        return jnp.sum(out * jnp.cos(out))

    with acts.jax_reference():
        out = np.asarray(_jax(conv, q, params, cdt))
        grads = tuple(np.asarray(x) for x in jax.grad(jloss)(params))
    return out, grads


@pytest.mark.parametrize("conv,q,dtype", CASES, ids=[f"{c}_q{q}_{d}" for c, q, d in CASES])
def test_conv_at_q_matches_jax_pallas(conv, q, dtype):
    cdt = torch.bfloat16 if dtype == "bfloat16" else None
    jcdt = jnp.bfloat16 if cdt is not None else None
    want, want_grads = jax_out_grads(conv, q, jcdt)
    params = [t(x).requires_grad_() for x in conv_case(conv, q)[3:]]
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    out = _port(conv, q, params, cdt)
    (out * torch.cos(out)).sum().backward()
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == before  # plain versions
    got = out.detach().numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0.1
    neigh = conv_case(conv, q)[2]
    assert not got[~np.asarray(neigh.mask).any(-1)].any()  # no valid edge: zero
    if cdt is None:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        for p, ref, leaf in zip(params, want_grads, acts.LEAVES):
            assert np.abs(ref).max() > 0, leaf
            np.testing.assert_allclose(p.grad.numpy(), ref, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=leaf)
        return
    want32, grads32 = jax_out_grads(conv, q, None)
    acts.hold_bf16(got, want, want32, f"{conv} Q={q} forward")
    for p, ref, ref32, leaf in zip(params, want_grads, grads32, acts.LEAVES):
        acts.hold_bf16(p.grad.float().numpy(), ref, ref32, f"{conv} Q={q} {leaf}")


def _operands(q, d, k=8):
    gen = torch.Generator().manual_seed(0)
    return (torch.zeros(1, 5, k, 1, 3), None, torch.zeros(1, 6, 1, 4),
            torch.randint(0, 6, (1, 5, k), generator=gen), torch.ones(1, 5, k, dtype=torch.bool),
            torch.zeros(d, q), torch.zeros(q), torch.zeros(4, q, 4))


@pytest.mark.parametrize("geometry", ["std", "kp_gauss_double"])
def test_check_takes_q64_and_refuses_q65(geometry):
    kp = None
    d = 3
    if geometry != "std":
        points, sigma = _kernel_points(geometry)
        kp = kfe.KernelPoints(points, sigma, "gauss", torch.tensor(1.0))
        d = points.shape[0]
    assert kfe.STD_MAX_Q == 64
    assert kfe._check(*_operands(64, d), kp=kp)[6] == 64
    assert kfe.column_capacity(1, 64) == 64
    with pytest.raises(ValueError, match="Q <= 64"):
        kfe._check(*_operands(65, d), kp=kp)
