"""The conv kernels at 64 basis functions against their plain PyTorch
versions, on the card.

The standard (kD = 3) and kernel-point (kD = kKP) geometries take Q <= 64
in one pne row of 64 columns, through the wide basis tile (8 x 8 registers
a lane) where Q > 32; the kernel-point backward keeps its ``[P + 1, Q]``
projection sums in shared memory rows of 64 columns there.  The
equivariant geometry at Q = 64, G = F = 2 (G*Q = 128) takes the
128-column instantiations.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_kernel_cuda_q64.py``.
Bounds as ``tests/test_torch_kernel_cuda.py``'s: float32 forward ``max
|kernel - plain| <= 1e-5 * max |plain|``, each backward output ``1e-4 *
max |plain|``; bfloat16 operands ``max <= 1e-2``, ``mean <= 1e-4 * max
|plain|`` against the plain version's bfloat16 rounding, the mean at most
half that against the plain version with no bfloat16 rounding.  Both
output modes of the backward (atomic scatter and sorted slots), two calls
of each kernel bitwise equal, and rows with no valid edge zero.
"""
import pytest
import torch

from test_torch_kernel_cuda import _needs_card
from test_torch_kernel_cuda_modes import KP_TYPES, _check_both_kernels, _inputs, _kp, _operands

from se3conv3d_tpu_torch.kernels import fused_equiv as kfe

# name: B, M, N, K, G, F, Q, C, O, valid-edge fraction
Q64_SHAPES = {
    "std_q64": (2, 300, 260, 24, 1, 1, 64, 64, 64, 0.7),
    "std_q64_ragged": (2, 61, 50, 9, 1, 1, 64, 20, 18, 0.6),
    "equiv_q64_g2": (2, 200, 180, 32, 2, 2, 64, 32, 32, 0.7),
}
KP_Q64_SHAPE = (2, 300, 260, 32, 1, 1, 64, 32, 32, 0.7)
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])


def _by_q(before):
    """The launches by (D, Q) since ``before``, forward and backward."""
    return [{key: n - b.get(key, 0) for key, n in fn.launches_by_q.items() if n != b.get(key, 0)}
            for fn, b in zip((kfe.fused_equiv_fwd, kfe.fused_equiv_bwd), before)]


def _q_counts():
    return dict(kfe.fused_equiv_fwd.launches_by_q), dict(kfe.fused_equiv_bwd.launches_by_q)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("name", sorted(Q64_SHAPES))
def test_q64_kernels_match_plain_versions(name, act, dtype):
    """The standard geometry at Q = 64 (the wide basis tile at kD = 3) and
    the equivariant one at Q = 64, G = F = 2: both kernels against their
    plain versions, gelu's own instantiation and the activation switch,
    counted by (D, Q)."""
    _needs_card()
    shp = Q64_SHAPES[name]
    d = 9 if shp[4] > 1 else 3
    args, gout = _inputs(*shp, seed=sorted(Q64_SHAPES).index(name), d=d)
    args = _operands(args, dtype, None)
    before = _q_counts()
    grew = _check_both_kernels(args, gout, dtype, act, None, shp[2], f"{name} {act}")
    assert grew[:2] == [{act: 2}, {act: 3}]
    assert _by_q(before) == [{(d, 64): 2}, {(d, 64): 3}]


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("pne_type", KP_TYPES)
def test_kernel_point_q64_kernels_match_plain_versions(pne_type, dtype):
    """Each correlation at P = 13 and P = 55 with Q = 64: both kernels
    against their plain versions (the projection gradient ``[P, 64]``, the
    backward's shared-memory sums in rows of 64 columns), counted by
    (correlation, P) and by (P, Q)."""
    _needs_card()
    kp = _kp(pne_type)
    p = kp.points.shape[0]
    args, gout = _inputs(*KP_Q64_SHAPE, seed=KP_TYPES.index(pne_type), d=p)
    args = _operands(args, dtype, kp)
    before = _q_counts()
    grew = _check_both_kernels(args, gout, dtype, "linear", kp, KP_Q64_SHAPE[2], f"{pne_type} Q=64")
    assert grew == [{"linear": 2}, {"linear": 3}, {(kp.corr, p): 2}, {(kp.corr, p): 3}]
    assert _by_q(before) == [{(p, 64): 2}, {(p, 64): 3}]
    assert tuple(kfe.fused_equiv_bwd(*args, gout, act="linear", kp=kp)[1].shape) == (p, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["std", "kp_gauss_double", "equiv"])
def test_q64_kernels_with_no_live_row_return_zeros_without_a_launch(geometry):
    """Every edge masked: zeros from both wrappers and no launch."""
    _needs_card()
    if geometry == "equiv":
        shp, kp, d = Q64_SHAPES["equiv_q64_g2"], None, 9
    else:
        shp = Q64_SHAPES["std_q64"] if geometry == "std" else KP_Q64_SHAPE
        kp = None if geometry == "std" else _kp(geometry)
        d = 3 if kp is None else kp.points.shape[0]
    args, gout = _inputs(*shp, seed=11, d=d)
    args[4] = torch.zeros_like(args[4])
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    act = "linear" if kp is not None else "gelu"
    out = kfe.fused_equiv_fwd(*args, act=act, kp=kp)
    grads = kfe.fused_equiv_bwd(*args, gout, act=act, kp=kp)
    assert not out.any() and not any(g.any() for g in grads)
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == before


@pytest.mark.cuda
def test_q65_is_refused_before_any_launch():
    """Q = 65 in the standard and kernel-point geometries raises (one pne
    row of 64 columns)."""
    _needs_card()
    args, gout = _inputs(*Q64_SHAPES["std_q64"], seed=12, d=3)
    c, o = Q64_SHAPES["std_q64"][7:9]
    wide = [torch.zeros(3, 65, device="cuda"), torch.zeros(65, device="cuda"),
            torch.zeros(c, 65, o, device="cuda")]
    kp = _kp("kp_gauss")
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    for a, k in (([*args[:5], *wide], None), ([*args[:5], torch.zeros(13, 65, device="cuda"), *wide[1:]], kp)):
        with pytest.raises(ValueError):
            kfe.fused_equiv_fwd(*a, kp=k, act="linear")
        with pytest.raises(ValueError):
            kfe.fused_equiv_bwd(*a, gout, kp=k, act="linear")
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == before
