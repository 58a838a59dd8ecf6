"""The conv kernels' activations and kernel-point geometry against their
plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_kernel_cuda_modes.py``.
Bounds as ``tests/test_torch_kernel_cuda.py``'s: float32 forward ``max
|kernel - plain| <= 1e-5 * max |plain|``, each backward output ``1e-4 *
max |plain|``; bfloat16 operands ``max <= 1e-2``, ``mean <= 1e-4 * max
|plain|`` against the plain version's bfloat16 rounding, the mean at most
half that against the plain version with no bfloat16 rounding.  The
kernel-point weights are computed by the kernels and the plain version in
the same operations in the same order, so a box one-hot that picked
another kernel point than the plain version's would move its row's output
far past the forward bound.
"""
import pytest
import torch

from test_torch_kernel_cuda import BWD_OUTPUTS as OUTPUTS
from test_torch_kernel_cuda import BWD_RTOL, _hold_bf16, _needs_card

from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.nn.conv import _kernel_points
from se3conv3d_tpu_torch.ops.pne_conv import backward_sort_tables

FWD_RTOL = 1e-5
# name: B, M, N, K, G, F, Q, C, O, valid-edge fraction; G = 2 is the
# equivariant geometry (kD = 9), G = 1 the standard one (kD = 3)
ACT_SHAPES = {
    "equiv_slice_like": (2, 300, 260, 32, 2, 2, 32, 32, 32, 0.7),
    "equiv_ragged": (3, 77, 50, 8, 2, 2, 16, 24, 20, 0.6),
    "std_slice_like": (2, 300, 260, 24, 1, 1, 32, 64, 64, 0.7),
    "std_ragged": (2, 61, 50, 9, 1, 1, 16, 20, 18, 0.6),
}
KP_SHAPE = (2, 300, 260, 32, 1, 1, 32, 32, 32, 0.7)
KP_TYPES = ("kp_gauss", "kp_linear", "kp_box", "kp_gauss_double", "kp_linear_double", "kp_box_double")


def _inputs(b, m, n, k, g, f, q, c, o, frac, seed, d):
    """Operands with a masked query tail and a row with no valid edge; the
    offsets float32, ``d`` projection rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    mask = torch.rand(b, m, k, generator=gen, device="cuda") < frac
    mask[:, -5:] = False
    mask[0, 3] = False
    rel = rnd(b, m, k, g, 3) * 0.5
    rot6 = rnd(b, m, k, g, f, 6) * 0.5 if g > 1 or d == 9 else None
    args = [rel, rot6, rnd(b, n, f, c), torch.randint(0, n, (b, m, k), generator=gen, device="cuda"),
            mask, rnd(d, q) * 0.3, rnd(q) * 0.1, rnd(c, q, o) * (c * q) ** -0.5]
    return args, torch.randn(b, m, g, o, device="cuda", generator=gen)


def _kp(pne_type):
    points, sigma = _kernel_points(pne_type)
    corr = "gauss" if "gauss" in pne_type else "box" if "box" in pne_type else "linear"
    return kfe.KernelPoints(points.cuda(), sigma, corr, torch.tensor(1.3, device="cuda"))


def _operands(args, dtype, kp):
    """rel (but the kernel-point offsets, float32 always), rot6 and feats in ``dtype``."""
    return [x.to(dtype) if x is not None and (i == 2 or (i < 2 and kp is None)) else x
            for i, x in enumerate(args)]


def _hold(got, ref, what, dtype, rtol, wide=None):
    """float32 within ``rtol`` of max |plain|; bfloat16 at the bounds of
    ``test_torch_kernel_cuda._hold_bf16`` with its control ``wide``."""
    if dtype == torch.bfloat16:
        _hold_bf16(got, ref, what, wide)
        return
    assert got.shape == ref.shape and torch.isfinite(got).all(), what
    err = (got - ref).abs().max().item()
    assert err <= rtol * max(ref.abs().max().item(), 1e-6), (what, err, ref.abs().max().item())


def _check_both_kernels(args, gout, dtype, act, kp, n, what):
    """Forward (two calls bitwise equal, padded rows zero) and backward in
    both output modes (parameter gradients bitwise equal across modes and
    calls) against the plain versions; returns the launches counted by
    activation and by kernel-point kind."""
    live = kfe.live_row_table(args[4])
    tabs = backward_sort_tables(Neighborhood(args[3], args[4], args[4].any(-1)), n)
    opts = dict(act=act, kp=kp)
    wide = _operands(args, torch.float32, kp) if dtype == torch.bfloat16 else None
    before = ({**kfe.fused_equiv_fwd.launches_by_act}, {**kfe.fused_equiv_bwd.launches_by_act},
              {**kfe.fused_equiv_fwd.launches_by_kp}, {**kfe.fused_equiv_bwd.launches_by_kp})
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args, live_rows=live, **opts)
        again = kfe.fused_equiv_fwd(*args, live_rows=live, **opts)
        ref = kfe.fused_equiv_fwd_reference(*args, **opts)
        control = kfe.fused_equiv_fwd_reference(*wide, **opts) if wide else None
    _hold(got, ref, f"{what} forward", dtype, FWD_RTOL, control)
    assert torch.equal(got, again) and not got[~args[4].any(-1)].any()
    grads = kfe.fused_equiv_bwd(*args, gout, live_rows=live, **opts)
    grads_again = kfe.fused_equiv_bwd(*args, gout, live_rows=live, **opts)
    grads_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live, **opts)
    ref_b = kfe.fused_equiv_bwd_reference(*args, gout, **opts)
    ref_s = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=tabs.bwd_slot, **opts)
    wide_b = kfe.fused_equiv_bwd_reference(*wide, gout, **opts) if wide else [None] * 4
    wide_s = kfe.fused_equiv_bwd_reference(*wide, gout, sorted_slot=tabs.bwd_slot, **opts) if wide else [None]
    for name, x, y, w in zip(OUTPUTS, grads, ref_b, wide_b):
        _hold(x, y, f"{what} {name}", dtype, BWD_RTOL, w)
    _hold(grads_s[0], ref_s[0], f"{what} sorted rows", dtype, BWD_RTOL, wide_s[0])
    for x, y, z in zip(grads[1:], grads_again[1:], grads_s[1:]):
        assert torch.equal(x, y) and torch.equal(x, z), what
    return [{key: n - b.get(key, 0) for key, n in now.items() if n != b.get(key, 0)}
            for now, b in zip((kfe.fused_equiv_fwd.launches_by_act, kfe.fused_equiv_bwd.launches_by_act,
                               kfe.fused_equiv_fwd.launches_by_kp, kfe.fused_equiv_bwd.launches_by_kp),
                              before)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "sin", "linear", "gelu"])
@pytest.mark.parametrize("name", sorted(ACT_SHAPES))
def test_activation_kernels_match_plain_versions(name, act, dtype):
    """Each activation at kD = 9 and kD = 3, float32 and bfloat16: both
    kernels against their plain versions, counted by activation."""
    _needs_card()
    shp = ACT_SHAPES[name]
    d = 9 if shp[4] > 1 else 3
    args, gout = _inputs(*shp, seed=sorted(ACT_SHAPES).index(name), d=d)
    args = _operands(args, dtype, None)
    grew = _check_both_kernels(args, gout, dtype, act, None, shp[2], f"{name} {act}")
    assert grew == [{act: 2}, {act: 3}, {}, {}]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("pne_type", KP_TYPES)
def test_kernel_point_kernels_match_plain_versions(pne_type, dtype):
    """Each correlation at P = 13 and P = 55, float32 and bfloat16 features
    (float32 offsets): both kernels against their plain versions, the
    projection gradient ``[P, Q]``, counted by (correlation, P)."""
    _needs_card()
    kp = _kp(pne_type)
    p = kp.points.shape[0]
    args, gout = _inputs(*KP_SHAPE, seed=KP_TYPES.index(pne_type), d=p)
    args = _operands(args, dtype, kp)
    assert args[0].dtype == torch.float32 and args[1] is None
    grew = _check_both_kernels(args, gout, dtype, "linear", kp, KP_SHAPE[2], pne_type)
    assert grew == [{"linear": 2}, {"linear": 3}, {(kp.corr, p): 2}, {(kp.corr, p): 3}]
    assert tuple(kfe.fused_equiv_bwd(*args, gout, act="linear", kp=kp)[1].shape) == (p, KP_SHAPE[6])


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_mode", [False, True])
def test_kernel_point_conv_function_reads_norm_dist_on_the_device(sorted_mode):
    """Through the autograd Function: the kernels read ``norm_dist`` from
    the device (a new value changes the output with no other change),
    gradients reach the features and the three parameters, and in 'sorted'
    mode the prefix sum runs."""
    _needs_card()
    from se3conv3d_tpu_torch.kernels import segsum

    kp = _kp("kp_gauss")
    args, _ = _inputs(*KP_SHAPE, seed=7, d=13)
    tabs = backward_sort_tables(Neighborhood(args[3], args[4], args[4].any(-1)), KP_SHAPE[2])
    for i in (2, 5, 6, 7):
        args[i].requires_grad_()
    before = segsum.blocked_cumsum.launches
    out = kfe.fused_equiv(*args, (tabs.bwd_slot, tabs.bwd_run_start, tabs.bwd_run_end) if sorted_mode else None,
                          act="linear", kp=kp)
    out.square().sum().backward()
    assert segsum.blocked_cumsum.launches == before + sorted_mode
    assert all(args[i].grad is not None for i in (2, 5, 6, 7))
    with torch.no_grad():
        kp.norm_dist.fill_(0.7)
        moved = kfe.fused_equiv_fwd(*args, act="linear", kp=kp)
        ref = kfe.fused_equiv_fwd_reference(*args, act="linear", kp=kp)
    assert (moved - out).abs().max() > 1e-3
    assert (moved - ref).abs().max() <= FWD_RTOL * ref.abs().max()


@pytest.mark.cuda
def test_kernel_point_wrappers_reject_what_the_kernels_do_not_take():
    """bfloat16 offsets, a rot6, G = 2, Q > 64, P > MAX_KP, a [P', Q]
    projection of the wrong height or an unknown correlation or activation
    raise before any launch."""
    _needs_card()
    kp = _kp("kp_gauss")
    args, gout = _inputs(*KP_SHAPE, seed=9, d=13)
    q, c, o = KP_SHAPE[6:9]
    bad = [
        ([args[0].to(torch.bfloat16), *args[1:]], kp),
        ([args[0], torch.zeros(*args[0].shape[:4], 1, 6, device="cuda"), *args[2:]], kp),
        ([args[0].expand(-1, -1, -1, 2, -1).contiguous(), *args[1:]], kp),
        ([*args[:5], torch.zeros(13, 65, device="cuda"), torch.zeros(65, device="cuda"),
          torch.zeros(c, 65, o, device="cuda")], kp),
        ([*args[:5], torch.zeros(65, q, device="cuda"), *args[6:]],
         kp._replace(points=torch.zeros(65, 3, device="cuda"))),
        ([*args[:5], torch.zeros(55, q, device="cuda"), *args[6:]], kp),
        (args, kp._replace(corr="cosine")),
    ]
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    for a, k in bad:
        with pytest.raises((ValueError, TypeError)):
            kfe.fused_equiv_fwd(*a, act="linear", kp=k)
        with pytest.raises((ValueError, TypeError)):
            kfe.fused_equiv_bwd(*a, gout, act="linear", kp=k)
    with pytest.raises(ValueError):
        kfe.fused_equiv_fwd(*args, act="tanh", kp=kp)
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == before
