"""The conv backward's per-edge pass (``edge_kernel``, tensor cores) against
the plain version on the card, at ragged shapes.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_edge_cuda.py``.
Bounds, as ``tests/test_torch_kernel_cuda.py``'s: float32 each output within
``1e-4 * max |plain|``; bfloat16 within ``1e-2`` at its worst and ``1e-4`` on
average of ``max |plain|``, its mean error at most half its mean error
against the plain version with no bfloat16 rounding.  ``d_proj`` /
``d_bias`` and the sorted rows are the same bits on a second call.
"""
import ctypes

import pytest
import torch

from chip_smoke import EDGE_PLANS
from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.kernels.build import library
from se3conv3d_tpu_torch.ops.pne_conv import backward_sort_tables

# name: B, M, N, K, G, F, Q, C, O, valid-edge fraction (1: every edge of a
# row valid, so E = K*F exactly), geometry (9, 3, or P kernel points)
CASES = {
    "e1_c64": (2, 40, 50, 1, 1, 1, 32, 64, 32, 1.0, 9),
    "e17_c5": (2, 45, 60, 17, 1, 1, 32, 5, 12, 1.0, 9),
    "e24_c64": (1, 96, 80, 24, 1, 1, 32, 64, 64, 1.0, 9),
    "e24_ragged": (2, 70, 90, 24, 1, 1, 32, 64, 64, 0.6, 9),
    "e64_c512": (1, 24, 40, 32, 2, 2, 32, 512, 64, 1.0, 9),
    "e64_g4": (2, 30, 40, 16, 4, 4, 32, 32, 32, 1.0, 9),
    "g4_ragged_c40": (2, 33, 40, 9, 4, 4, 32, 40, 24, 0.7, 9),
    "g3_q24_odd": (2, 31, 30, 9, 3, 3, 24, 20, 18, 0.6, 9),
    "q10_unaligned_rows": (2, 30, 40, 12, 2, 2, 10, 24, 16, 0.7, 9),  # dbasis rows off 16 bytes
    "e128_gq64": (1, 20, 30, 64, 2, 2, 32, 48, 40, 0.9, 9),
    "std_q64": (2, 50, 60, 24, 1, 1, 64, 64, 32, 0.8, 3),
    "kp_p55": (2, 50, 60, 24, 1, 1, 64, 32, 32, 0.8, 55),
    "kp_p13_q32": (2, 40, 60, 17, 1, 1, 32, 64, 32, 1.0, 13),
}
ACTS = ("gelu", "relu", "sin", "linear")
RTOL, BF16_RTOL, BF16_MEAN_RTOL, BF16_SOUND_SHARE = 1e-4, 1e-2, 1e-4, 0.5
OUTPUTS = ("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the per-edge pass is a CUDA kernel")


def _inputs(name, seed=0):
    b, m, n, k, g, f, q, c, o, frac, geo = CASES[name]
    gen = torch.Generator(device="cuda").manual_seed(seed + sorted(CASES).index(name))

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    mask = torch.rand(b, m, k, generator=gen, device="cuda") < frac
    mask[:, -3:] = False  # rows with no valid edge
    idx = torch.randint(0, n, (b, m, k), generator=gen, device="cuda")
    d = 9 if geo == 9 else (3 if geo == 3 else geo)
    kp = None
    if geo == 9:
        rel, rot6 = rnd(b, m, k, g, 3) * 0.5, rnd(b, m, k, g, f, 6) * 0.5
    else:
        rel, rot6 = rnd(b, m, k, 1, 3) * 0.5, None
        if geo != 3:
            kp = kfe.KernelPoints(rnd(geo, 3) * 0.4, 0.6, "gauss", torch.tensor(1.3, device="cuda"))
    args = [rel, rot6, rnd(b, n, f, c), idx, mask, rnd(d, q) * 0.3, rnd(q) * 0.1,
            rnd(c, q, o) * (c * q) ** -0.5]
    return args, rnd(b, m, g, o), kp


def _as(args, dtype, kp):
    """rel (not at the kernel points, whose offsets stay float32), rot6 and
    feats in ``dtype``."""
    return [x.to(dtype) if x is not None and (i == 2 or (i < 2 and kp is None)) else x
            for i, x in enumerate(args)]


def _hold(got, ref, what, dtype, wide=None):
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), what
    scale = max(ref.abs().max().item(), 1e-6)
    err = (got - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() <= RTOL * scale, (what, err.max().item(), scale)
        return
    assert err.max().item() <= BF16_RTOL * scale, (what, err.max().item(), scale)
    assert err.mean().item() <= BF16_MEAN_RTOL * scale, (what, err.mean().item(), scale)
    control = (got - wide.float()).abs().mean().item()
    assert err.mean().item() <= BF16_SOUND_SHARE * control, (what, err.mean().item(), control)


def _check(name, dtype, act="gelu", live=None):
    """Both output modes against the plain version; the parameter gradients
    and sorted rows bitwise on a second call, and equal across modes."""
    args, gout, kp = _inputs(name)
    args = _as(args, dtype, kp)
    n = CASES[name][2]
    opts = dict(act=act, kp=kp)
    tabs = backward_sort_tables(Neighborhood(args[3], args[4], args[4].any(-1)), n)
    before = (kfe.fused_equiv_bwd.launches, kfe.fused_equiv_bwd.edge_launches)
    got = kfe.fused_equiv_bwd(*args, gout, live_rows=live, **opts)
    got_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live, **opts)
    again_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live, **opts)
    torch.cuda.synchronize()
    assert (kfe.fused_equiv_bwd.launches, kfe.fused_equiv_bwd.edge_launches) == (before[0] + 3, before[1] + 3)
    ref = kfe.fused_equiv_bwd_reference(*args, gout, **opts)
    ref_s = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=tabs.bwd_slot, **opts)
    wide = wide_s = [None] * 4
    if dtype == torch.bfloat16:
        w_args = _as(args, torch.float32, kp)
        wide = kfe.fused_equiv_bwd_reference(*w_args, gout, **opts)
        wide_s = kfe.fused_equiv_bwd_reference(*w_args, gout, sorted_slot=tabs.bwd_slot, **opts)
    for what, x, y, w in zip(OUTPUTS, got, ref, wide):
        _hold(x, y, f"{name} {act} {what}", dtype, w)
    _hold(got_s[0], ref_s[0], f"{name} {act} sorted rows", dtype, wide_s[0])
    assert torch.equal(got_s[0], again_s[0])
    for x, y, z in zip(got[1:], got_s[1:], again_s[1:]):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_edge_pass_matches_plain_version(name, dtype):
    _needs_card()
    _check(name, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("name", ["e24_ragged", "e64_g4", "std_q64"])
def test_edge_pass_matches_plain_version_for_each_activation(name, act, dtype):
    _needs_card()
    _check(name, dtype, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_edge_pass_skips_table_entries_out_of_range(dtype):
    """Entries outside [0, B*M) among the live rows walk no edge: the
    outputs are those of the table without them."""
    _needs_card()
    args, gout, kp = _inputs("e24_ragged")
    args = _as(args, dtype, kp)
    b, m = CASES["e24_ragged"][:2]
    live = kfe.live_row_table(args[4])
    bad = torch.tensor([-1, b * m, b * m + 7, 2**31 - 1, -2**31], dtype=torch.int32, device="cuda")
    half = live.numel() // 2
    table = torch.cat([bad[:2], live[:half], bad[2:4], live[half:], bad[4:]])
    want = kfe.fused_equiv_bwd(*args, gout, live_rows=live)
    got = kfe.fused_equiv_bwd(*args, gout, live_rows=table)
    torch.cuda.synchronize()
    for what, x, y in zip(OUTPUTS, got, want):
        assert torch.isfinite(x).all(), what
        assert (x - y).abs().max().item() <= RTOL * y.abs().max().item(), what


@pytest.mark.cuda
def test_edge_pass_with_no_live_row_launches_nothing():
    _needs_card()
    args, gout, kp = _inputs("e24_c64")
    args[4][:] = False
    before = kfe.fused_equiv_bwd.launches
    got = kfe.fused_equiv_bwd(*args, gout)
    torch.cuda.synchronize()
    assert kfe.fused_equiv_bwd.launches == before
    assert not any(x.any() for x in got)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", EDGE_PLANS)
def test_edge_plan_mirror_equals_the_c_plan_and_the_card_holds_it(plan):
    """The Python mirror against ``se3_fused_edge_plan``; the instantiation
    spills nothing and the card holds at least the plan's blocks an SM.
    Local memory: none in gelu's own instantiation; 32 bytes in the ones
    that switch the activation (the stack of sinf / cosf's slow path, as in
    ``basis_kernel``; a spill would add to it)."""
    _needs_card()
    elem, g, q, k, kd, p = plan
    out = (ctypes.c_int * 8)()
    assert library("bwd").se3_fused_edge_plan(elem, g, q, k, kd, p, out) == 0
    want = kfe.edge_plan(elem, g, q, k, kd, p)
    assert list(out) == [want[x] for x in ("warps", "smem_bytes", "stages", "blocks_per_sm", "gq_stride",
                                           "geo_rows", "edges_per_round", "channels_per_chunk")]
    for act in (0, 1):
        attrs = (ctypes.c_int * 4)()
        assert library("bwd").se3_fused_edge_attrs(elem, g, q, k, kd, p, act, attrs) == 0
        assert attrs[1] <= (0 if act == 0 and kd != 0 else 32), ("local memory", plan, list(attrs))
        assert attrs[2] == want["smem_bytes"] and attrs[3] >= want["blocks_per_sm"], (plan, list(attrs))
