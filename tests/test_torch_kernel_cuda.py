"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_kernel_cuda.py``.
Tolerances: both sides sum in float32 in different orders (the forward's
weight contraction in 3xTF32 on the tensor cores), so ``max |kernel -
plain| <= 1e-5 * max |plain|`` for the forward and the prefix sum; the
backward's parameter gradients sum over every edge of the batch (its two
products in 3xTF32 on the tensor cores), so ``1e-4 * max |plain|`` for each
of its four outputs.  The prefix sum takes bfloat16 payloads at the same
float32 bound (both sides widen the same values), and its calls are
bitwise equal (its tile offsets are fixed sums).  The kernels' bfloat16
operand path is held against the plain versions' bfloat16 rounding at the
bounds stated beside its tests.
"""
import pytest
import torch

from se3conv3d_tpu_torch.core.neighborhoods import Neighborhood
from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.kernels import segsum
from se3conv3d_tpu_torch.ops.pne_conv import backward_sort_tables

SHAPES = {
    # name: B, M, N, K, G, F, Q, C, O, valid-edge fraction
    "slice_like": (2, 300, 260, 32, 2, 2, 32, 32, 32, 0.7),
    "ragged_odd_widths": (3, 77, 50, 8, 2, 2, 16, 24, 20, 0.6),
    "g1_wide_out": (1, 40, 64, 12, 1, 1, 32, 70, 300, 0.8),  # two output blocks
    "many_neighbors_deep": (2, 33, 128, 40, 2, 2, 32, 256, 256, 0.5),
    "all_masked_tiles": (2, 64, 64, 16, 2, 2, 32, 32, 32, 0.0),
    # G > 2 or G*Q > 64: pne rows of 128 columns (two 64-column passes where G*Q > 64)
    "g4_mixf_like": (2, 200, 180, 32, 4, 4, 32, 32, 32, 0.7),
    "g3_ragged_q24": (2, 61, 50, 9, 3, 3, 24, 20, 18, 0.6),
    "g4_q16_one_pass": (2, 70, 60, 10, 4, 4, 16, 24, 20, 0.6),
    "g1_q128": (1, 50, 64, 12, 1, 1, 128, 24, 20, 0.7),
    "g4_most_edges": (1, 24, 400, 108, 4, 4, 32, 16, 16, 0.8),  # K*F = MAX_EDGES[128]
}
BWD_RTOL = 1e-4


def _inputs(b, m, n, k, g, f, q, c, o, frac, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    mask = torch.rand(b, m, k, generator=gen, device="cuda") < frac
    mask[:, -5:] = False  # a masked query tail
    return (rnd(b, m, k, g, 3) * 0.5, rnd(b, m, k, g, f, 6) * 0.5, rnd(b, n, f, c),
            torch.randint(0, n, (b, m, k), generator=gen, device="cuda"), mask,
            rnd(9, q) * 0.3, rnd(q) * 0.1, rnd(c, q, o) * (c * q) ** -0.5)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused conv kernels are CUDA-only")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_matches_plain_version(name):
    _needs_card()
    args = _inputs(*SHAPES[name], seed=sorted(SHAPES).index(name))
    before = kfe.fused_equiv_fwd.launches
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args)
        torch.cuda.synchronize()
        ref = kfe.fused_equiv_fwd_reference(*args)
    # no query row with a valid edge: zeros, and nothing to launch
    assert kfe.fused_equiv_fwd.launches == before + (name != "all_masked_tiles")
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * max(ref.abs().max().item(), 1e-6), (err, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_kernel_matches_plain_version(name):
    _needs_card()
    args = _inputs(*SHAPES[name], seed=sorted(SHAPES).index(name))
    b, m, _, _, g, _, _, _, o, _ = SHAPES[name]
    gout = torch.randn(b, m, g, o, device="cuda", generator=torch.Generator(device="cuda").manual_seed(7))
    before = kfe.fused_equiv_bwd.launches
    got = kfe.fused_equiv_bwd(*args, gout)
    torch.cuda.synchronize()
    ref = kfe.fused_equiv_bwd_reference(*args, gout)
    # no query row with a valid edge: zeros, and nothing to launch
    assert kfe.fused_equiv_bwd.launches == before + (name != "all_masked_tiles")
    for what, x, y in zip(("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights"), got, ref):
        assert x.shape == y.shape and torch.isfinite(x).all(), what
        if name == "all_masked_tiles":
            assert not x.any(), what  # no valid edge: every gradient is exactly zero
            continue
        err = (x - y).abs().max().item()
        assert err <= BWD_RTOL * y.abs().max().item(), (what, err, y.abs().max().item())


@pytest.mark.cuda
def test_backward_launches_the_backward_kernel_once():
    _needs_card()
    args = list(_inputs(*SHAPES["slice_like"], seed=0))
    for i in (2, 5, 6, 7):
        args[i].requires_grad_()
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    out = kfe.fused_equiv(*args)
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == (before[0] + 1, before[1])
    out.square().sum().backward()
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert all(args[i].grad is not None and args[i].grad.is_cuda for i in (2, 5, 6, 7))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take():
    _needs_card()
    args = list(_inputs(*SHAPES["slice_like"], seed=0))
    with pytest.raises(TypeError):
        kfe.fused_equiv_fwd(*args[:3], args[3].int(), *args[4:])
    with pytest.raises(ValueError):
        kfe.fused_equiv_fwd(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):
        kfe.fused_equiv_fwd(args[0].cpu(), *args[1:])
    gout = torch.zeros(2, 300, 2, 32, device="cuda")
    with pytest.raises(ValueError):
        kfe.fused_equiv_bwd(*args, gout[:, :-1])
    with pytest.raises(ValueError):
        kfe.fused_equiv_bwd(*args, gout.cpu())


CUMSUM_SHAPES = [(1, 3000, 64), (2, 777, 20), (1, 256, 320), (3, 1, 5), (1, 100_000, 33),
                 # empty, one row, around one 256-row tile; many windows over
                 # two column groups; a batch of 32 examples, 8 column groups
                 (1, 0, 64), (1, 1, 64), (1, 255, 64), (1, 256, 64), (1, 257, 64),
                 (2, 70_000, 128), (32, 4096, 512)]


def _cumsum_vs_plain(shape, dtype):
    x = torch.randn(*shape, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    x = x.to(dtype)
    before = segsum.blocked_cumsum.launches
    got = segsum.blocked_cumsum(x)
    torch.cuda.synchronize()
    ref = segsum.blocked_cumsum_reference(x)
    # one launch per call, none for an empty input
    assert segsum.blocked_cumsum.launches == before + (x.numel() > 0)
    assert got.shape == ref.shape and got.dtype == torch.float32 and torch.isfinite(got).all()
    if ref.numel():
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), (err, ref.abs().max().item())
    assert torch.equal(segsum.blocked_cumsum(x[0]), got[0])  # [E, C] is B = 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUMSUM_SHAPES)
def test_cumsum_kernel_matches_plain_version(shape):
    _needs_card()
    _cumsum_vs_plain(shape, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUMSUM_SHAPES)
def test_cumsum_kernel_on_bf16_payload_matches_plain_version(shape):
    """bfloat16 payloads, float32 accumulation and output, at the float32 bound."""
    _needs_card()
    _cumsum_vs_plain(shape, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 300_000, 64), (3, 40_000, 130)])
def test_cumsum_kernel_gives_the_same_bits_on_every_call(shape):
    """Over 1,000 tiles (many windows; a ragged column group too): the
    offsets are fixed sums, so 20 calls agree bitwise."""
    _needs_card()
    x = torch.randn(*shape, device="cuda", generator=torch.Generator(device="cuda").manual_seed(2))
    first = segsum.blocked_cumsum(x)
    for _ in range(19):
        assert torch.equal(segsum.blocked_cumsum(x), first)


@pytest.mark.cuda
def test_cumsum_kernel_state_serves_shapes_and_streams_in_turn():
    """The state buffer grows for a larger call and is reused by smaller
    ones; a second stream gets its own, and both streams' calls are right."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = [torch.randn(*shape, device="cuda", generator=gen)
          for shape in ((1, 5000, 64), (4, 70_000, 64), (1, 300, 20), (2, 9000, 256))]
    refs = [segsum.blocked_cumsum_reference(x) for x in xs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for _ in range(2):
        outs = [segsum.blocked_cumsum(x) for x in xs]
        with torch.cuda.stream(side):
            side_outs = [segsum.blocked_cumsum(x) for x in reversed(xs)]
        torch.cuda.synchronize()
        for got, side_got, ref in zip(outs, reversed(side_outs), refs):
            assert torch.equal(got, side_got)
            assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_cumsum_kernel_replays_in_a_cuda_graph():
    """The launch takes no argument that changes from call to call and
    needs no reset launch: a captured call replays to the eager bits."""
    _needs_card()
    x = torch.randn(1, 300_000, 64, device="cuda", generator=torch.Generator(device="cuda").manual_seed(4))
    want = segsum.blocked_cumsum(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up: the capture stream's state buffer
        segsum.blocked_cumsum(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = segsum.blocked_cumsum(x)
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _sort_tables(idx, mask, n):
    idx = torch.where(mask, idx, torch.zeros_like(idx))  # as the searches clamp invalid slots
    return backward_sort_tables(Neighborhood(idx, mask, mask.any(-1)), n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_sorted_output_matches_plain_version(name):
    """The per-point pass's sorted per-edge rows against the plain version's,
    slot by slot, and their segment sums against the scatter mode's d_feats."""
    _needs_card()
    args = list(_inputs(*SHAPES[name], seed=sorted(SHAPES).index(name)))
    b, m, n, k, g, f, _, c, o, _ = SHAPES[name]
    args[3] = torch.where(args[4], args[3], torch.zeros_like(args[3]))
    tabs = _sort_tables(args[3], args[4], n)
    gout = torch.randn(b, m, g, o, device="cuda", generator=torch.Generator(device="cuda").manual_seed(7))
    got = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot)
    ref = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=tabs.bwd_slot)
    scatter = kfe.fused_equiv_bwd(*args, gout)
    torch.cuda.synchronize()
    assert got[0].shape == (b, m * k, f * c)
    edge_rows = args[4].reshape(b, m * k).gather(1, tabs.bwd_perm)  # validity in sorted order
    assert not got[0][~edge_rows].any()  # masked edges leave zeros
    for x, y in zip(got, ref):
        err = (x - y).abs().max().item()
        assert err <= BWD_RTOL * max(y.abs().max().item(), 1e-6), (err, y.abs().max().item())
    for x, y in zip(got[1:], scatter[1:]):
        assert torch.equal(x, y)  # parameter gradients do not depend on the mode
    summed = segsum.sorted_segment_sum(got[0], tabs.bwd_run_start, tabs.bwd_run_end)
    err = (summed.reshape(scatter[0].shape) - scatter[0]).abs().max().item()
    assert err <= BWD_RTOL * max(scatter[0].abs().max().item(), 1e-6), err


@pytest.mark.cuda
def test_sorted_mode_backward_launches_the_cumsum_kernel():
    _needs_card()
    args = list(_inputs(*SHAPES["slice_like"], seed=0))
    args[3] = torch.where(args[4], args[3], torch.zeros_like(args[3]))
    tabs = _sort_tables(args[3], args[4], SHAPES["slice_like"][2])
    for i in (2, 5, 6, 7):
        args[i].requires_grad_()
    before = kfe.fused_equiv_bwd.launches, segsum.blocked_cumsum.launches
    out = kfe.fused_equiv(*args, (tabs.bwd_slot, tabs.bwd_run_start, tabs.bwd_run_end))
    out.square().sum().backward()
    assert (kfe.fused_equiv_bwd.launches, segsum.blocked_cumsum.launches) == (before[0] + 1, before[1] + 1)
    sorted_grads = [args[i].grad.clone() for i in (2, 5, 6, 7)]
    for i in (2, 5, 6, 7):
        args[i].grad = None
    kfe.fused_equiv(*args).square().sum().backward()
    for x, i in zip(sorted_grads, (2, 5, 6, 7)):
        y = args[i].grad
        assert (x - y).abs().max().item() <= BWD_RTOL * y.abs().max().item()


@pytest.mark.cuda
def test_cumsum_and_sorted_wrappers_reject_what_they_do_not_take():
    _needs_card()
    with pytest.raises(TypeError):
        segsum.blocked_cumsum(torch.zeros(10, 4, device="cuda", dtype=torch.float64))
    with pytest.raises(TypeError):
        segsum.blocked_cumsum(torch.zeros(10, 4, device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError):
        segsum.blocked_cumsum(torch.zeros(4, 10, device="cuda").t())
    with pytest.raises(ValueError):
        segsum.blocked_cumsum(torch.zeros(2, 3, 10, 4, device="cuda"))
    args = list(_inputs(*SHAPES["slice_like"], seed=0))
    gout = torch.zeros(2, 300, 2, 32, device="cuda")
    slot = torch.zeros(2, 300 * 32, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot.int())
    with pytest.raises(ValueError):
        kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot[:, :-1])


LIVE_SHAPES = {
    # name: B, M, N, K, G, F, Q, C, O, valid-edge fraction, live-prefix fraction
    # (the rows past each example's live prefix are fully masked)
    "live_15pct_scannet_like": (1, 4096, 4096, 24, 1, 1, 32, 64, 64, 0.7, 0.15),
    "live_15pct_g2_wide": (2, 600, 500, 16, 2, 2, 32, 256, 256, 0.7, 0.15),
    "live_count_off_tiles": (3, 333, 200, 12, 2, 2, 16, 24, 20, 0.6, 0.31),  # 309 live rows
    "live_few_rows_level4_like": (1, 512, 512, 24, 1, 1, 32, 320, 320, 0.7, 0.08),
    # C*Q = 333 and O = 70 are not multiples of 4: the products copy 4 bytes at a time
    "live_unaligned_widths": (2, 150, 120, 10, 2, 2, 9, 37, 70, 0.6, 0.5),
    # O = 7: the forward's product copies W 4 bytes at a time
    "live_narrow_c5_o7_q8": (2, 90, 70, 10, 2, 2, 8, 5, 7, 0.6, 0.4),
    # the mixed-frame-count recipes at F = G = 4 (128 pne columns)
    "live_g4_level0_like": (2, 1024, 1024, 32, 4, 4, 32, 32, 32, 0.7, 0.28),
    "live_g4_level4_like": (2, 128, 128, 32, 4, 4, 32, 256, 256, 0.7, 0.3),
    # the ModelNet40 ClassNet's level-5 block conv (C = O = 512: product depth
    # C*Q = 16,384) and its down_conv_3 (256 -> 512 channels, N = 2 M)
    "live_modelnet_level5_block": (2, 256, 256, 32, 2, 2, 32, 512, 512, 0.7, 0.3),
    "live_modelnet_down_conv_3": (2, 256, 512, 32, 2, 2, 32, 256, 512, 0.7, 0.4),
}


def _live_inputs(name):
    b, m, n, k, g, f, q, c, o, frac, live = LIVE_SHAPES[name]
    args = list(_inputs(b, m, n, k, g, f, q, c, o, frac, seed=20 + sorted(LIVE_SHAPES).index(name)))
    args[4][:, int(live * m):] = False
    args[3] = torch.where(args[4], args[3], torch.zeros_like(args[3]))  # as the searches clamp
    gout = torch.randn(b, m, g, o, device="cuda", generator=torch.Generator(device="cuda").manual_seed(8))
    return args, gout


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIVE_SHAPES))
def test_backward_kernel_on_live_rows_matches_plain_version(name):
    """A live prefix per example, the rest of the rows fully masked: both
    output modes against the plain version (which walks every row), and the
    parameter gradients bitwise equal over two calls, across the modes and
    with the live-row table given or built by the wrapper."""
    _needs_card()
    args, gout = _live_inputs(name)
    b, m, n, k = LIVE_SHAPES[name][:4]
    live = kfe.live_row_table(args[4])
    assert 0 < live.numel() < b * m
    tabs = _sort_tables(args[3], args[4], n)
    before = kfe.fused_equiv_bwd.launches
    got = kfe.fused_equiv_bwd(*args, gout, live_rows=live)
    again = kfe.fused_equiv_bwd(*args, gout)
    got_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live)
    torch.cuda.synchronize()
    assert kfe.fused_equiv_bwd.launches == before + 3
    ref = kfe.fused_equiv_bwd_reference(*args, gout)
    ref_s = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=tabs.bwd_slot)
    for what, x, y in zip(("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights"), got, ref):
        assert x.shape == y.shape and torch.isfinite(x).all(), what
        err = (x - y).abs().max().item()
        assert err <= BWD_RTOL * y.abs().max().item(), (what, err, y.abs().max().item())
    err = (got_s[0] - ref_s[0]).abs().max().item()
    assert err <= BWD_RTOL * ref_s[0].abs().max().item(), err
    for x, y, z in zip(got[1:], again[1:], got_s[1:]):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
def test_backward_kernel_with_no_live_row_returns_zeros_without_a_launch():
    _needs_card()
    args, gout = _live_inputs("live_count_off_tiles")
    args[4][:] = False
    live = kfe.live_row_table(args[4])
    assert live.numel() == 0 and live.dtype == torch.int32
    before = kfe.fused_equiv_bwd.launches
    for slot in (None, _sort_tables(args[3], args[4], LIVE_SHAPES["live_count_off_tiles"][2]).bwd_slot):
        got = kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot, live_rows=live)
        assert not any(x.any() for x in got)
    assert kfe.fused_equiv_bwd.launches == before


@pytest.mark.cuda
def test_backward_wrapper_rejects_a_bad_live_row_table():
    _needs_card()
    args, gout = _live_inputs("live_count_off_tiles")
    live = kfe.live_row_table(args[4])
    for bad in (live.long(), live.cpu(), live[None], torch.zeros(3 * 333 + 1, dtype=torch.int32, device="cuda")):
        with pytest.raises(ValueError):
            kfe.fused_equiv_bwd(*args, gout, live_rows=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIVE_SHAPES))
def test_forward_kernel_on_live_rows_matches_plain_version(name):
    """A live prefix per example, the rest of the rows fully masked: the
    forward on the live rows against the plain version over every row, the
    padded rows exactly zero, and two calls (the table given, then built by
    the wrapper) bitwise equal."""
    _needs_card()
    args, _ = _live_inputs(name)
    b, m = LIVE_SHAPES[name][:2]
    live = kfe.live_row_table(args[4])
    assert 0 < live.numel() < b * m
    before = kfe.fused_equiv_fwd.launches
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args, live_rows=live)
        again = kfe.fused_equiv_fwd(*args)
        torch.cuda.synchronize()
        ref = kfe.fused_equiv_fwd_reference(*args)
    assert kfe.fused_equiv_fwd.launches == before + 2
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (err, ref.abs().max().item())
    assert not got[~args[4].any(-1)].any()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_forward_kernel_over_several_scratch_chunks_matches_plain_version(monkeypatch):
    """A scratch cap of 1 MiB holds the basis rows of 14 live rows at C=256,
    Q=32, G=2: the forward walks the 180 live rows in 13 chunks."""
    _needs_card()
    args, _ = _live_inputs("live_15pct_g2_wide")
    live = kfe.live_row_table(args[4])
    assert live.numel() > 100
    whole = kfe.fused_equiv_fwd(*args, live_rows=live)
    monkeypatch.setattr(kfe, "FWD_SCRATCH_BYTES", 1 << 20)
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args, live_rows=live)
        torch.cuda.synchronize()
        ref = kfe.fused_equiv_fwd_reference(*args)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), (err, ref.abs().max().item())
    assert (got - whole).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_forward_kernel_with_no_live_row_returns_zeros_without_a_launch():
    _needs_card()
    args, _ = _live_inputs("live_count_off_tiles")
    args[4][:] = False
    live = kfe.live_row_table(args[4])
    before = kfe.fused_equiv_fwd.launches
    got = kfe.fused_equiv_fwd(*args, live_rows=live)
    assert got.shape == (3, 333, 2, 20) and not got.any()
    assert kfe.fused_equiv_fwd.launches == before


@pytest.mark.cuda
def test_forward_wrapper_rejects_a_bad_live_row_table():
    _needs_card()
    args, _ = _live_inputs("live_count_off_tiles")
    live = kfe.live_row_table(args[4])
    for bad in (live.long(), live.cpu(), live[None], torch.zeros(3 * 333 + 1, dtype=torch.int32, device="cuda")):
        with pytest.raises(ValueError):
            kfe.fused_equiv_fwd(*args, live_rows=bad)


def _with_rows_out_of_range(live, rows):
    """``live`` with entries outside ``[0, rows)`` before, among and after
    its own."""
    bad = torch.tensor([-1, rows, rows + 7, 2**31 - 1, -2**31], dtype=torch.int32, device="cuda")
    half = live.numel() // 2
    return torch.cat([bad[:2], live[:half], bad[2:4], live[half:], bad[4:]])


@pytest.mark.cuda
def test_kernels_skip_live_row_entries_out_of_range():
    """A table with entries outside [0, B*M): the forward and the backward
    (both output modes) read and write nothing for them, and give the
    outputs of the table without them."""
    _needs_card()
    args, gout = _live_inputs("live_15pct_g2_wide")
    b, m, n = LIVE_SHAPES["live_15pct_g2_wide"][:3]
    live = kfe.live_row_table(args[4])
    bad = _with_rows_out_of_range(live, b * m)
    tabs = _sort_tables(args[3], args[4], n)
    with torch.no_grad():
        want = kfe.fused_equiv_fwd(*args, live_rows=live)
        got = kfe.fused_equiv_fwd(*args, live_rows=bad)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert not got[~args[4].any(-1)].any()
    for slot in (None, tabs.bwd_slot):
        want_b = kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot, live_rows=live)
        got_b = kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot, live_rows=bad)
        torch.cuda.synchronize()
        for what, x, y in zip(("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights"), got_b, want_b):
            assert torch.isfinite(x).all(), what
            assert (x - y).abs().max().item() <= BWD_RTOL * y.abs().max().item(), what


# bfloat16 operands: the kernels round where their plain versions round
# (``kernels/fused_equiv.py``), and both sum in float32 in other orders,
# which can flip a pne, basis, dbasis, dpre or per-edge d_feats rounding by
# one bfloat16 ulp (2^-8 relative) where a sum lies next to a rounding
# boundary.  Such flips are rare, so each output is held within
# ``BF16_RTOL * max |plain|`` at its worst and ``BF16_MEAN_RTOL * max
# |plain|`` on average, and its mean error must be at most
# ``BF16_SOUND_SHARE`` of its mean error against the plain version with no
# bfloat16 rounding (the operands widened to float32, the float32 plain
# version): a kernel that skipped its roundings fails.
BF16_RTOL, BF16_MEAN_RTOL, BF16_SOUND_SHARE = 1e-2, 1e-4, 0.5
BWD_OUTPUTS = ("d_feats", "d_proj_axes", "d_proj_biases", "d_conv_weights")


def _bf16(args):
    """The conv operands rel, rot6 and feats in bfloat16; the rest as they are."""
    return [x.to(torch.bfloat16) if i < 3 else x for i, x in enumerate(args)]


def _hold_bf16(got, ref, what, wide=None):
    """``got`` against the bfloat16 plain version ``ref`` and, given the
    plain version with no bfloat16 rounding (``wide``), apart from it."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), what
    scale = max(ref.abs().max().item(), 1e-6)
    err = (got - ref).abs()
    assert err.max().item() <= BF16_RTOL * scale, (what, err.max().item(), scale)
    assert err.mean().item() <= BF16_MEAN_RTOL * scale, (what, err.mean().item(), scale)
    if wide is not None:
        control = (got - wide.float()).abs().mean().item()
        assert err.mean().item() <= BF16_SOUND_SHARE * control, (what, err.mean().item(), control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIVE_SHAPES))
def test_bf16_forward_kernel_matches_bf16_plain_version(name):
    """bfloat16 operands on the live rows: the bfloat16 instantiation (one
    launch each, counted as bfloat16) against the plain version's bfloat16
    rounding over every row, padded rows exactly zero, and two calls
    bitwise equal."""
    _needs_card()
    args, _ = _live_inputs(name)
    args = _bf16(args)
    b, m = LIVE_SHAPES[name][:2]
    live = kfe.live_row_table(args[4])
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_fwd.bf16_launches
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args, live_rows=live)
        again = kfe.fused_equiv_fwd(*args, live_rows=live)
        torch.cuda.synchronize()
        ref = kfe.fused_equiv_fwd_reference(*args)
        wide = kfe.fused_equiv_fwd_reference(*[x.float() if i < 3 else x for i, x in enumerate(args)])
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_fwd.bf16_launches) == (before[0] + 2, before[1] + 2)
    assert got.dtype == torch.float32
    _hold_bf16(got, ref, name, wide)
    assert not got[~args[4].any(-1)].any()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIVE_SHAPES))
def test_bf16_backward_kernel_matches_bf16_plain_version(name):
    """bfloat16 operands, both output modes: each output against the plain
    version's bfloat16 rounding (the sorted rows in bfloat16), the
    parameter gradients bitwise equal over two calls and across the modes,
    and the bfloat16 sorted rows summed by the prefix sum against the
    scatter mode's d_feats."""
    _needs_card()
    args, gout = _live_inputs(name)
    args = _bf16(args)
    n = LIVE_SHAPES[name][2]
    live = kfe.live_row_table(args[4])
    tabs = _sort_tables(args[3], args[4], n)
    before = kfe.fused_equiv_bwd.bf16_launches
    got = kfe.fused_equiv_bwd(*args, gout, live_rows=live)
    again = kfe.fused_equiv_bwd(*args, gout, live_rows=live)
    got_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live)
    torch.cuda.synchronize()
    assert kfe.fused_equiv_bwd.bf16_launches == before + 3
    ref = kfe.fused_equiv_bwd_reference(*args, gout)
    ref_s = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=tabs.bwd_slot)
    wide_args = [x.float() if i < 3 else x for i, x in enumerate(args)]
    wide = kfe.fused_equiv_bwd_reference(*wide_args, gout)
    wide_s = kfe.fused_equiv_bwd_reference(*wide_args, gout, sorted_slot=tabs.bwd_slot)
    assert got[0].dtype == torch.float32 and got_s[0].dtype == torch.bfloat16
    for what, x, y, w in zip(BWD_OUTPUTS, got, ref, wide):
        _hold_bf16(x, y, f"{name} {what}", w)
    _hold_bf16(got_s[0], ref_s[0], f"{name} sorted rows", wide_s[0])
    for x, y, z in zip(got[1:], again[1:], got_s[1:]):
        assert torch.equal(x, y) and torch.equal(x, z)
    before = segsum.blocked_cumsum.launches
    summed = segsum.sorted_segment_sum(got_s[0], tabs.bwd_run_start, tabs.bwd_run_end)
    assert segsum.blocked_cumsum.launches == before + 1
    err = (summed.reshape(got[0].shape) - got[0]).abs().max().item()
    assert err <= BWD_RTOL * got[0].abs().max().item(), err


@pytest.mark.cuda
def test_bf16_kernels_skip_live_row_entries_out_of_range():
    _needs_card()
    args, gout = _live_inputs("live_15pct_g2_wide")
    args = _bf16(args)
    b, m, n = LIVE_SHAPES["live_15pct_g2_wide"][:3]
    live = kfe.live_row_table(args[4])
    bad = _with_rows_out_of_range(live, b * m)
    tabs = _sort_tables(args[3], args[4], n)
    with torch.no_grad():
        want = kfe.fused_equiv_fwd(*args, live_rows=live)
        got = kfe.fused_equiv_fwd(*args, live_rows=bad)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert not got[~args[4].any(-1)].any()
    for slot in (None, tabs.bwd_slot):
        want_b = kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot, live_rows=live)
        got_b = kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot, live_rows=bad)
        torch.cuda.synchronize()
        for what, x, y in zip(BWD_OUTPUTS, got_b, want_b):
            assert torch.isfinite(x.float()).all(), what
            assert (x.float() - y.float()).abs().max().item() <= BWD_RTOL * y.float().abs().max().item(), what


@pytest.mark.cuda
def test_bf16_kernels_with_no_live_row_return_zeros_without_a_launch():
    _needs_card()
    args, gout = _live_inputs("live_count_off_tiles")
    args = _bf16(args)
    args[4][:] = False
    live = kfe.live_row_table(args[4])
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    assert not kfe.fused_equiv_fwd(*args, live_rows=live).any()
    for slot in (None, _sort_tables(args[3], args[4], LIVE_SHAPES["live_count_off_tiles"][2]).bwd_slot):
        assert not any(x.any() for x in kfe.fused_equiv_bwd(*args, gout, sorted_slot=slot, live_rows=live))
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == before


@pytest.mark.cuda
def test_bf16_forward_over_several_scratch_chunks_matches_plain_version(monkeypatch):
    """A scratch cap of 1 MiB: with basis rows of 2-byte values the forward
    walks its live rows in several chunks and gives the one-chunk result."""
    _needs_card()
    args, _ = _live_inputs("live_15pct_g2_wide")
    args = _bf16(args)
    live = kfe.live_row_table(args[4])
    with torch.no_grad():
        whole = kfe.fused_equiv_fwd(*args, live_rows=live)
        monkeypatch.setattr(kfe, "FWD_SCRATCH_BYTES", 1 << 20)
        got = kfe.fused_equiv_fwd(*args, live_rows=live)
        torch.cuda.synchronize()
        ref = kfe.fused_equiv_fwd_reference(*args)
    _hold_bf16(got, ref, "chunks")
    assert (got - whole).abs().max().item() <= 1e-5 * whole.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_mode", [False, True])
def test_bf16_conv_function_launches_the_bf16_kernels(sorted_mode, monkeypatch):
    """Through the autograd Function: one bfloat16 forward and backward
    launch; the feature gradient in bfloat16; in 'sorted' mode the prefix
    sum reads the backward's bfloat16 buffer as it is."""
    _needs_card()
    args = _bf16(_inputs(*SHAPES["slice_like"], seed=0))
    args[3] = torch.where(args[4], args[3], torch.zeros_like(args[3]))
    tabs = _sort_tables(args[3], args[4], SHAPES["slice_like"][2])
    for i in (2, 5, 6, 7):
        args[i].requires_grad_()
    payloads = []
    real = kfe.sorted_segment_sum
    monkeypatch.setattr(kfe, "sorted_segment_sum", lambda x, *a: (payloads.append(x.dtype), real(x, *a))[1])
    before = (kfe.fused_equiv_fwd.bf16_launches, kfe.fused_equiv_bwd.bf16_launches,
              segsum.blocked_cumsum.launches)
    out = kfe.fused_equiv(*args, (tabs.bwd_slot, tabs.bwd_run_start, tabs.bwd_run_end) if sorted_mode else None)
    out.square().sum().backward()
    assert (kfe.fused_equiv_fwd.bf16_launches, kfe.fused_equiv_bwd.bf16_launches,
            segsum.blocked_cumsum.launches) == (before[0] + 1, before[1] + 1, before[2] + sorted_mode)
    assert payloads == ([torch.bfloat16] if sorted_mode else [])
    assert args[2].grad.dtype == torch.bfloat16
    assert all(args[i].grad.dtype == torch.float32 for i in (5, 6, 7))


@pytest.mark.cuda
def test_bf16_wrappers_reject_mixed_operand_dtypes():
    _needs_card()
    args = _bf16(_inputs(*SHAPES["slice_like"], seed=0))
    with pytest.raises(TypeError):  # rel in float32 beside bfloat16 features
        kfe.fused_equiv_fwd(args[0].float(), *args[1:])
    with pytest.raises(TypeError):  # parameters stay float32
        kfe.fused_equiv_fwd(*args[:5], args[5].to(torch.bfloat16), *args[6:])
    with pytest.raises(TypeError):
        kfe.fused_equiv_fwd(*args[:2], args[2].half(), *args[3:])
    gout = torch.zeros(2, 300, 2, 32, device="cuda")
    with pytest.raises(ValueError):  # gout stays float32
        kfe.fused_equiv_bwd(*args, gout.to(torch.bfloat16))


# --- the standard geometry (kD = 3: G = F = 1, the raw offsets, no rot6) -------

STD_SHAPES = {
    # name: B, M, N, K, Q, C, O, valid-edge fraction, live-prefix fraction
    "std_dfaust_level1_like": (4, 2048, 2048, 32, 32, 32, 32, 0.7, 0.6),
    "std_scannet_level0_like": (1, 8192, 8192, 24, 32, 64, 64, 0.7, 0.17),
    "std_level4_like": (2, 128, 128, 32, 32, 256, 256, 0.7, 0.5),
    "std_ragged_q16_unaligned": (3, 77, 50, 9, 16, 37, 70, 0.6, 0.8),
    "std_modelnet_level5_like": (2, 256, 256, 32, 32, 512, 512, 0.7, 0.3),
}


def _std_inputs(name, dtype):
    """Seeded operands of the standard conv (``rot6`` None, ``proj_axes
    [3, Q]``; rel and feats in ``dtype``) and ``gout``; the rows past each
    example's live prefix are fully masked."""
    b, m, n, k, q, c, o, frac, live = STD_SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(60 + sorted(STD_SHAPES).index(name))

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")

    mask = torch.rand(b, m, k, generator=gen, device="cuda") < frac
    mask[:, int(live * m):] = False
    idx = torch.where(mask, torch.randint(0, n, (b, m, k), generator=gen, device="cuda"), 0)
    args = [(rnd(b, m, k, 1, 3) * 0.5).to(dtype), None, rnd(b, n, 1, c).to(dtype), idx, mask,
            rnd(3, q) * 0.3, rnd(q) * 0.1, rnd(c, q, o) * (c * q) ** -0.5]
    return args, torch.randn(b, m, 1, o, device="cuda", generator=gen)


def _hold_std(got, ref, what, dtype, rtol, wide=None):
    if dtype == torch.bfloat16:
        _hold_bf16(got, ref, what, wide)
        return
    assert got.shape == ref.shape and torch.isfinite(got).all(), what
    err = (got - ref).abs().max().item()
    assert err <= rtol * max(ref.abs().max().item(), 1e-6), (what, err, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(STD_SHAPES))
def test_std_kernels_match_plain_versions(name, dtype):
    """The kD = 3 instantiations against their plain versions: the forward
    on the live rows (padded rows exactly zero, two calls bitwise equal),
    the backward in both output modes with its parameter gradients ([3, Q]
    projection) bitwise equal across modes and calls; each launch counted at
    D = 3 (and as bfloat16 for bfloat16 operands); bfloat16 against the
    plain version's bfloat16 rounding and apart from its float32 control."""
    _needs_card()
    args, gout = _std_inputs(name, dtype)
    n = STD_SHAPES[name][2]
    bf16 = dtype == torch.bfloat16
    wide = [x.float() if i in (0, 2) else x for i, x in enumerate(args)] if bf16 else None
    live = kfe.live_row_table(args[4])
    tabs = _sort_tables(args[3], args[4], n)
    before = (dict(kfe.fused_equiv_fwd.launches_by_d), dict(kfe.fused_equiv_bwd.launches_by_d),
              kfe.fused_equiv_fwd.bf16_launches, kfe.fused_equiv_bwd.bf16_launches)
    with torch.no_grad():
        got = kfe.fused_equiv_fwd(*args, live_rows=live)
        again = kfe.fused_equiv_fwd(*args, live_rows=live)
    grads = kfe.fused_equiv_bwd(*args, gout, live_rows=live)
    grads_again = kfe.fused_equiv_bwd(*args, gout, live_rows=live)
    grads_s = kfe.fused_equiv_bwd(*args, gout, sorted_slot=tabs.bwd_slot, live_rows=live)
    torch.cuda.synchronize()
    fwd_d, bwd_d = kfe.fused_equiv_fwd.launches_by_d, kfe.fused_equiv_bwd.launches_by_d
    assert fwd_d.get(3, 0) == before[0].get(3, 0) + 2 and fwd_d.get(9, 0) == before[0].get(9, 0)
    assert bwd_d.get(3, 0) == before[1].get(3, 0) + 3 and bwd_d.get(9, 0) == before[1].get(9, 0)
    assert (kfe.fused_equiv_fwd.bf16_launches, kfe.fused_equiv_bwd.bf16_launches) == (
        before[2] + 2 * bf16, before[3] + 3 * bf16)
    with torch.no_grad():
        ref = kfe.fused_equiv_fwd_reference(*args)
    _hold_std(got, ref, f"{name} forward", dtype, 1e-5,
              kfe.fused_equiv_fwd_reference(*wide) if bf16 else None)
    assert got.shape == (*args[4].shape[:2], 1, args[7].shape[2])
    assert not got[~args[4].any(-1)].any()
    assert torch.equal(got, again)
    ref_b = kfe.fused_equiv_bwd_reference(*args, gout)
    ref_s = kfe.fused_equiv_bwd_reference(*args, gout, sorted_slot=tabs.bwd_slot)
    wide_b = kfe.fused_equiv_bwd_reference(*wide, gout) if bf16 else [None] * 4
    wide_s = kfe.fused_equiv_bwd_reference(*wide, gout, sorted_slot=tabs.bwd_slot) if bf16 else [None]
    assert tuple(grads[1].shape) == (3, STD_SHAPES[name][4])
    for what, x, y, w in zip(BWD_OUTPUTS, grads, ref_b, wide_b):
        _hold_std(x, y, f"{name} {what}", dtype, BWD_RTOL, w)
    _hold_std(grads_s[0], ref_s[0], f"{name} sorted rows", dtype, BWD_RTOL, wide_s[0])
    assert grads_s[0].dtype == dtype
    for x, y, z in zip(grads[1:], grads_again[1:], grads_s[1:]):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_mode", [False, True])
def test_std_conv_function_launches_the_std_kernels(sorted_mode):
    """Through the autograd Function with ``rot6`` None: one D = 3 forward
    and backward launch, a prefix sum in 'sorted' mode, and gradients for
    the features and the three parameters, on the card."""
    _needs_card()
    args, _ = _std_inputs("std_ragged_q16_unaligned", torch.float32)
    tabs = _sort_tables(args[3], args[4], STD_SHAPES["std_ragged_q16_unaligned"][2])
    for i in (2, 5, 6, 7):
        args[i].requires_grad_()
    before = (kfe.fused_equiv_fwd.launches_by_d.get(3, 0), kfe.fused_equiv_bwd.launches_by_d.get(3, 0),
              segsum.blocked_cumsum.launches)
    out = kfe.fused_equiv(*args, (tabs.bwd_slot, tabs.bwd_run_start, tabs.bwd_run_end) if sorted_mode else None)
    out.square().sum().backward()
    assert (kfe.fused_equiv_fwd.launches_by_d.get(3, 0), kfe.fused_equiv_bwd.launches_by_d.get(3, 0),
            segsum.blocked_cumsum.launches) == (before[0] + 1, before[1] + 1, before[2] + sorted_mode)
    assert all(args[i].grad is not None and args[i].grad.is_cuda for i in (2, 5, 6, 7))
    assert tuple(args[5].grad.shape) == (3, STD_SHAPES["std_ragged_q16_unaligned"][4])


@pytest.mark.cuda
def test_std_wrappers_reject_what_the_std_kernels_do_not_take():
    """Without rot6: a [9, Q] projection, G = 2 offsets, F = 2 features or
    Q > 64 raise before any launch."""
    _needs_card()
    args, gout = _std_inputs("std_ragged_q16_unaligned", torch.float32)
    q, c, o = STD_SHAPES["std_ragged_q16_unaligned"][4:7]
    bad = [
        [*args[:5], torch.zeros(9, q, device="cuda"), *args[6:]],
        [args[0].expand(-1, -1, -1, 2, -1).contiguous(), *args[1:]],
        [*args[:2], args[2].expand(-1, -1, 2, -1).contiguous(), *args[3:]],
        [*args[:5], torch.zeros(3, 65, device="cuda"), torch.zeros(65, device="cuda"),
         torch.zeros(c, 65, o, device="cuda")],
    ]
    before = kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches
    for a in bad:
        with pytest.raises(ValueError):
            kfe.fused_equiv_fwd(*a)
        with pytest.raises(ValueError):
            kfe.fused_equiv_bwd(*a, gout)
    assert (kfe.fused_equiv_fwd.launches, kfe.fused_equiv_bwd.launches) == before
