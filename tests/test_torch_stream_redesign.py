"""The Hopper design of the bisect probe's GELU jvp (b1) and edge merge (b5):
one streaming kernel, ``stream_map<Op>`` in
``kernels/csrc/probe_bwd_ops.cu`` (one float4 a thread), with b1's map
``gelu_tanh_jvp`` (``probe_common.cuh``: one exponential a value, no
branch).

On the CPU, where the kernel cannot run: the bounds ``chip_smoke.py``
charges stay the byte bounds, b1's yardstick is ``F.gelu(a,
approximate="tanh")``, the float32 mirror of the kernel's arithmetic
(``probes.gelu_jvp_exp_form``, ``torch.exp2`` for the card's ``ex2.approx``)
stays within ``1e-6 (1 + |ref|)`` of float64 over ``chip_smoke``'s sweep
with no NaN at the clamp, ``probe_variants.py``'s ``b1`` and ``b5``
edits apply to the source, and ``probe_ab.py``'s timing sizes each CUDA
graph so that one replay runs at least ``GRAPH_FLOOR_MS``.

On the card (``cuda`` marker; skipped elsewhere; the file imports torch
only: ``python -m pytest --noconftest -q
tests/test_torch_stream_redesign.py``): b5 bit for bit ``2a`` at the bisect
shape, at n = 4 and at counts whose last block is partial; b1 within
``1e-6 (1 + |ref|)`` of float64 for every value of the sweep and within ``bisect_fused.RTOL`` at the bisect draw; two calls the
same bits; one kernel node a call; no local or shared memory; the
refusals of the wrappers and the C entries.
"""
import importlib.util
import os

import pytest
import torch
import torch.nn.functional as F

from se3conv3d_tpu_torch.experiments import bisect_fused as bf
from se3conv3d_tpu_torch.kernels import probes
from test_torch_mosaic_probes_cuda import _graph_node_types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BISECT_N = bf.TM * bf.E * bf.GQ  # b1's [TM*E, GQ] and b5's [TM, E, GQ]: 262,144 floats
# counts whose last block of 256 float4s is partial
PARTIAL = (4 * (256 * 3 + 7), 4 * (256 + 1), 4 * (256 * 280 + 5))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke_stream", "chip_smoke.py")


# --- the bounds and the yardstick chip_smoke.py charges ---------------------------------------

@pytest.mark.parametrize("name", ["b1_jvp_gelu", "b5_merge_back"])
def test_b1_b5_bounds_stay_the_byte_bound(smoke, name):
    """1 MiB read and 1 MiB written: 0.63 us at 3.35 TB/s."""
    (a,) = bf.draw(name, 3, "cpu")
    bound = smoke.probe_bound({"bytes": 4.0 * 2 * a.numel()})
    assert a.numel() == BISECT_N
    assert bound["bound_by"] == "bytes" and bound["bound_ms"] == pytest.approx(0.0006, abs=5e-5)


def test_b1_yardstick_is_the_tanh_gelu_of_the_same_shape(smoke):
    (a,) = bf.draw("b1_jvp_gelu", 4, "cpu")
    got = smoke.BISECT_YARDSTICK["b1_jvp_gelu"](a, *a.shape)
    assert got.shape == a.shape and got.dtype == torch.float32
    assert torch.equal(got, F.gelu(a, approximate="tanh"))
    assert "yardstick_ms" in smoke.BISECT_NO_LIBRARY["b1_jvp_gelu"]


# --- b1's arithmetic --------------------------------------------------------------------------

def test_the_float32_mirror_is_within_its_bound_over_the_sweep(smoke):
    x = smoke.gelu_jvp_sweep("cpu")
    assert x.numel() % 4 == 0 and {1e4, -1e4, -20.0, 20.0} <= set(x.tolist())
    got = probes.gelu_jvp_exp_form(x)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert smoke.gelu_jvp_sweep_error(got, x) <= smoke.GELU_JVP_SWEEP_RTOL


@pytest.mark.parametrize("x", [-1e4, -1e3, -60.0, -30.0, -9.95, -9.7, 9.7, 30.0, 1e4, 3e12, -3e12])
def test_the_mirror_gives_no_nan_at_the_clamp(x):
    """Past the exponent's clamp (127) and where 1 + e passes 2^126 (x below
    about -9.9, s = 0) the value is 0, not a NaN, an inf or the s e s g
    that an s left above 0 would leave at large |x| (g grows as x^3); at
    +-3e12, x^3 is near float32's largest."""
    v = torch.tensor([x], dtype=torch.float32)
    got = probes.gelu_jvp_exp_form(v)
    assert torch.isfinite(got).all()
    want = max(x, 0.0) + (1.0 if x > 0 else 0.0)  # gelu + gelu' -> x + 1 and 0
    assert abs(float(got) - want) <= 1e-6 * (1.0 + abs(want))


def test_sweep_error_flags_a_wrong_value_and_a_nan(smoke):
    x = smoke.gelu_jvp_sweep("cpu")
    got = probes.gelu_jvp_exp_form(x)
    bad = got.clone()
    bad[123_456] += 1e-3 * (1.0 + abs(float(bad[123_456])))
    assert smoke.gelu_jvp_sweep_error(bad, x) > smoke.GELU_JVP_SWEEP_RTOL
    bad[123_456] = float("nan")
    assert smoke.gelu_jvp_sweep_error(bad, x) == float("inf")


@pytest.mark.parametrize("name", ["b1_jvp_gelu", "b5_merge_back"])
def test_the_cpu_wrappers_run_the_plain_versions(name):
    (a,) = bf.draw(name, 5, "cpu")
    before = (probes.gelu_jvp.launches, probes.merge_back.launches)
    assert torch.equal(bf.STAGES[name](a), bf.REFERENCES[name](a))
    assert (probes.gelu_jvp.launches, probes.merge_back.launches) == before


# --- the measurement scripts ------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["b1", "b5"])
def test_probe_variants_apply_to_the_source(kernel):
    pv = _load(f"probe_variants_stream_{kernel}", "probe_variants.py")
    source, _, _, variants = pv.KERNELS[kernel]
    base = open(os.path.join(REPO, "se3conv3d_tpu_torch", "kernels", "csrc", source)).read()
    texts = [pv.variant_source(base, edits) for edits, _ in variants.values()]
    assert texts[0] == base and all(t != base for t in texts[1:])
    assert len(set(texts)) == len(texts)
    assert not any(diagnostic for _, diagnostic in variants.values())


def test_probe_ab_reads_b1s_kernels_in_the_sass():
    pa = _load("probe_ab_stream", "probe_ab.py")
    assert pa.demangle("_ZN12_GLOBAL__N_110stream_mapINS_7GeluJvpEEEvPK6float4PS2_j") == "stream_map<GeluJvp>"
    assert pa.demangle("_ZN12_GLOBAL__N_110stream_mapINS_6Scale2EEEvPK6float4PS2_j") == "stream_map<Scale2>"
    assert pa.demangle("_ZN12_GLOBAL__N_18gelu_jvpEPK6float4PS1_x") == "gelu_jvp"
    line = pa.sass_line(".", {"build_s": 1.0, "sass": {"probe_bwd": {"stream_map<GeluJvp>": [0, 0, 4, 8],
                                                                     "gelu_jvp": [0, 0, 8, 16]}}})
    assert "stream_map<GeluJvp> 4, 8 (1.00 EX2 a value)" in line and "gelu_jvp 8, 16" in line


REPLAY_MS = 0.011  # a graph replay's fixed cost on an H100, as the fake below charges it


@pytest.mark.parametrize("kernel_ms", [0.0006, 0.0018, 0.005, 0.0195, 0.03, 0.5])
def test_probe_ab_sizes_each_graph_past_the_replay_cost(kernel_ms):
    """A graph of ``calls`` calls of a ``kernel_ms`` kernel reads (calls
    kernel_ms + REPLAY_MS) / calls a call: the timing adds calls until one
    replay runs at least GRAPH_FLOOR_MS, so the fixed cost is at most about
    a tenth of what is read; a kernel whose 5 calls already run that long is
    timed once, at 5 calls, as before."""
    pa = _load("probe_ab_floor", "probe_ab.py")
    seen = []

    def fake_graph_ms(fn, side, calls=5):
        seen.append(calls)
        return (calls * kernel_ms + REPLAY_MS) / calls

    ms = pa.floor_graph_ms(fake_graph_ms)(None, None)
    assert seen[0] == 5 and seen == sorted(seen) and len(seen) <= 4
    assert seen[-1] * ms >= pa.GRAPH_FLOOR_MS or seen[-1] == pa.GRAPH_MAX_CALLS
    if 5 * kernel_ms + REPLAY_MS >= pa.GRAPH_FLOOR_MS:
        assert seen == [5]
    else:
        assert ms <= kernel_ms * (1.0 + 1.3 * REPLAY_MS / pa.GRAPH_FLOOR_MS)


# --- on the card ------------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernels are CUDA-only")


def _entry(symbol, a, out):
    from se3conv3d_tpu_torch.kernels.build import library

    return getattr(library("probe_bwd"), symbol)(a.data_ptr(), out.data_ptr(), a.numel(),
                                                 torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [BISECT_N, 4, 8, 1024, *PARTIAL])
def test_merge_back_is_2a_bit_for_bit(n):
    _needs_card()
    a = torch.randn(n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(n))
    a[:4] = torch.tensor([-0.0, float("inf"), 3e38, -1e-40])[: min(4, n)]
    x = a.view(-1, 4)
    got, again = probes.merge_back(x), probes.merge_back(x)
    torch.cuda.synchronize()
    want = (a * 2.0).view(-1, 4)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_the_c_entries_map_every_float4_once():
    _needs_card()
    for n in (4, BISECT_N, *PARTIAL):
        a = torch.randn(n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(n + 1))
        out = torch.full_like(a, float("nan"))
        assert _entry("se3_probe_scale2", a, out) == 0
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), (a * 2.0).view(torch.int32))
        sweep = _smoke_sweep()
        got = torch.full_like(sweep, float("nan"))
        assert _entry("se3_probe_gelu_jvp", sweep, got) == 0
        torch.cuda.synchronize()
        assert _smoke().gelu_jvp_sweep_error(got, sweep) <= _smoke().GELU_JVP_SWEEP_RTOL


_SMOKE = []


def _smoke():
    if not _SMOKE:
        _SMOKE.append(_load("chip_smoke_stream_card", "chip_smoke.py"))
    return _SMOKE[0]


def _smoke_sweep():
    return _smoke().gelu_jvp_sweep("cuda")


@pytest.mark.cuda
def test_gelu_jvp_is_within_its_bound_of_float64_for_every_value():
    _needs_card()
    sweep = _smoke_sweep()
    got, again = probes.gelu_jvp(sweep), probes.gelu_jvp(sweep)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert _smoke().gelu_jvp_sweep_error(got, sweep) <= _smoke().GELU_JVP_SWEEP_RTOL


EXTREMES = (-3e12, -1e12, -1e9, -1e6, -1e4, -100.0, -9.95, 9.95, 100.0, 1e6, 1e9, 3e12)


@pytest.mark.cuda
def test_gelu_jvp_at_extreme_values():
    """Far past the sweep: near 0 below x = -9.9 (s = 0 where 1 + e >
    2^126) and x + 1 above, finite, as the CPU mirror gives."""
    _needs_card()
    x = torch.tensor(EXTREMES, device="cuda")
    got = probes.gelu_jvp(x).cpu()
    want = torch.tensor([max(v, 0.0) + (1.0 if v > 0 else 0.0) for v in EXTREMES])
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-6 * (1.0 + want.abs())).all(), got


@pytest.mark.cuda
def test_gelu_jvp_at_the_bisect_draw():
    _needs_card()
    (a,) = bf.draw("b1_jvp_gelu", 7, "cuda")
    got, again = probes.gelu_jvp(a), probes.gelu_jvp(a)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    bf.check(got, probes.gelu_jvp_reference(a))
    assert _smoke().gelu_jvp_sweep_error(got, a) <= _smoke().GELU_JVP_SWEEP_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["b1_jvp_gelu", "b5_merge_back"])
def test_each_call_is_one_kernel(name):
    _needs_card()
    (a,) = bf.draw(name, 8, "cuda")
    wrapper = {"b1_jvp_gelu": probes.gelu_jvp, "b5_merge_back": probes.merge_back}[name]
    before = wrapper.launches
    assert _graph_node_types(lambda: wrapper(a)) == [0]
    assert wrapper.launches == before + 2  # the warm-up and the captured call


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gelu_jvp", "merge_back"])
def test_stream_kernels_use_no_local_or_shared_memory(op):
    _needs_card()
    attrs = probes.stream_kernel_attributes(op)
    assert attrs["local_bytes"] == 0 and attrs["static_smem"] == 0 and attrs["dynamic_smem"] == 0, attrs


@pytest.mark.cuda
def test_wrappers_and_c_entries_refuse_what_the_kernel_does_not_take():
    _needs_card()
    base = torch.zeros(1025, device="cuda")
    before = (probes.gelu_jvp.launches, probes.merge_back.launches)
    for fn in (probes.gelu_jvp, probes.merge_back):
        for bad in (base[:1022].view(-1, 2), base[1:1025].view(-1, 4), base[:0].view(0, 4)):
            with pytest.raises(ValueError):
                fn(bad)
        with pytest.raises(ValueError):  # float64
            fn(torch.zeros(8, 4, device="cuda", dtype=torch.float64))
    assert (probes.gelu_jvp.launches, probes.merge_back.launches) == before
    out = torch.empty(1024, device="cuda")
    for symbol in ("se3_probe_gelu_jvp", "se3_probe_scale2"):
        assert _entry(symbol, base[:1022], out[:1022]) != 0  # n % 4 != 0
        assert _entry(symbol, base[:0], out[:0]) != 0  # n = 0
        assert _entry(symbol, base[1:1025], out) != 0  # a off 16 bytes
        assert _entry(symbol, base[:1024], base[1:1025]) != 0  # out off 16 bytes
        assert _entry(symbol, base[:1024], out) == 0
    torch.cuda.synchronize()
