"""The probe kernels (``se3conv3d_tpu_torch/kernels/probes.py``) against
their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_probes_cuda.py``.
Tolerances: tensors within ``1e-5 * max |plain|`` (float32 sums in other
orders, the weight contraction in 3xTF32); scalars within ``1e-6 * sum
|terms|`` in float32 and ``1e-5 * sum |terms|`` in bfloat16 (both round at
the same points and sum in float32 in other orders, which can flip a
rounding by one ulp), the bfloat16 reading at most half of its control's
(the plain version without rounding).  The whole forward's ``[G, M, O]``
output of the tile-sum mode is also held value by value: float32 within
``1e-5 * max |plain|``, bfloat16 within ``1e-2`` (max) and ``1e-4`` (mean)
of ``max |plain|`` and its mean error at most half its control's, as the
conv kernels' card tests.  The fixed-order sums give the same bits twice.
The tile-sum kernel is also held at ``chip_stage_time``'s M = 65,536 and at
M = 65,536 + 48 (a multiple of its 16-row tile, not of 64), and b3 on
tensor cores against its plain version and ``torch.bmm`` within ``1e-5 *
max |plain|`` (3xTF32), bitwise equal twice.  The whole-tensor kernel is
held at every stage at M = 16, 48 and 1040, B = 1 and 2, D = 9, 18 and 19
(two calls bitwise equal, one kernel node a call in a CUDA graph), refuses
bfloat16, M not a multiple of 16, D > 19 and an unaligned operand, and
runs two blocks an SM with no local memory.
"""
import pytest
import torch

from se3conv3d_tpu_torch.experiments import bisect_fused, chip_stage_time
from se3conv3d_tpu_torch.kernels import probes
from se3conv3d_tpu_torch.kernels.build import library
from test_torch_mosaic_probes_cuda import _graph_node_types

SCALAR_RTOL = {torch.float32: 1e-6, torch.bfloat16: 1e-5}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernels are CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(bisect_fused.STAGES))
def test_bisect_probe_kernel_matches_plain(name):
    _needs_card()
    inputs = bisect_fused.draw(name, 3, "cuda")
    got = bisect_fused.STAGES[name](*inputs)
    torch.cuda.synchronize()
    bisect_fused.check(got, bisect_fused.REFERENCES[name](*inputs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", list(chip_stage_time.STAGES))
def test_stage_sum_kernel_matches_plain(stage, dtype):
    _check_stage_sum(stage, dtype, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [65536, 65536 + 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", list(chip_stage_time.STAGES))
def test_stage_sum_kernel_matches_plain_at_bench_sizes(stage, dtype, m):
    _check_stage_sum(stage, dtype, m)
    torch.cuda.empty_cache()


def _check_stage_sum(stage, dtype, m):
    _needs_card()
    args = chip_stage_time.make_inputs(m, 5, "cuda")
    kstage = chip_stage_time.STAGES[stage]
    got = probes.stage_sum(*args, stage=kstage, cdt=dtype)
    again = probes.stage_sum(*args, stage=kstage, cdt=dtype)
    torch.cuda.synchronize()
    ref = probes.stage_sum_reference(*args, stage=kstage, cdt=dtype)
    terms = float(probes.stage_forward_reference(*args[:3], args[3], None, kstage, dtype).abs().sum())
    assert torch.equal(got, again)
    err = abs(float(got) - float(ref)) / terms
    assert err <= SCALAR_RTOL[dtype]
    if dtype == torch.bfloat16:
        control = abs(float(got) - float(probes.stage_sum_reference(*args, stage=kstage))) / terms
        assert err <= 0.5 * control
    if kstage == "reduce":  # the [G, M, O] output the tile-sum mode writes, each value
        out = torch.empty(chip_stage_time.G, m, chip_stage_time.O, device="cuda")
        assert torch.equal(probes.stage_sum(*args, stage=kstage, cdt=dtype, out=out), got)
        ref_t = probes.stage_forward_reference(*args[:3], args[3], None, kstage, dtype)
        diff = (out - ref_t).abs()
        scale = float(ref_t.abs().max())
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-5 * scale
        else:
            control = (out - probes.stage_forward_reference(*args[:3], args[3], None, kstage)).abs()
            assert float(diff.max()) <= 1e-2 * scale and float(diff.mean()) <= 1e-4 * scale
            assert float(diff.mean()) <= 0.5 * float(control.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 19, 128])
def test_column_sums_kernel_matches_plain(width):
    _needs_card()
    x = torch.randn(100_000, width, device="cuda", generator=torch.Generator(device="cuda").manual_seed(width))
    got, again = probes.column_sums(x), probes.column_sums(x)
    torch.cuda.synchronize()
    ref = probes.column_sums_reference(x.double())
    assert torch.equal(got, again)
    terms = x.double().abs().sum(0)
    assert float(((got[:width].double() - ref[:width]).abs() / terms).max()) <= 1e-6
    assert abs(float(got[width]) - float(ref[width])) <= 1e-6 * float(terms.sum())


@pytest.mark.cuda
def test_batched_contract_on_tensor_cores_matches_plain_and_bmm():
    _needs_card()
    a, b = bisect_fused.draw("b3_dw2_contract11", 8, "cuda")
    got, again = probes.batched_contract(a, b), probes.batched_contract(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for ref in (probes.batched_contract_reference(a, b), torch.bmm(a.transpose(1, 2), b)):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    # a shape that is not a multiple of the 32 x 32 quadrant or the 32-row slice
    a, b = a[:3, :77, :36].contiguous(), b[:3, :77, :20].contiguous()
    ref = probes.batched_contract_reference(a, b)
    assert float((probes.batched_contract(a, b) - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_rank3_accum_kernel_repeats_its_bits():
    _needs_card()
    (a,) = bisect_fused.draw("b4_rank3_accum", 4, "cuda")
    got, again = (probes.rank3_accum(a, bisect_fused.GQ, bisect_fused.O, bisect_fused.TM) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def _stage_inputs(b, m, d, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(b, m * probes.STAGE_E, d, device="cuda", generator=gen),
            torch.randn(b, m, probes.STAGE_E, probes.STAGE_C, device="cuda", generator=gen),
            torch.randn(d, probes.STAGE_GQ, device="cuda", generator=gen) * 0.2,
            torch.randn(probes.STAGE_GQ, probes.STAGE_C, probes.STAGE_O, device="cuda", generator=gen) * 0.1,
            torch.randn(1, probes.STAGE_GQ, device="cuda", generator=gen) * 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(probes.STAGES))
@pytest.mark.parametrize("b, m, d", [(1, 16, 18), (2, 48, 9), (2, 1040, 19), (1, 1040, 18), (2, 16, 19)])
def test_stage_forward_matches_plain_at_other_shapes(stage, b, m, d):
    _needs_card()
    geo, feat, proj, w, bias = _stage_inputs(b, m, d, m + d + b)
    got, again = (probes.stage_forward(geo, feat, proj, w, bias, stage) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    bisect_fused.check(got, probes.stage_forward_reference(geo, feat, proj, w, bias, stage))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(probes.STAGES))
def test_stage_forward_is_one_launch(stage):
    _needs_card()
    geo, feat, proj, w, bias = _stage_inputs(1, 64, 18, 9)
    before = probes.stage_forward.launches
    assert _graph_node_types(lambda: probes.stage_forward(geo, feat, proj, w, bias, stage)) == [0]
    assert probes.stage_forward.launches == before + 2


@pytest.mark.cuda
def test_stage_forward_refuses_what_it_does_not_take():
    _needs_card()
    geo, feat, proj, w, bias = _stage_inputs(1, 48, 18, 10)
    with pytest.raises(ValueError, match="multiple of 16"):
        probes.stage_forward(geo[:, :40 * probes.STAGE_E], feat[:, :40].contiguous(), proj, w, bias, "reduce")
    g20, _, p20, _, _ = _stage_inputs(1, 48, 20, 11)
    with pytest.raises(ValueError, match="D <= 19"):
        probes.stage_forward(g20, feat, p20, w, bias, "reduce")
    # geo one float past a 16-byte boundary: the C entry refuses it
    shifted = torch.empty(geo.numel() + 1, device="cuda")[1:].view(geo.shape).copy_(geo)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        probes.stage_forward(shifted, feat, proj, w, bias, "agg")
    out = torch.empty(1, probes.STAGE_G, 48, probes.STAGE_O, device="cuda")
    lib = library("probe_stage")
    stream = torch.cuda.current_stream().cuda_stream
    args = lambda m, d, bf16: (geo.data_ptr(), feat.data_ptr(), proj.data_ptr(), bias.data_ptr(),  # noqa: E731
                               w.data_ptr(), None, out.data_ptr(), None, None, 1, m, d, probes.STAGES["reduce"],
                               0, bf16, stream)
    assert lib.se3_probe_stage_fwd(*args(48, 18, 1)) == 1   # bfloat16 in whole-tensor mode
    assert lib.se3_probe_stage_fwd(*args(40, 18, 0)) == 1   # M not a multiple of 16
    assert lib.se3_probe_stage_fwd(*args(48, 20, 0)) == 1   # D > 19
    assert lib.se3_probe_stage_fwd(*args(48, 18, 0)) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_stage_forward_kernel_takes_a_bias():
    _needs_card()
    geo, feat, proj, _, w2 = bisect_fused.draw("s1_pne", 6, "cuda")
    with pytest.raises(ValueError, match="bias"):
        probes.stage_forward(geo, feat, proj, w2, None, "pne")


@pytest.mark.cuda
def test_stage_kernel_attributes():
    """The whole-tensor kernel: two blocks an SM (at most 128 registers a
    thread, at most 115,200 bytes of shared memory a block), no local
    memory; the tile-sum kernel: one
    persistent block of 384 threads an SM (the W ring, the basis blocks,
    the feat ring and the tile's pne in shared memory: 230,592 bytes in
    float32, 206,112 in bfloat16), at most 168 registers a thread at
    launch (65,536 over 384 threads; the consumers take 232 of them with
    setmaxnreg), at most 16 local bytes (ptxas spills 8-16 bytes in the
    float32 instantiations, none in bfloat16), and a grid of every SM's
    block."""
    _needs_card()
    for stage in probes.STAGES:
        attrs = probes.stage_kernel_attributes(stage, False)
        assert 0 < attrs["registers"] <= 128 and 0 < attrs["dynamic_smem"] <= 115200
        assert attrs["local_bytes"] == 0 and attrs["blocks_per_sm"] >= 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for stage in ("pne", "agg", "swap", "reduce"):
        for dtype in (torch.float32, torch.bfloat16):
            attrs = probes.stage_kernel_attributes(stage, True, dtype)
            assert 0 < attrs["registers"] <= 168 and attrs["local_bytes"] <= 16
            assert attrs["dynamic_smem"] == (230592 if dtype == torch.float32 else 206112)
            assert attrs["blocks_per_sm"] == 1 and attrs["grid_blocks"] == sms
