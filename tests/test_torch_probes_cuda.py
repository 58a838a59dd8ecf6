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
"""
import pytest
import torch

from se3conv3d_tpu_torch.experiments import bisect_fused, chip_stage_time
from se3conv3d_tpu_torch.kernels import probes

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
    _needs_card()
    args = chip_stage_time.make_inputs(2048, 5, "cuda")
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
        out = torch.empty(chip_stage_time.G, 2048, chip_stage_time.O, device="cuda")
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
def test_rank3_accum_kernel_repeats_its_bits():
    _needs_card()
    (a,) = bisect_fused.draw("b4_rank3_accum", 4, "cuda")
    got, again = (probes.rank3_accum(a, bisect_fused.GQ, bisect_fused.O, bisect_fused.TM) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_stage_forward_kernel_takes_a_bias():
    _needs_card()
    geo, feat, proj, _, w2 = bisect_fused.draw("s1_pne", 6, "cuda")
    with pytest.raises(ValueError, match="bias"):
        probes.stage_forward(geo, feat, proj, w2, None, "pne")


@pytest.mark.cuda
def test_stage_kernel_attributes():
    _needs_card()
    for stage in probes.STAGES:
        attrs = probes.stage_kernel_attributes(stage, False)
        assert 0 < attrs["registers"] <= 255 and attrs["dynamic_smem"] > 0
    for stage in ("pne", "agg", "swap", "reduce"):
        for dtype in (torch.float32, torch.bfloat16):
            assert probes.stage_kernel_attributes(stage, True, dtype)["registers"] > 0
