"""Host-side logic of the staged forward's tile-sum kernel and of the probe
bounds that ``chip_smoke.py`` prints beside the redesigned probe kernels.

- The bounds: the tile-sum forward runs its pne, aggregation and weight
  products on tensor cores, so ``probe_bound(..., tensor_cores=True)``
  charges every float32 product FLOP at the 3xTF32 ceiling (a third of
  495 TFLOP/s): at ``chip_stage_time``'s bench shape 56.64 GFLOP / 165
  TFLOP/s = 0.343 ms.  The bfloat16 bound, the whole-tensor mode's (FMA)
  bound and b3's (3xTF32 products, bytes-bound at its shape) are
  reckoned as the formula says.
- The tiles: ``B`` batches of ``M`` rows, ``M`` a multiple of 16, give
  ``B * M / 16`` tiles, one partial each; W's L2 reads are one image a
  tile.
- The wrapper's contract: M a multiple of 16 is taken, anything else is
  refused with the same error as before (checked on ``meta`` tensors, so
  no memory is touched).
"""
import importlib.util
import os

import pytest
import torch

from se3conv3d_tpu_torch.experiments import bisect_fused, chip_stage_time
from se3conv3d_tpu_torch.kernels import probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_M = 65536


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_stage_float32_bound_is_at_the_3xtf32_ceiling(smoke):
    work = chip_stage_time.stage_work("full", BENCH_M)
    assert (work["fma_flops"] + work["product_flops"]) / 1e9 == pytest.approx(56.64, abs=0.01)
    bound = smoke.probe_bound(work, torch.float32, tensor_cores=True)
    assert bound["bound_ms"] == pytest.approx(0.343, abs=5e-4)
    assert bound["bound_by"] == "operations"
    # the FMA ceiling it replaces: 22.28 GFLOP at 67 TFLOP/s plus the product at 165
    old = smoke.probe_bound(work, torch.float32)
    assert old["bound_ms"] == pytest.approx(0.5408, abs=5e-4)


@pytest.mark.parametrize("stage", list(chip_stage_time.STAGES))
def test_bfloat16_stage_bound_is_unchanged(smoke, stage):
    work = chip_stage_time.stage_work(stage, BENCH_M)
    with_tc = smoke.probe_bound(work, torch.bfloat16, tensor_cores=True)
    assert with_tc == smoke.probe_bound(work, torch.bfloat16)
    assert with_tc["bound_by"] == "bytes"
    if stage == "full":
        assert with_tc["bound_ms"] == pytest.approx(0.2182, abs=5e-4)


@pytest.mark.parametrize("stage", ["pne", "agg", "swap"])
def test_float32_stage_bounds_charge_every_product_at_the_3xtf32_ceiling(smoke, stage):
    work = chip_stage_time.stage_work(stage, BENCH_M)
    bound = smoke.probe_bound(work, torch.float32, tensor_cores=True)
    t_ops = work["fma_flops"] / (smoke.PEAK_TF32_FLOPS / 3) * 1e3
    t_bytes = work["bytes"] / smoke.PEAK_BYTES_PER_S * 1e3
    assert bound["bound_ms"] == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
    assert bound["bound_ms"] <= smoke.probe_bound(work, torch.float32)["bound_ms"]


def test_b3_bound_at_its_shape(smoke):
    gq, r, c, o = bisect_fused.GQ, bisect_fused.TM, bisect_fused.C, bisect_fused.O
    flops = 2.0 * gq * r * c * o
    nbytes = 4.0 * (gq * r * c + gq * r * o + gq * c * o)
    bound = smoke.probe_bound({"product_flops": flops, "bytes": nbytes})
    assert flops / 1e6 == pytest.approx(67.11, abs=0.01)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(nbytes / smoke.PEAK_BYTES_PER_S * 1e3, rel=1e-12)
    assert bound["bound_ms"] == pytest.approx(0.0016, abs=5e-5)
    assert flops / (smoke.PEAK_TF32_FLOPS / 3) * 1e3 < bound["bound_ms"]


@pytest.mark.parametrize("b, m, tiles", [(1, BENCH_M, 4096), (2, 2048, 256), (3, 48, 9), (1, 16, 1)])
def test_stage_tiles(b, m, tiles):
    assert probes.stage_tiles(b, m) == tiles


@pytest.mark.parametrize("m", [8, 40, BENCH_M + 8])
def test_stage_tiles_refuse_a_partial_tile(m):
    with pytest.raises(ValueError, match="multiple of 16"):
        probes.stage_tiles(1, m)


def test_w_l2_bytes_from_the_tiling():
    assert probes.stage_w_l2_bytes(1, BENCH_M) == 4 * 2**30
    assert probes.stage_w_l2_bytes(1, BENCH_M, torch.bfloat16) == 2 * 2**30
    assert probes.stage_w_l2_bytes(2, 2048) == 256 * 2**20


def _meta_operands(m, d=chip_stage_time.GD1):
    meta = torch.device("meta")
    return (torch.empty(m * probes.STAGE_E, d, device=meta), torch.empty(m, probes.STAGE_E, probes.STAGE_C, device=meta),
            torch.empty(d, probes.STAGE_GQ, device=meta),
            torch.empty(probes.STAGE_GQ, probes.STAGE_C, probes.STAGE_O, device=meta))


def test_wrapper_takes_m_a_multiple_of_16():
    geo, feat, proj, w = _meta_operands(BENCH_M)
    assert probes._stage_shapes(geo, feat, proj, w, None) == (1, BENCH_M, chip_stage_time.GD1, 16)


@pytest.mark.parametrize("m", [8, BENCH_M + 8, BENCH_M + 4])
def test_wrapper_refuses_other_m(m):
    geo, feat, proj, w = _meta_operands(m)
    with pytest.raises(ValueError, match="M a multiple of 16"):
        probes._stage_shapes(geo, feat, proj, w, None)

