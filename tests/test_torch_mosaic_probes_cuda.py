"""The kernels of the last Mosaic probe sites (``kernels/probes.py``'s
accumulators, ``kernels/cellconv_probes.py``, ``kernels/mosaic_probes.py``)
against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_mosaic_probes_cuda.py``.
Tolerances, as the CLIs hold them: gathers, copies, ``2a`` and the r-ordered
sums bit for bit; the accumulators' totals within ``1e-9 * sum |a|`` of
the float64 total and the column sums within ``1e-6`` of each column's ``sum |a|`` (float32 sums
in other orders); products within ``1e-5 * max |plain|`` (float32 sums in
other orders, TF32 off; bfloat16 products are exact in float32); p3's pne
bit for bit (no mask disagreement).  Every fixed-order sum gives the same
bits on a second call.
"""
import pytest
import torch

from se3conv3d_tpu_torch.experiments import bisect_accum, bisect_accum2, probe_cellconv, probe_mosaic
from se3conv3d_tpu_torch.kernels import cellconv_probes, mosaic_probes, probes


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernels are CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("combo", bisect_accum2.COMBINATIONS + ((("dproj", "dbias", "dw2"), True), ((), True)),
                         ids=lambda c: bisect_accum2.tag(*c) if c[0] else "dfeat")
def test_block_total_accum_matches_plain(combo):
    _needs_card()
    names, with_dfeat = combo
    shapes = [bisect_accum2.SHAPES[n] for n in names]
    a = bisect_accum.draw(16, 7, "cuda")
    before = probes.block_total_accum.launches
    got = probes.block_total_accum(a, shapes, with_dfeat)
    again = probes.block_total_accum(a, shapes, with_dfeat)
    torch.cuda.synchronize()
    assert probes.block_total_accum.launches == before + 2
    bisect_accum.check_accum(a, got, shapes, with_dfeat)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_grid_column_accum_matches_plain():
    _needs_card()
    (a,) = probe_mosaic.draw("p11_grid_accum", 3, "cuda")
    got = probes.grid_column_accum(a)
    again = probes.grid_column_accum(a)
    probe_mosaic.check("p11_grid_accum", [a], got)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("part", probe_cellconv.PARTS)
def test_cellconv_part_matches_plain(part):
    _needs_card()
    x = probe_cellconv.draw(part, 11, "cuda")
    pne = torch.empty(probe_cellconv.QB3 * probe_cellconv.Q3, probe_cellconv.CAND, device="cuda") \
        if part == "p3" else None
    got, again = probe_cellconv.run(part, x, pne), probe_cellconv.run(part, x)
    torch.cuda.synchronize()
    probe_cellconv.check(part, x, got, pne)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_masked_dist_product_at_the_radius_matches_plain():
    """Pairs planted within a few ulps of d2 = 0.04: the kernel's pne (its
    squares and sums rounded step by step) equals the plain version's on
    the card and on the CPU bit for bit, so no pair flips its mask."""
    _needs_card()
    gen = torch.Generator().manual_seed(5)
    qp = torch.rand(probe_cellconv.QB3 * probe_cellconv.Q3, 8, generator=gen)
    cp = torch.rand(probe_cellconv.CAND, 8, generator=gen)
    d = torch.randn(probe_cellconv.CAND, 3, generator=gen, dtype=torch.float64)
    k = torch.arange(probe_cellconv.CAND, dtype=torch.float64) % 17 - 8
    r = 0.2 * (1 + k * 2.0 ** -24)
    cp[:, :3] = (qp[(torch.arange(probe_cellconv.CAND) * 37) % qp.shape[0], :3].double()
                 + r[:, None] * d / d.norm(dim=1, keepdim=True)).float()
    cf = torch.randn(probe_cellconv.CAND, probe_cellconv.C, generator=gen)
    x = {"qp": qp.cuda(), "cp": cp.cuda(), "cf": cf.cuda()}
    pne = torch.empty(qp.shape[0], cp.shape[0], device="cuda")
    got = cellconv_probes.masked_dist_product(x["qp"], x["cp"], x["cf"], pne)
    plain = cellconv_probes.masked_dist_pne(x["qp"], x["cp"])
    assert torch.equal(pne, plain) and torch.equal(pne.cpu(), cellconv_probes.masked_dist_pne(qp, cp))
    ref = cellconv_probes.masked_dist_product_reference(x["qp"], x["cp"], x["cf"])
    assert float((got - ref).abs().max()) <= probe_cellconv.P3_RTOL * float(ref.abs().max())


@pytest.mark.cuda
def test_gather_kernels_write_nan_for_an_id_outside_the_table():
    _needs_card()
    x = probe_cellconv.draw("p2", 12, "cuda")
    ids = x["ids"].clone()
    ids[3, 2] = probe_cellconv.NB
    ids1 = x["ids"][:, 0].contiguous()
    ids1[5] = -1
    out = cellconv_probes.gather_sum_blocks(ids, x["tab"], probe_cellconv.P).reshape(probe_cellconv.QB, -1)
    out1 = cellconv_probes.gather_blocks(ids1, x["tab"], probe_cellconv.P).reshape(probe_cellconv.QB, -1)
    assert cellconv_probes.bad_ids(ids, probe_cellconv.NB) == 1
    assert bool(out[3].isnan().all()) and bool(out1[5].isnan().all())
    assert bool(torch.isfinite(out[torch.arange(16) != 3]).all())
    assert bool(torch.isfinite(out1[torch.arange(16) != 5]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(mosaic_probes.PROBES))
def test_mosaic_probe_matches_plain(name):
    _needs_card()
    xs = probe_mosaic.draw(name, 13, "cuda")
    fn = mosaic_probes.PROBES[name]
    counter = probes.grid_column_accum if name == "p11_grid_accum" else fn
    before = counter.launches
    got, again = fn(*xs), fn(*xs)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    probe_mosaic.check(name, xs, got)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_probe_clis_pass():
    _needs_card()
    assert bisect_accum.main(["grid16_accum3_dfeat", "grid32_accum0_dfeat"]) == 0
    assert bisect_accum2.main([]) == 0
    assert probe_cellconv.main(["--part", "all"], env={}) == 0
    assert probe_mosaic.main([]) == 0


@pytest.mark.cuda
def test_kernel_attributes_read():
    _needs_card()
    for attrs in (probes.accum_kernel_attributes(), cellconv_probes.cellconv_kernel_attributes(),
                  mosaic_probes.mosaic_kernel_attributes()):
        for a in attrs.values():
            assert 0 < a["registers"] <= 255 and a["local_bytes"] >= 0
