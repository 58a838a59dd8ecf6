"""The Hopper designs of the cell-conv probe's masked distance product
(``kernels/csrc/probe_cellconv.cu``: ``masked_dist_product`` on tensor
cores in 3xTF32) and of p11's column accumulator
(``kernels/csrc/probe_accum.cu``: ``grid_column_accum`` in one launch),
held here on the CPU where their kernels cannot run: the arithmetic and
the order they rest on, the shapes they take and the bounds
``chip_smoke.py`` charges them.

- 3xTF32 (each float32 operand split into two TF32 values by mantissa
  rounding, the three products lo.hi, hi.lo and hi.hi each summed on its
  own and added as (lo.hi + hi.lo) + hi.hi, the kernel's four depth groups'
  partial tiles then added in group order) on p3's operands at the
  script's size lies within ``probe_cellconv.P3_RTOL / 10`` of the float64
  product, relative to its largest value; one TF32 product, the control,
  reads above ``P3_RTOL * 10``.
- ``probes.grid_column_in_kernel_order`` (the kernel's summation order
  written out in PyTorch) is a numpy float32 loop in that order bit for
  bit, at p11's shape and at others the kernel takes.
- The kernel's tile (64 queries x 32 channels, slices of 32 candidates)
  divides the script's shapes into 128 blocks, and ``chip_smoke`` charges
  p3's product as ``product_flops``: its bound is the 3xTF32 ceiling's,
  the float32 FMA bound beside it.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from se3conv3d_tpu_torch.experiments import probe_cellconv as pc, probe_mosaic
from se3conv3d_tpu_torch.kernels import cellconv_probes as cc, mosaic_probes as mp, probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P3_GROUPS = 4  # the kernel's depth groups: group g takes slices g, g + 4, ... of 32 candidates


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_cellconv_redesign", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernels' ``to_tf32``, as an integer add and mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def group_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's 3xTF32 product of ``a [M, K] @ b [K, N]``: per depth
    group, the three products each exact and rounded once, added as
    (lo.hi + hi.lo) + hi.hi in float32, then the groups' tiles in group
    order."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    slices = torch.arange(a.shape[1]) // cc.P3_SLICE
    out = None
    for g in range(P3_GROUPS):
        k = slices % P3_GROUPS == g
        d = lambda x, y: torch.matmul(x[:, k].double(), y[k].double()).float()  # noqa: E731
        part = (d(a_lo, b_hi) + d(a_hi, b_lo)) + d(a_hi, b_hi)
        out = part if out is None else out + part
    return out


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0 - 2.0 ** -10])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -3.0 - 2.0 ** -9]


@pytest.mark.parametrize("seed", [460 + 2, 21])
def test_3xtf32_reads_within_p3s_bound_and_one_tf32_does_not(seed):
    """At the script's size (2,048 queries, 512 candidates, 128 channels;
    seed 462 is ``chip_smoke``'s p3 draw): the kernel's arithmetic within a
    tenth of ``P3_RTOL``, a single TF32 product more than ten times over
    it, so the gate tells them apart."""
    x = pc.draw("p3", seed, "cpu")
    a, b = cc.masked_dist_pne(x["qp"], x["cp"]), x["cf"]
    assert tuple(a.shape) == (pc.QB3 * pc.Q3, pc.CAND) and int((a != 0).sum()) > 0
    exact = torch.matmul(a.double(), b.double())
    scale = float(exact.abs().max())
    err3 = float((group_products(a, b).double() - exact).abs().max()) / scale
    err1 = float((torch.matmul(tf32(a).double(), tf32(b).double()) - exact).abs().max()) / scale
    assert err3 <= pc.P3_RTOL / 10
    assert err1 > pc.P3_RTOL * 10


def test_p3_kernel_tiles_divide_the_script_into_128_blocks():
    nq, nc, c = pc.QB3 * pc.Q3, pc.CAND, pc.C
    assert nq % cc.P3_TILE_Q == nc % cc.P3_SLICE == c % cc.P3_TILE_C == 0
    assert (nq // cc.P3_TILE_Q) * (c // cc.P3_TILE_C) == 128
    # each group of warps takes every 4th slice: the script's 16 slices, 4 a group
    per_group = [len(range(g, nc // cc.P3_SLICE, P3_GROUPS)) for g in range(P3_GROUPS)]
    assert per_group == [4, 4, 4, 4]
    # a block reads its 32 columns of cf once: 64 KB, 8 MB over the grid
    assert nc * cc.P3_TILE_C * 4 == 64 * 1024


def test_p3_plain_path_takes_any_shape_on_the_cpu():
    """The kernel's shape rules bind only on the card: the CPU path is the
    plain version at any shape, and fills ``pne_out``."""
    g = torch.Generator().manual_seed(4)
    qp, cp, cf = torch.rand(10, 3, generator=g), torch.rand(7, 3, generator=g), torch.randn(7, 5, generator=g)
    pne = torch.empty(10, 7)
    got = cc.masked_dist_product(qp, cp, cf, pne)
    assert torch.equal(pne, cc.masked_dist_pne(qp, cp))
    assert torch.equal(got, cc.masked_dist_product_reference(qp, cp, cf))


def column_order_numpy(a: np.ndarray, tm: int) -> np.ndarray:
    """The kernel's order with plain float32 loops: each block of ``tm``
    rows summed column by column in row order from zero, then the block sums
    in block order from zero."""
    s_blocks, c = a.shape[0] // tm, a.shape[1]
    total = np.zeros(c, np.float32)
    for s in range(s_blocks):
        run = np.zeros(c, np.float32)
        for r in range(tm):
            run = (run + a[s * tm + r]).astype(np.float32)
        total = (total + run).astype(np.float32)
    return total[None]


@pytest.mark.parametrize("shape", [(8, 32), (3, 40), (5, 7)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_column_kernel_order_is_the_order_written_out(shape):
    s, c = shape
    a = np.random.default_rng(s * 100 + c).standard_normal((s * probes.TM, c)).astype(np.float32)
    got = probes.grid_column_in_kernel_order(torch.from_numpy(a))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, c)
    assert np.array_equal(got.numpy(), column_order_numpy(a, probes.TM))


def test_column_kernel_order_reads_within_p11s_bound():
    """At p11's ``[1024, 32]``: within ``1e-6`` of each column's ``sum |a|``
    of the float64 sum (``probe_mosaic.check``'s bound), as the kernel must."""
    (a,) = probe_mosaic.draw("p11_grid_accum", 440, "cpu")
    got = probes.grid_column_in_kernel_order(a)
    assert probe_mosaic.check("p11_grid_accum", [a], got) <= 1e-7


def test_column_block_sums_fit_shared_memory_at_p11():
    shape = mp.SHAPES["p11_grid_accum"][0][0]
    assert probes.column_partials_bytes(shape) == 8 * 32 * 4
    assert probes.COLUMN_PARTIALS_MAX_BYTES == 232448
    assert probes.ACCUM_KERNELS == ("block_total_accum<dfeat>", "block_total_accum", "grid_column_accum")


def test_p3_bound_charges_the_tensor_cores(smoke):
    """``chip_smoke.cellconv_work``'s p3: 268 MFLOP as ``product_flops``,
    bound at the 3xTF32 ceiling (about 0.0016 ms, operations), with the
    float32 FMA bound (about 0.0040 ms) beside it; 1.39 MB of bytes."""
    x = pc.draw("p3", 462, "cpu")
    work = smoke.cellconv_work("p3", x)
    flops = 2.0 * pc.QB3 * pc.Q3 * pc.CAND * pc.C
    nbytes = 4.0 * (pc.QB3 * pc.Q3 * 8 + pc.CAND * 8 + pc.CAND * pc.C + pc.QB3 * pc.Q3 * pc.C)
    assert work == {"product_flops": flops, "bytes": nbytes}
    bound = smoke.probe_bound(work)
    assert bound["bound_by"] == "operations"
    assert bound["bound_ms"] == pytest.approx(flops / (smoke.PEAK_TF32_FLOPS / 3) * 1e3)
    assert bound["bound_ms"] == pytest.approx(0.0016, abs=1e-4)
    assert smoke.mosaic_fma_bound_ms(work) == pytest.approx(flops / smoke.PEAK_F32_FLOPS * 1e3)
    assert smoke.mosaic_fma_bound_ms(work) == pytest.approx(0.0040, abs=1e-4)
    assert nbytes / smoke.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.0004, abs=1e-4)


@pytest.mark.parametrize("part", ["p1", "p2", "p4"])
def test_gather_bounds_count_the_named_blocks(smoke, part):
    x = pc.draw(part, 3, "cpu")
    blocks = int(torch.unique(x["ids"]).numel())
    work = smoke.cellconv_work(part, x)
    assert work == {"bytes": 4.0 * (x["ids"].numel() + (blocks + x["ids"].shape[0]) * pc.P * pc.C)}
    assert smoke.probe_bound(work)["bound_by"] == "bytes"


@pytest.mark.parametrize("kernel", ["p3", "p11"])
def test_probe_variants_apply_to_the_sources(kernel):
    """``probe_variants.py``'s variants are line edits of the kernel's source
    as it stands: each edit finds its line, and each variant differs from
    the source but the first, which is the source itself."""
    spec = importlib.util.spec_from_file_location("probe_variants_test", os.path.join(REPO, "probe_variants.py"))
    pv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pv)
    source, _, _, variants = pv.KERNELS[kernel]
    base = open(os.path.join(REPO, "se3conv3d_tpu_torch", "kernels", "csrc", source)).read()
    texts = [pv.variant_source(base, edits) for edits, _ in variants.values()]
    assert texts[0] == base and all(t != base for t in texts[1:])
    assert len(set(texts)) == len(texts)
