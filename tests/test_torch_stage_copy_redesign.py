"""The Hopper designs of the stage probe's whole-tensor forward
(``kernels/csrc/probe_stage_fwd.cu``: ``stage_fwd``, a block for each
16-row tile and chunk of 16 gq, every product on tensor cores in 3xTF32)
and of the Mosaic probes' strided copy (``kernels/csrc/probe_mosaic.cu``:
``strided_copy`` by the path of its collapsed view), held here on the CPU
where their kernels cannot run: the host-side plans they launch from, the
index arithmetic they rest on, and the bounds ``chip_smoke.py`` charges.

- ``mosaic_probes.copy_plan``: the collapsed view, applied with
  ``torch.as_strided``, reads every probe view (and a size-1, a
  non-mergeable and a five-dimensional one) bit for bit as its
  ``.contiguous()``; p5, p6 and p16 collapse to one run (the flat path),
  p7 and p17 to rows, p12 to a transpose tile.  The kernels' index math is
  written out below: the multiply-high division (``FastDiv``) is exact for
  every dividend below 2^31, and the rows and tile paths map every output
  element to its source once.
- ``probes.stage_tensor_grid`` / ``stage_tensor_writes``: the blocks write
  each element of every stage's output once, at M = 16, 1024 and 1040 and
  B = 1 and 2; the reduce stage's clusters pair the two chunks of one
  out-frame.
- 3xTF32 with the bias folded in as a ones column of geo lies within
  ``bisect_fused.RTOL / 10`` of the float64 s5 output; one TF32 product
  per product, the gate's planted control, lies above ``RTOL``.
- ``chip_smoke.bisect_stage_bounds`` charges the stages' products at the
  3xTF32 ceiling (s5 0.88 GFLOP: bound by operations), with the FMA bound
  of the first design beside it.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from se3conv3d_tpu_torch.experiments import bisect_fused
from se3conv3d_tpu_torch.kernels import mosaic_probes as mp, probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_stage_copy", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _collapsed(x: torch.Tensor, view: torch.Tensor, plan: dict) -> torch.Tensor:
    return torch.as_strided(x, plan["dims"], plan["strides"], view.storage_offset()).reshape(view.shape)


# --- the copy's plan ------------------------------------------------------------------

COPY_PATH = {"p5_lane_merge": "flat", "p6_sublane_split": "flat", "p16_leading_split_rank2": "flat",
             "p7_mid_slice": "rows", "p17_outer_swap": "rows", "p12_transpose_last2": "tile"}


@pytest.mark.parametrize("name", list(mp.COPY_VIEWS))
def test_collapsed_probe_view_reads_its_contiguous_copy(name):
    shape = mp.SHAPES[name][0][0]
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    view = mp.COPY_VIEWS[name](x)
    plan = mp.copy_plan(view.shape, view.stride())
    assert torch.equal(_collapsed(x, view, plan), view.contiguous())
    assert torch.equal(mp.PROBES[name](x), view.contiguous())  # the wrapper on the CPU: the plain version
    assert plan["path"] == COPY_PATH[name] and plan["n"] == view.numel()
    if plan["path"] == "flat":  # one contiguous run: no index math
        assert plan["dims"][:3] == [1, 1, 1] and plan["strides"][3] == 1


@pytest.mark.parametrize("shape, strides, offset, dims, path", [
    ((3, 1, 5), (5, 99, 1), 0, [1, 1, 1, 15], "flat"),              # a size-1 dimension, then a merge
    ((1, 1), (7, 3), 2, [1, 1, 1, 1], "flat"),                      # every dimension size 1
    ((4, 6), (13, 2), 1, [1, 1, 4, 6], "scalar"),                   # no merge, an inner stride of 2
    ((4, 6), (12, 2), 1, [1, 1, 1, 24], "scalar"),                  # one run at a stride of 2
    ((2, 3, 4, 5, 8), (960, 320, 80, 16, 1), 0, [1, 1, 120, 8], "rows"),  # five dimensions, two left
    ((5, 8, 6), (1, 31, 5), 0, [1, 5, 8, 6], "scalar"),             # contiguous axis first: no tile
    ((5, 8, 6), (1, 30, 5), 0, [1, 1, 5, 48], "tile"),              # ... until the last two merge
    ((6, 8, 5), (40, 1, 8), 0, [1, 6, 8, 5], "tile"),               # a transpose of the last two
])
def test_collapse_keeps_other_views(shape, strides, offset, dims, path):
    x = torch.arange(2000, dtype=torch.float32)
    view = torch.as_strided(x, shape, strides, offset)
    plan = mp.copy_plan(view.shape, view.stride())
    assert plan["dims"] == dims and plan["path"] == path
    assert torch.equal(_collapsed(x, view, plan), view.contiguous())


def test_copy_plan_vector_paths_need_an_aligned_base():
    assert mp.copy_plan((128, 32, 64), (2048, 64, 1), align=4)["path"] == "scalar"
    assert mp.copy_plan((4096, 32), (64, 1), align=8)["path"] == "scalar"
    assert mp.copy_plan((128, 32, 64), (2048, 1, 32), align=4)["path"] == "tile"  # scalar loads, any base


def test_copy_plan_refuses_more_than_four_dimensions_left():
    with pytest.raises(ValueError, match="at most 4"):
        mp.copy_plan((2, 2, 2, 2, 2), (64, 16, 4, 1, 2))


# --- the copy kernels' index math, written out ------------------------------------------

def fast_div(d: int):
    """``probe_mosaic.cu``'s ``fast_div``: l = ceil(log2 d), m = 2^32 (2^l -
    d) / d + 1."""
    l = 0
    while (1 << l) < d:
        l += 1
    return ((1 << 32) * ((1 << l) - d)) // d + 1, l


def div_of(n, d):
    """``div_of``: the multiply-high, the add and the shift, on numpy uint64."""
    m, l = fast_div(d)
    n = np.asarray(n, dtype=np.uint64)
    return ((n * np.uint64(m)) >> np.uint64(32)) + n >> np.uint64(l)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 32, 33, 64, 100, 128, 4096, 65535, 1 << 20, 999_999_937, (1 << 31) - 1])
def test_fast_div_is_exact_below_2_31(d):
    rng = np.random.default_rng(d % 1000)
    n = np.concatenate([np.arange(0, 4096), rng.integers(0, 1 << 31, 100_000), (1 << 31) - 1 - np.arange(4096),
                        d * np.arange(1, 64), d * np.arange(1, 64) - 1])
    n = n[(n >= 0) & (n < 1 << 31)].astype(np.uint64)
    m, _ = fast_div(d)
    assert m < 1 << 32
    assert ((n * np.uint64(m) >> np.uint64(32)) + n < 1 << 32).all()  # the 32-bit add does not wrap
    assert (div_of(n, d) == n // np.uint64(d)).all()


def rows_sources(plan):
    """``copy_rows``: float4 i of out -> (i0, i1, i2, i3) by three FastDivs,
    its source's first offset."""
    d0, d1, d2, d3 = plan["dims"]
    s0, s1, s2, _ = plan["strides"]
    i = np.arange(plan["n"] // 4, dtype=np.uint64)
    r = div_of(i, d3 // 4)
    r2 = div_of(r, d2)
    i0 = div_of(r2, d1)
    return (i0 * np.uint64(s0) + (r2 - i0 * np.uint64(d1)) * np.uint64(s1) + (r - r2 * np.uint64(d2)) * np.uint64(s2)
            + np.uint64(4) * (i - r * np.uint64(d3 // 4))).astype(np.int64)


@pytest.mark.parametrize("name", ["p7_mid_slice", "p17_outer_swap"])
def test_rows_path_maps_each_float4_to_its_source(name):
    shape = mp.SHAPES[name][0][0]
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    view = mp.COPY_VIEWS[name](x)
    plan = mp.copy_plan(view.shape, view.stride())
    src = rows_sources(plan) + view.storage_offset()
    flat = x.reshape(-1).numpy()
    got = np.stack([flat[src + k] for k in range(4)], 1).reshape(-1)
    assert np.array_equal(got, view.contiguous().reshape(-1).numpy())


def tile_writes(plan):
    """``copy_tile``'s blocks of 32 x 8 threads, 4 rows each, written out:
    (out offsets, source offsets) of every store, in block order."""
    d0, d1, a_n, b_n = plan["dims"]
    s0, s1, _, s_b = plan["strides"]
    ta, tb = -(-a_n // 32), -(-b_n // 32)
    outs, srcs = [], []
    tx, ty = np.meshgrid(np.arange(32), np.arange(8), indexing="xy")
    for blk in range(d0 * d1 * ta * tb):
        batch, t = int(div_of(blk, ta * tb)), blk - int(div_of(blk, ta * tb)) * ta * tb
        a_t = int(div_of(t, tb))
        i0 = int(div_of(batch, d1))
        a0, b0 = 32 * a_t, 32 * (t - a_t * tb)
        for k in range(4):  # the stores: row a = a0 + ty + 8k, column b = b0 + tx
            a, b = a0 + ty + 8 * k, b0 + tx
            keep = (a < a_n) & (b < b_n)
            outs.append((batch * a_n * b_n + a * b_n + b)[keep])
            srcs.append((i0 * s0 + (batch - i0 * d1) * s1 + a + b * s_b)[keep])
    return np.concatenate(outs), np.concatenate(srcs)


@pytest.mark.parametrize("shape, strides", [((128, 64, 32), None), ((3, 40, 70), None)])
def test_tile_path_writes_each_element_once_from_its_source(shape, strides):
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    view = x.transpose(1, 2)
    plan = mp.copy_plan(view.shape, view.stride())
    assert plan["path"] == "tile"
    outs, srcs = tile_writes(plan)
    assert np.array_equal(np.sort(outs), np.arange(view.numel()))
    got = np.empty(view.numel(), dtype=np.float32)
    got[outs] = x.reshape(-1).numpy()[srcs]
    assert np.array_equal(got, view.contiguous().reshape(-1).numpy())


# --- the stage grid -------------------------------------------------------------------

@pytest.mark.parametrize("stage", list(probes.STAGES))
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("m", [16, 1024, 1040])
def test_stage_blocks_write_every_output_element_once(stage, b, m):
    grid = probes.stage_tensor_grid(stage, b, m)
    assert grid["grid"] == (4 * m // 16, b) and grid["blocks"] == 4 * m // 16 * b and grid["threads"] == 256
    count = torch.zeros(probes._stage_out_shape(stage, b, m, bisect_fused.GD), dtype=torch.uint8)
    for y in range(b):
        for x in range(grid["grid"][0]):
            count[probes.stage_tensor_writes(stage, x, y, m)] += 1
    assert bool((count == 1).all())


def test_reduce_clusters_pair_the_two_chunks_of_an_out_frame():
    grid = probes.stage_tensor_grid("reduce", 1, 1024)
    assert grid["cluster"] == 2 and grid["grid"][0] % 2 == 0
    assert all(probes.stage_tensor_grid(s, 1, 1024)["cluster"] == 1 for s in probes.STAGES if s != "reduce")
    for x in range(0, grid["grid"][0], 2):
        w0, w1 = (probes.stage_tensor_writes("reduce", x + r, 0, 1024) for r in (0, 1))
        assert w0[1] == w1[1]  # one out-frame
        assert w0[2].stop == w1[2].start and w1[2].stop - w0[2].start == probes.STAGE_ROWS  # one tile, halves


def test_bisect_grid_fills_the_card():
    grid = probes.stage_tensor_grid("reduce", 1, bisect_fused.MP)
    assert grid["blocks"] == 256  # at least 128 blocks, two resident an SM on the card


# --- 3xTF32 on s5, the bias a ones column ------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as the kernels' ``to_tf32``: an integer add and mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, terms):
    """``a @ b`` in float32 from TF32 operands: 3xTF32 (lo.hi + hi.lo +
    hi.hi) or one TF32 product; each product exact in float64, one rounding."""
    d = lambda x, y: torch.matmul(x.double(), y.double()).float()  # noqa: E731
    a_hi, b_hi = tf32(a), tf32(b)
    if terms == 1:
        return d(a_hi, b_hi)
    return (d(tf32(a - a_hi), b_hi) + d(a_hi, tf32(b - b_hi))) + d(a_hi, b_hi)


def s5_emulated(geo, feat, proj, bias, w2, terms):
    m, e = feat.shape[0], feat.shape[1]
    d = geo.shape[1]
    geo1 = torch.cat([geo, torch.ones(geo.shape[0], 1), torch.zeros(geo.shape[0], 24 - d - 1)], 1)
    proj1 = torch.cat([proj, bias.reshape(1, -1), torch.zeros(24 - d - 1, proj.shape[1])], 0)
    pne = F.gelu(product(geo1, proj1, terms), approximate="tanh").reshape(m, e, -1)
    basis = product(pne.transpose(1, 2), feat, terms)                     # [M, GQ, C]
    per_gq = product(basis.permute(1, 0, 2), w2, terms)                    # [GQ, M, O]
    return per_gq.reshape(bisect_fused.G, bisect_fused.Q, m, -1).sum(1)   # [G, M, O]


def s5_float64(geo, feat, proj, bias, w2):
    m, e = feat.shape[0], feat.shape[1]
    pne = F.gelu(geo.double() @ proj.double() + bias.double().reshape(-1), approximate="tanh").reshape(m, e, -1)
    basis = torch.einsum("meq,mec->qmc", pne, feat.double())
    return torch.matmul(basis, w2.double()).reshape(bisect_fused.G, bisect_fused.Q, m, -1).sum(1)


def test_3xtf32_with_the_bias_column_reads_within_the_stage_bound():
    geo, feat, proj, bias, w2 = bisect_fused.make_inputs(23, "cpu", mp=64)
    exact = s5_float64(geo, feat, proj, bias, w2)
    scale = float(exact.abs().max())
    err3 = float((s5_emulated(geo, feat, proj, bias, w2, 3).double() - exact).abs().max()) / scale
    err1 = float((s5_emulated(geo, feat, proj, bias, w2, 1).double() - exact).abs().max()) / scale
    assert err3 <= bisect_fused.RTOL / 10
    assert err1 > bisect_fused.RTOL


# --- the bounds ---------------------------------------------------------------------

def test_stage_bounds_read_the_3xtf32_ceiling(smoke):
    mp_, gd = bisect_fused.MP, bisect_fused.GD
    s5 = smoke.bisect_stage_bounds("reduce", mp_, gd, bisect_fused.G * mp_ * bisect_fused.O)
    work = probes.stage_work("reduce", mp_, gd)
    flops = work["fma_flops"] + work["product_flops"]
    assert flops / 1e9 == pytest.approx(0.8808, abs=1e-3)
    assert s5["bound_by"] == "operations"
    assert s5["bound_ms"] == pytest.approx(flops / (smoke.PEAK_TF32_FLOPS / 3) * 1e3, rel=1e-12)
    assert s5["bound_ms"] == pytest.approx(0.0053, abs=1e-4)
    assert s5["bound_fma_ms"] > s5["bound_ms"]
    s1 = smoke.bisect_stage_bounds("pne", mp_, gd, mp_ * bisect_fused.E * bisect_fused.GQ)
    assert s1["bound_by"] == "bytes" and s1["bound_ms"] == pytest.approx(0.0032, abs=1e-4)
    for stage, rows in (("agg", mp_ * bisect_fused.GQ * bisect_fused.C), ("wcontract", bisect_fused.GQ * mp_ * 64)):
        b = smoke.bisect_stage_bounds(stage, mp_, gd, rows)
        assert b["bound_by"] == "bytes" and b["bound_ms"] <= b["bound_fma_ms"]


def test_every_bisect_probe_has_a_library_call_or_a_reason(smoke):
    named = set(smoke.BISECT_NO_LIBRARY) | set(smoke.BISECT_PRODUCT_ALONE) | {"b2_gexp", "b3_dw2_contract11",
                                                                              "b5_merge_back"}
    assert named == set(bisect_fused.STAGES)
    assert not set(smoke.BISECT_NO_LIBRARY) & set(smoke.BISECT_PRODUCT_ALONE)
