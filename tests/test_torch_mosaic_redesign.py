"""The Hopper designs of the Mosaic probes' batched product
(``kernels/csrc/probe_mosaic.cu``: ``strided_product`` on tensor cores) and
of the revisited-output accumulator (``kernels/csrc/probe_accum.cu``:
``block_total_accum`` in one cooperative pass), held here on the CPU where
their kernels cannot run: the host-side plans they launch from, the
arithmetic they rest on, and the bounds ``chip_smoke.py`` charges them.

- ``mosaic_probes.product_plan`` at every product probe's shapes: the
  output tiles cover ``[batch, M, N]`` once, the depth splits cover K once,
  the cluster's reduction writes each element of a split tile once, the
  cluster and the shared memory fit the card, and the staged slices
  (``stage_slice``'s copies, written out below) fill every slot once,
  copying exactly the terms inside the operand and the depth range and
  zero-filling the rest.
- 3xTF32 (each float32 operand split into two TF32 values by mantissa
  rounding, three products) at p8's and p15's shapes lies within
  ``probe_mosaic.PRODUCT_RTOL`` of max |float64 product|; one TF32 product,
  the control, does not.
- ``probes.accum_plan``: the blocks' shares cover every float4 of ``a``
  once at each ``bisect_accum`` / ``bisect_accum2`` size;
  ``probes.block_total_in_kernel_order`` (the kernel's summation order) is
  the order written out with plain loops, and at grid 64 it lies within
  ``bisect_accum.SUM_RTOL`` of the float64 total.
- ``chip_smoke.probe_bound`` charges the product probes' FLOPs at the
  3xTF32 ceiling (a third of the TF32 peak), p10's at the bf16 peak.
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from se3conv3d_tpu_torch.experiments import bisect_accum, bisect_accum2, probe_mosaic
from se3conv3d_tpu_torch.kernels import mosaic_probes as mp, probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTS = list(mp.PRODUCT_OPERANDS)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_mosaic_redesign", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def operands(name):
    xs = [torch.empty(shape, dtype=dt, device="meta") for shape, dt in mp.SHAPES[name]]
    return mp.PRODUCT_OPERANDS[name](*xs)


# --- the product plan ----------------------------------------------------------

def staged_slice(kc, rows, vs, r0, extent, k0, ke):
    """``stage_slice``'s copies of one slice, written out: ``(filled,
    copied)``, each ``[rows, 32]``, how often each slot is written and
    whether it holds a copied term (else a zero).  Raises where one copy
    would straddle an edge (part inside, part past it)."""
    w, inner_log = 1 << vs, 5 if kc else int(math.log2(rows))
    ls = inner_log - vs
    filled = np.zeros((rows, mp.PRODUCT_SLICE), int)
    copied = np.zeros((rows, mp.PRODUCT_SLICE), bool)
    for c in range(rows * mp.PRODUCT_SLICE >> vs):
        line, off = c >> ls, (c & ((1 << ls) - 1)) << vs
        r, k = (line, off) if kc else (off, line)
        slots = [(r, k + u) if kc else (r + u, k) for u in range(w)]
        inside = [r0 + sr < extent and k0 + sk < ke for sr, sk in slots]
        if len(set(inside)) != 1:
            raise AssertionError(f"a copy of {w} values straddles an edge at ({r0 + r}, {k0 + k})")
        for sr, sk in slots:
            filled[sr, sk] += 1
            copied[sr, sk] = inside[0]
    return filled, copied


def group_ranges(plan, k, split):
    """The depth ranges of split ``split``'s groups, as the kernel cuts
    them: the block's slices in contiguous shares of ceil(slices / groups)."""
    kb_block = split * plan["k_per_split"]
    ke = min(k, kb_block + plan["k_per_split"])
    slices = -(-(ke - kb_block) // mp.PRODUCT_SLICE)
    per_group = -(-slices // plan["groups"])
    ranges = []
    for g in range(plan["groups"]):
        kb = kb_block + g * per_group * mp.PRODUCT_SLICE
        nk = max(0, min(slices - g * per_group, per_group))
        ranges.append((kb, min(ke, kb + nk * mp.PRODUCT_SLICE)) if nk else (kb, kb))
    return ranges


@pytest.mark.parametrize("name", PRODUCTS)
def test_product_plan_covers_the_output_once(name):
    a, b = operands(name)
    batch, m, k = a.shape
    n = b.shape[2]
    plan = mp.product_plans()[name]
    bm, bn, splits = plan["bm"], plan["bn"], plan["splits"]
    assert (bm, bn) == mp.PRODUCT_TILES[plan["tile"]]
    assert plan["grid"] == (splits, plan["m_tiles"] * plan["n_tiles"], batch)
    cover = np.zeros((m, n), int)
    for t in range(plan["m_tiles"] * plan["n_tiles"]):
        i0, j0 = (t // plan["n_tiles"]) * bm, (t % plan["n_tiles"]) * bn
        cover[i0:i0 + bm, j0:j0 + bn] += 1
    assert (cover == 1).all()
    # a split tile: rank r of the cluster writes elements r*bt + t + splits*bt*n (bt threads a block)
    bt = 128 * plan["groups"]
    written = np.zeros(bm * bn, int)
    for rank in range(splits):
        for e0 in range(rank * bt, bm * bn, splits * bt):
            written[e0:e0 + bt] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("name", PRODUCTS)
def test_product_plan_splits_the_depth_once_and_fits_the_card(name):
    a, b = operands(name)
    k = a.shape[2]
    plan = mp.product_plans()[name]
    splits, per = plan["splits"], plan["k_per_split"]
    assert 1 <= splits <= mp.PRODUCT_MAX_CLUSTER == 8
    assert per % mp.PRODUCT_SLICE == 0
    groups = plan["groups"]
    assert 1 <= groups <= mp.PRODUCT_TILE_GROUPS[plan["tile"]]
    terms = np.zeros(k, int)
    for s in range(splits):
        for kb, ke in group_ranges(plan, k, s):
            terms[kb:ke] += 1
    assert (terms == 1).all() and (splits - 1) * per < k
    assert plan["smem"] <= mp.SMEM_MAX == 232448
    assert plan["stages"] in (2, 3)
    esize = a.element_size()
    padk = 16 // esize
    staged = groups * plan["stages"] * esize * (
        (plan["bm"] * (32 + padk) if plan["a_kc"] else 32 * (plan["bm"] + 8))
        + (plan["bn"] * (32 + padk) if plan["b_kc"] else 32 * (plan["bn"] + 8)))
    tiles = groups * plan["bm"] * plan["bn"] * 4
    assert plan["smem"] == (max(staged, tiles) if splits > 1 or groups > 1 else staged)


def test_long_depths_split_over_a_cluster_and_p8_takes_larger_tiles():
    plans = mp.product_plans()
    assert {n for n, p in plans.items() if p["splits"] > 1} == {"p3_multi_contract", "p15_dim0_contract"}
    # ... on narrower tiles: p3 32 x 32 (8 tiles), p15 32 x 16 (4 tiles)
    assert (plans["p3_multi_contract"]["bm"], plans["p3_multi_contract"]["bn"]) == (32, 32)
    assert (plans["p15_dim0_contract"]["bm"], plans["p15_dim0_contract"]["bn"]) == (32, 16)
    assert plans["p3_multi_contract"]["grid"] == (8, 8, 1) and plans["p15_dim0_contract"]["grid"] == (8, 4, 1)
    # each of their blocks shares its slices among 4 groups of warps; the rest take one group
    assert {n: p["groups"] for n, p in plans.items() if p["groups"] > 1} == {"p3_multi_contract": 4,
                                                                            "p15_dim0_contract": 4}
    assert (plans["p8_blockdiag_batched"]["bm"], plans["p8_blockdiag_batched"]["bn"]) == (64, 64)
    # copies of 16 bytes where the strides allow; p1's K = 9 rows by value, p15's 18-wide rows by pairs
    assert plans["p1_plain_2d"]["a_vs"] == 0 and plans["p15_dim0_contract"]["a_vs"] == 1
    assert plans["p8_blockdiag_batched"]["a_vs"] == plans["p8_blockdiag_batched"]["b_vs"] == 2
    assert plans["p10_bf16_batched"]["a_vs"] == plans["p10_bf16_batched"]["b_vs"] == 3
    # the layouts: A rows contiguous in p2 / p4 / p10 / p15, B depth contiguous in p13
    assert [n for n, p in plans.items() if not p["a_kc"]] == ["p2_leading_batch", "p4_free_dims_rhs",
                                                              "p10_bf16_batched", "p15_dim0_contract"]
    assert [n for n, p in plans.items() if p["b_kc"]] == ["p13_nt_contract"]


@pytest.mark.parametrize("name", PRODUCTS)
def test_staged_slices_copy_the_terms_and_zero_fill_the_tails(name):
    """Every slot of every staged slice is written once; it holds a copied
    term where its row lies inside the operand and its depth inside the
    split, and a zero elsewhere (p1's K = 9 of a 32-deep slice, p15's 18
    rows of a 32-row tile); no copy straddles an edge."""
    a, b = operands(name)
    batch, m, k = a.shape
    n = b.shape[2]
    plan = mp.product_plans()[name]
    for kc, rows, vs, extent, tiles in ((plan["a_kc"], plan["bm"], plan["a_vs"], m, plan["m_tiles"]),
                                        (plan["b_kc"], plan["bn"], plan["b_vs"], n, plan["n_tiles"])):
        for t in range(tiles):
            r0 = t * rows
            for s in range(plan["splits"]):
                ke = min(k, (s + 1) * plan["k_per_split"])  # the copies' depth bound: the block's
                for kb, kg in group_ranges(plan, k, s):
                    for k0 in range(kb, kg, mp.PRODUCT_SLICE):
                        filled, copied = staged_slice(kc, rows, vs, r0, extent, k0, ke)
                        rr, kk = np.meshgrid(np.arange(rows), np.arange(mp.PRODUCT_SLICE), indexing="ij")
                        assert (filled == 1).all()
                        assert (copied == ((r0 + rr < extent) & (k0 + kk < min(ke, kg)))).all()


def test_copy_widths_follow_strides_and_alignment():
    # a [2, 6, 10] row-major: K = 10 takes pairs, not 16-byte copies
    plan = mp.product_plan(2, 6, 8, 10, torch.float32, (60, 10, 1), (80, 8, 1))
    assert plan["a_kc"] and plan["a_vs"] == 1 and not plan["b_kc"] and plan["b_vs"] == 2
    # a base aligned to 4 bytes only copies one value at a time
    assert mp.product_plan(2, 6, 8, 12, torch.float32, (72, 12, 1), (96, 8, 1), a_align=4)["a_vs"] == 0
    # neither stride 1: depth-contiguous slices, copied value by value
    plan = mp.product_plan(1, 4, 8, 8, torch.float32, (64, 16, 2), (64, 8, 1))
    assert plan["a_kc"] and plan["a_vs"] == 0
    # the 16-column tile is float32 only: p15's shapes in bfloat16 take 32 x 32
    plan = mp.product_plan(1, 18, 64, 4096, torch.bfloat16, (0, 1, 18), (0, 64, 1))
    assert (plan["bm"], plan["bn"]) == (32, 32) and plan["a_vs"] == 1


# --- 3xTF32 ----------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the kernels' ``to_tf32``, as an integer add and mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    d = lambda x, y: torch.matmul(x.double(), y.double()).float()  # noqa: E731 (the products exact, one rounding)
    return (d(a_lo, b_hi) + d(a_hi, b_lo)) + d(a_hi, b_hi)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0 - 2.0 ** -10])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -3.0 - 2.0 ** -9]


@pytest.mark.parametrize("name", ["p8_blockdiag_batched", "p15_dim0_contract"])
def test_3xtf32_reads_within_the_product_bound(name):
    xs = probe_mosaic.draw(name, 21, "cpu")
    a, b = (x.contiguous() for x in mp.PRODUCT_OPERANDS[name](*xs))
    exact = torch.matmul(a.double(), b.double())
    scale = float(exact.abs().max())
    err3 = float((three_tf32(a, b).double() - exact).abs().max()) / scale
    err1 = float((torch.matmul(tf32(a).double(), tf32(b).double()) - exact).abs().max()) / scale
    assert err3 <= probe_mosaic.PRODUCT_RTOL / 10
    assert err1 > probe_mosaic.PRODUCT_RTOL * 10


# --- the accumulator's plan and order ----------------------------------------------

SIZES = sorted({gn for gn, _, _ in bisect_accum.TRIALS.values()} | {bisect_accum2.GRID})


@pytest.mark.parametrize("grid_n", SIZES)
@pytest.mark.parametrize("blocks", [132, 264, 528])
def test_accum_shares_cover_every_float4_once(grid_n, blocks):
    n = probes.TM * grid_n * bisect_accum.E * bisect_accum.C
    plan = probes.accum_plan(n, blocks)
    shares = plan["shares"]
    assert len(shares) == blocks and plan["per"] % 8 == 0
    assert shares[0][0] == 0 and shares[-1][1] == n // 4
    assert all(s1[1] == s2[0] for s1, s2 in zip(shares, shares[1:]))
    assert all(0 <= e - b <= plan["per"] for b, e in shares)
    assert sum(e - b for b, e in shares) == n // 4
    # every block but the tail's last ones has work: at most one share short of the rest
    assert sum(e - b < plan["per"] for b, e in shares) <= 1 + sum(e == b for b, e in shares)


def test_kernel_order_is_the_order_written_out():
    """:func:`probes.block_total_in_kernel_order` against the same order
    with plain loops: thread runs from zero, the warp tree, warps in order,
    then the partials thread by thread; 3 blocks, one of them short."""
    t = probes.ACCUM_THREADS
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal(4 * (2 * 1032 + 700)).astype(np.float32))
    blocks = 3
    per = probes.accum_plan(a.numel(), blocks)["per"]
    q = a.view(-1, 4)
    n4 = q.shape[0]

    def block_sum(v):
        lanes = [np.float32(x) for x in v]
        warps = []
        for w in range(0, len(lanes), 32):
            lane = lanes[w:w + 32]
            for o in (16, 8, 4, 2, 1):
                lane = [np.float32(lane[i] + lane[i ^ o]) for i in range(32)]
            warps.append(lane[0])
        s = np.float32(0)
        for x in warps:
            s = np.float32(s + x)
        return s

    parts = []
    for blk in range(blocks):
        beg, end = min(n4, blk * per), min(n4, blk * per + per)
        runs = []
        for th in range(t):
            s = np.float32(0)
            for i in range(beg + th, end, t):
                x, y, z, w = (np.float32(v) for v in q[i].tolist())
                s = np.float32(s + np.float32(np.float32(x + y) + np.float32(z + w)))
            runs.append(s)
        parts.append(block_sum(runs))
    runs = [np.float32(0)] * t
    for i, p in enumerate(parts):
        runs[i % t] = np.float32(runs[i % t] + p)
    want = block_sum(runs)
    got = probes.block_total_in_kernel_order(a, blocks)
    assert got.dtype == torch.float32 and float(got) == float(want)


@pytest.mark.parametrize("blocks", [132, 264])
def test_kernel_order_reads_within_the_bound_at_grid_64(blocks):
    a = bisect_accum.draw(64, 33, "cpu")
    total = float(probes.block_total_in_kernel_order(a, blocks))
    exact, terms = float(a.double().sum()), float(a.double().abs().sum())
    assert abs(total - exact) / terms <= bisect_accum.SUM_RTOL / 10


# --- the bounds ----------------------------------------------------------------------

@pytest.mark.parametrize("name", PRODUCTS)
def test_product_bounds_charge_the_tensor_cores(smoke, name):
    xs = probe_mosaic.draw(name, 3, "cpu")
    out = mp.PROBES[name](*xs)
    work = mp.probe_work(name, xs, out)
    a, _ = mp.PRODUCT_OPERANDS[name](*xs)
    flops = 2.0 * out.numel() * a.shape[2]
    assert work == {"product_flops": flops, "bytes": float(sum(x.numel() * x.element_size() for x in xs)
                                                            + 4 * out.numel())}
    bound = smoke.probe_bound(work, xs[0].dtype)
    peak = smoke.PEAK_BF16_FLOPS if xs[0].dtype == torch.bfloat16 else smoke.PEAK_TF32_FLOPS / 3
    t_ops, t_bytes = flops / peak, work["bytes"] / smoke.PEAK_BYTES_PER_S
    assert bound["bound_ms"] == pytest.approx(max(t_ops, t_bytes) * 1e3)
    assert bound["bound_by"] == ("operations" if t_ops >= t_bytes else "bytes")
    # the FMA bound: every product FLOP at the float32 FMA peak (mosaic_fma_bound_ms)
    old = smoke.mosaic_fma_bound_ms(work)
    assert old == pytest.approx(max(flops / smoke.PEAK_F32_FLOPS, t_bytes) * 1e3)
    assert bound["bound_ms"] <= old


def test_p8_is_bound_by_bytes_on_tensor_cores(smoke):
    xs = probe_mosaic.draw("p8_blockdiag_batched", 3, "cpu")
    work = mp.probe_work("p8_blockdiag_batched", xs, mp.PROBES["p8_blockdiag_batched"](*xs))
    bound = smoke.probe_bound(work)
    assert bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(8 * 2 ** 20 / 3.35e12 * 1e3)
