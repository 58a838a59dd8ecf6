"""The Hopper designs of the bisect probe's revisited-output accumulator
(b4, ``kernels/csrc/probe_bwd_ops.cu``: ``colsum_broadcast``, one launch)
and of the cell-conv block gathers (p1, p2, p4,
``kernels/csrc/probe_cellconv.cu``: ``block_gather``, one kernel for the
three).

On the CPU, where the kernels cannot run: the launch plans cover every
output element once (``probes.rank3_accum_plan`` / ``rank3_accum_writes``,
``cellconv_probes.gather_plan`` / ``gather_writes``), b4's staging
arithmetic (pieces of a row block that fit a ring slot, strides that put a
warp's four row blocks on 32 banks) holds at every wave width,
``probes.rank3_in_kernel_order`` is the numpy row-order loop bit for bit,
the bounds ``chip_smoke.py`` charges stay the byte bounds, and
``probe_variants.py``'s ``b4`` and ``gather`` edits apply to the sources.

On the card (``cuda`` marker; skipped elsewhere; the file imports torch
only: ``python -m pytest --noconftest -q
tests/test_torch_accum_gather_redesign.py``): b4 bit for bit the float32
row-order, block-order sum built in numpy on the CPU copy of ``a`` (C not a
multiple of 8 or 4, O not a multiple of 4, GQ = 1, S = 1, more row blocks
than a wave, row blocks longer than a slot, an ``a`` off 16 bytes), every
``(gq, o)`` of a column the same bits, two calls the same bits, one kernel
node a call in a CUDA graph and one allocation (the output), its refusals
in the wrapper and the C entry; the gathers bit for bit their plain
versions at R = 1..8 and 20 and at blocks that are not a multiple of a slice,
-0.0 kept by p1's scaling, an id outside the table a NaN block that leaves
the other blocks' bits alone, one kernel node a call, and their refusals.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from se3conv3d_tpu_torch.experiments import bisect_fused as bf, probe_cellconv as pc
from se3conv3d_tpu_torch.kernels import cellconv_probes as cc, probes
from test_torch_mosaic_probes_cuda import _graph_node_types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# colsum_broadcast's constants (csrc/probe_bwd_ops.cu): columns a block,
# row blocks a block sums at once, a ring slot's floats
COL_GROUP, COL_WAVE = 8, 32
COL_SLOT = 4096 + COL_WAVE * COL_GROUP


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke_accum_gather", "chip_smoke.py")


# --- the launch plans -----------------------------------------------------------------

def test_rank3_plan_at_the_bisect_shape():
    plan = probes.rank3_accum_plan(bf.C, bf.GQ)
    assert plan == {"groups": 8, "slab": 8, "slabs": 8, "grid": (8, 8), "blocks": 64}


@pytest.mark.parametrize("c, gq", [(64, 64), (1, 1), (5, 3), (13, 64), (20, 7), (67, 1000), (8, 300000), (3000, 2)])
def test_rank3_plan_writes_every_output_row_once(c, gq):
    plan = probes.rank3_accum_plan(c, gq)
    assert plan["grid"][1] <= 65535 and plan["slab"] >= 1
    assert plan["groups"] * plan["slabs"] <= probes.RANK3_TARGET_BLOCKS + plan["groups"]
    hits = np.zeros((gq, c), np.int8)
    for x in range(plan["grid"][0]):
        for y in range(plan["grid"][1]):
            for rows, cols in probes.rank3_accum_writes(plan, x, y, c, gq):
                hits[rows, cols] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("nq, block", [(16, 32 * 128), (64, 32 * 128), (3, 60), (5, 5 * 132), (2, 4), (1, 4 * 129)])
def test_gather_plan_writes_every_output_float4_once(nq, block):
    plan = cc.gather_plan(nq, block)
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= cc.GATHER_THREADS
    hits = np.zeros(nq * block // 4, np.int32)
    for x in range(plan["grid"][0]):
        for y in range(plan["grid"][1]):
            np.add.at(hits, cc.gather_writes(plan, x, y, block), 1)
    assert (hits == 1).all()


def test_gather_plan_spreads_the_script_parts_over_the_card():
    """p1 and p2 (16 output blocks of 32 x 128) take 128 blocks, p4 (64)
    512: at least the 32 and 128 the design asks for."""
    assert cc.gather_plan(pc.QB, pc.P * pc.C)["blocks"] == 128
    assert cc.gather_plan(pc.NB, pc.P * pc.C)["blocks"] == 512


# --- colsum_broadcast's staging, written out ---------------------------------------------

def _staging(n: int, rows: int) -> tuple:
    """The kernel's pieces for a wave of ``n`` row blocks of ``rows`` rows:
    (fit, pieces, sub, stride), integer for integer."""
    fit = 4 * ((COL_SLOT // n - COL_GROUP) // 32)
    pieces = -(-rows // fit)
    sub = -(-rows // pieces)
    return fit, pieces, sub, 32 * -(-sub // 4) + COL_GROUP


@pytest.mark.parametrize("n", [1, 2, 7, 8, 31, 32])
def test_colsum_staging_fits_a_slot_and_covers_every_row(n):
    for rows in (1, 3, 16, 64, 127, 128, 129, 300, 1000):
        fit, pieces, sub, stride = _staging(n, rows)
        assert fit >= 16 and sub <= fit
        assert n * stride <= COL_SLOT  # a piece of every row block fits its slot
        assert (pieces - 1) * sub < rows <= pieces * sub  # the pieces cover the rows, none empty
        assert stride % 4 == 0 and stride % 32 == COL_GROUP  # 16-byte copies; a warp's 4 row blocks on 32 banks
        banks = {(k * stride + c) % 32 for k in range(4) for c in range(COL_GROUP)}
        assert len(banks) == 32


def test_colsum_stages_the_bisect_strip_in_two_pieces_at_once():
    """MP / TM = 8 row blocks of 128 rows: two pieces of 64 rows, one a
    ring slot, both in flight before the first add (the whole 32 KB)."""
    assert _staging(bf.MP // bf.TM, bf.TM) == (64, 2, 64, 520)


# --- the bounds chip_smoke.py charges -------------------------------------------------------

def test_b4_bound_stays_the_byte_bound(smoke):
    """a [1024, 64] read once and out [64, 64, 64] written once: 1.25 MiB,
    0.0004 ms at 3.35 TB/s."""
    nbytes = 4.0 * (bf.MP * bf.C + bf.GQ * bf.C * bf.O)
    bound = smoke.probe_bound({"bytes": nbytes})
    assert bound["bound_by"] == "bytes" and bound["bound_ms"] == pytest.approx(0.0004, abs=5e-5)


def test_b4_yardstick_is_the_plain_broadcast_of_the_column_sums(smoke):
    (a,) = bf.draw("b4_rank3_accum", 5, "cpu")
    got = smoke.BISECT_YARDSTICK["b4_rank3_accum"](a, bf.GQ, bf.C, bf.O)
    assert got.shape == (bf.GQ, bf.C, bf.O) and got.is_contiguous()
    bf.check(got, bf.REFERENCES["b4_rank3_accum"](a))


@pytest.mark.parametrize("part, bound", [("p1", 0.0001), ("p2", 0.0003), ("p4", 0.0004)])
def test_gather_bounds_stay_the_byte_bounds(smoke, part, bound):
    b = smoke.probe_bound(smoke.cellconv_work(part, pc.draw(part, 3, "cpu")))
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(bound, abs=5e-5)


@pytest.mark.parametrize("kernel", ["b4", "gather"])
def test_probe_variants_apply_to_the_sources(kernel):
    pv = _load("probe_variants_accum_gather", "probe_variants.py")
    source, _, _, variants = pv.KERNELS[kernel]
    base = open(os.path.join(REPO, "se3conv3d_tpu_torch", "kernels", "csrc", source)).read()
    texts = [pv.variant_source(base, edits) for edits, _ in variants.values()]
    assert texts[0] == base and all(t != base for t in texts[1:])
    assert len(set(texts)) == len(texts)


def _row_order_sums(a: torch.Tensor, rows: int) -> np.ndarray:
    """``[C]`` float32 in numpy on the CPU copy of ``a``: each block of
    ``rows`` rows summed in row order from zero (a loop over rows,
    vectorised over columns), the block sums added in block order from
    zero."""
    x = a.cpu().numpy()
    total = np.zeros(x.shape[1], np.float32)
    for blk in x.reshape(-1, rows, x.shape[1]):
        s = np.zeros(x.shape[1], np.float32)
        for row in blk:
            s = s + row
        total = total + s
    return total


@pytest.mark.parametrize("s, rows, c", [(8, 128, 64), (3, 7, 13), (1, 5, 1)])
def test_rank3_kernel_order_is_the_numpy_row_order_loop(s, rows, c):
    """``probes.rank3_in_kernel_order`` (the kernel's order in PyTorch, which
    ``probe_variants.py b4`` holds the variants to) is the numpy loop the
    card test holds the kernel to, bit for bit, and within ``bisect_fused``'s
    bound of the plain version."""
    a = torch.from_numpy(np.random.default_rng(s + rows + c).standard_normal((s * rows, c)).astype(np.float32))
    got = probes.rank3_in_kernel_order(a, rows)
    assert torch.equal(got.view(torch.int32), torch.from_numpy(_row_order_sums(a, rows)).view(torch.int32))
    bf.check(got[None, :, None], probes.rank3_accum_reference(a, 1, 1, rows))


def test_wrappers_refuse_a_row_count_below_one_on_the_cpu():
    with pytest.raises(ValueError, match="must be"):
        probes.rank3_accum(torch.zeros(4, 3), 2, 2, 0)


# --- on the card ------------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the probe kernels are CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("s, rows, c, gq, o, offset", [
    (8, 128, 64, 64, 64, 0),   # the bisect shape
    (8, 128, 13, 5, 64, 0),    # C not a multiple of 4 (4-byte copies, a group of 5)
    (3, 40, 20, 64, 64, 0),    # C a multiple of 4, not 8 (a group of 4)
    (8, 128, 64, 3, 5, 0),     # O not a multiple of 4 (scalar stores)
    (8, 128, 64, 1, 64, 0),    # GQ = 1
    (1, 1024, 64, 64, 64, 0),  # S = 1: one row block, longer than a slot
    (40, 32, 16, 9, 12, 0),    # more row blocks than a wave
    (2, 700, 9, 2, 7, 0),      # pieces of a row block in turns
    (300, 4, 8, 9, 4, 0),      # ten waves of 32 row blocks
    (3, 64, 16, 40, 8, 0),     # slabs of 10 gq
    (8, 128, 64, 64, 64, 1),   # a off 16 bytes: 4-byte copies
])
def test_rank3_accum_is_the_row_order_block_order_sum(s, rows, c, gq, o, offset):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(s * rows + c)
    base = torch.randn(s * rows * c + offset, device="cuda", generator=gen)
    a = base[offset:].view(s * rows, c)
    got, again = probes.rank3_accum(a, gq, o, rows), probes.rank3_accum(a, gq, o, rows)
    torch.cuda.synchronize()
    want = torch.from_numpy(_row_order_sums(a, rows))
    assert got.shape == (gq, c, o)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.cpu()[0, :, 0].view(torch.int32), want.view(torch.int32))
    # every (gq, o) of a column holds its column's bits
    assert torch.equal(got.view(torch.int32), got[:1, :, :1].expand(gq, c, o).contiguous().view(torch.int32))
    bf.check(got, probes.rank3_accum_reference(a, gq, o, rows))


@pytest.mark.cuda
def test_rank3_accum_is_one_launch_with_no_scratch():
    _needs_card()
    (a,) = bf.draw("b4_rank3_accum", 6, "cuda")
    before = probes.rank3_accum.launches
    assert _graph_node_types(lambda: probes.rank3_accum(a, bf.GQ, bf.O, bf.TM)) == [0]
    assert probes.rank3_accum.launches == before + 2  # the warm-up and the captured call
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = probes.rank3_accum(a, bf.GQ, bf.O, bf.TM)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1  # the output alone
    del out


@pytest.mark.cuda
def test_rank3_accum_refuses_what_it_does_not_take():
    _needs_card()
    from se3conv3d_tpu_torch.kernels.build import library

    a = torch.zeros(256, 8, device="cuda")
    before = probes.rank3_accum.launches
    for args in ((a, 2, 2, 0), (a, 2, 2, 100), (a, 0, 2, 128), (a, 2, 0, 128), (a[:0], 2, 2, 128),
                 (torch.zeros(256, 0, device="cuda"), 2, 2, 128)):
        with pytest.raises(ValueError):
            probes.rank3_accum(*args)
    out = torch.empty(2, 8, 2, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for s, rows, c, gq, o, slab in ((0, 128, 8, 2, 2, 1), (2, 0, 8, 2, 2, 1), (2, 128, 0, 2, 2, 1),
                                    (2, 128, 8, 0, 2, 1), (2, 128, 8, 2, 0, 1), (2, 128, 8, 2, 2, 0)):
        assert library("probe_bwd").se3_probe_rank3_accum(a.data_ptr(), out.data_ptr(), s, rows, c, gq, o, slab,
                                                          stream) == 1
    assert probes.rank3_accum.launches == before


def _gather_inputs(nq, r, nb, block_rows, c, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, nb, (nq, r), device="cuda", generator=gen, dtype=torch.int32)
    return ids, torch.randn(nb * block_rows, c, device="cuda", generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [*range(1, 9), 20])
@pytest.mark.parametrize("block_rows, c", [(32, 128), (5, 132), (3, 20)])
def test_gather_sum_blocks_matches_plain_bitwise(r, block_rows, c):
    _needs_card()
    ids, tab = _gather_inputs(11, r, 13, block_rows, c, 100 * r + c)
    before = cc.gather_sum_blocks.launches
    got = cc.gather_sum_blocks(ids, tab, block_rows)
    torch.cuda.synchronize()
    assert cc.gather_sum_blocks.launches == before + 1
    want = cc.gather_sum_blocks_reference(ids, tab, block_rows)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if r > 8:  # an id outside the table in the third batch of 4 ids
        ids[2, 11] = 13
        bad = cc.gather_sum_blocks(ids, tab, block_rows).view(11, -1)
        others = torch.arange(11, device="cuda") != 2
        assert bool(bad[2].isnan().all())
        assert torch.equal(bad[others].view(torch.int32), want.view(11, -1)[others].view(torch.int32))
    if r == 1:  # p1's kernel on the same ids: 2 x, no zero added first
        tab[:block_rows] = -0.0
        ids[0, 0] = 0
        got = cc.gather_blocks(ids[:, 0].contiguous(), tab, block_rows)
        want = cc.gather_blocks_reference(ids[:, 0].contiguous(), tab, block_rows)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert bool(torch.signbit(got[:block_rows]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["p1", "p2", "p4"])
def test_block_gather_bad_id_gives_a_nan_block_and_leaves_the_rest(part):
    _needs_card()
    x = pc.draw(part, 21, "cuda")
    good = pc.run(part, x).clone()
    ids = x["ids"].clone()
    nb = pc.QB if part == "p4" else pc.NB
    i = 3
    if ids.dim() == 1:
        ids[i] = nb
    else:
        ids[i, ids.shape[1] - 1] = -1
    bad = pc.run(part, {**x, "ids": ids}).view(ids.shape[0], -1)
    good = good.view(ids.shape[0], -1)
    others = torch.arange(ids.shape[0], device="cuda") != i
    assert bool(bad[i].isnan().all())
    assert torch.equal(bad[others].view(torch.int32), good[others].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["p1", "p2", "p4"])
def test_block_gather_is_graph_node_types(part):
    _needs_card()
    x = pc.draw(part, 22, "cuda")
    assert _graph_node_types(lambda: pc.run(part, x)) == [0]


@pytest.mark.cuda
def test_block_gather_refuses_what_it_does_not_take():
    _needs_card()
    from se3conv3d_tpu_torch.kernels.build import library

    ids, tab = _gather_inputs(4, 2, 8, 4, 16, 5)
    with pytest.raises(ValueError, match="ids a block"):
        cc.gather_sum_blocks(torch.zeros(4, 0, dtype=torch.int32, device="cuda"), tab, 4)
    with pytest.raises(ValueError, match="aligned"):
        cc.gather_sum_blocks(ids, torch.zeros(8 * 4 * 16 + 1, device="cuda")[1:].view(8 * 4, 16), 4)
    with pytest.raises(ValueError, match="multiple of 4"):
        cc.gather_sum_blocks(ids, torch.zeros(8 * 3, 3, device="cuda"), 3)
    out = torch.empty(4 * 4, 16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib = library("probe_cellconv")
    for nq, r, block, scaled, threads in ((0, 2, 64, 0, 128), (4, 0, 64, 0, 128), (4, 2, 62, 0, 128),
                                          (4, 2, 64, 1, 128), (4, 2, 64, 0, 48), (4, 2, 64, 0, 512)):
        assert lib.se3_probe_block_gather(ids.data_ptr(), nq, r, tab.data_ptr(), 8, block, scaled, 2.0, threads,
                                          out.data_ptr(), stream) == 1
