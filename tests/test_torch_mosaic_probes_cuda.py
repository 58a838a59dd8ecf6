"""The kernels of the last Mosaic probe sites (``kernels/probes.py``'s
accumulators, ``kernels/cellconv_probes.py``, ``kernels/mosaic_probes.py``)
against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_mosaic_probes_cuda.py``.
The products, the accumulator, p3's masked distance product and p11's
column sums run as one launch a call (the kernel nodes of a call captured
into a CUDA graph); the accumulator's total and the column sums are the
orders their source states, bit for bit, and the accumulator's cooperative
launch replays from a CUDA graph.  p3 also runs at two more shapes it takes
(one whose rings wrap around), and both p3 and p11 refuse shapes they do
not take, in the wrapper and in the C entry.  Tolerances, as the CLIs hold them: gathers, copies, ``2a`` and the r-ordered
sums bit for bit; the accumulators' totals within ``1e-9 * sum |a|`` of
the float64 total and the column sums within ``1e-6`` of each column's ``sum |a|`` (float32 sums
in other orders); products within ``1e-5 * max |plain|`` (float32 sums in
other orders, TF32 off; bfloat16 products are exact in float32); p3's pne
bit for bit (no mask disagreement).  Every fixed-order sum gives the same
bits on a second call.
"""
import ctypes

import pytest
import torch

from se3conv3d_tpu_torch.experiments import bisect_accum, bisect_accum2, probe_cellconv, probe_mosaic
from se3conv3d_tpu_torch.kernels import cellconv_probes, mosaic_probes, probes
from se3conv3d_tpu_torch.kernels.build import library


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


def _graph_node_types(fn) -> list:
    """The node types of one call of ``fn`` captured into a CUDA graph
    (read with ``cuGraphGetNodes`` / ``cuGraphNodeGetType`` of
    ``libcuda``; 0 is a kernel): what the call launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up on the capture stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        types.append(t.value)
    return types


@pytest.mark.cuda
@pytest.mark.parametrize("with_dfeat", [True, False])
def test_block_total_accum_is_one_launch(with_dfeat):
    _needs_card()
    a = bisect_accum.draw(32, 8, "cuda")
    assert _graph_node_types(lambda: probes.block_total_accum(a, bisect_accum.SHAPES, with_dfeat)) == [0]


@pytest.mark.cuda
@pytest.mark.parametrize("grid_n", [16, 64])
def test_block_total_accum_sums_in_its_stated_order(grid_n):
    """The kernel's total is :func:`probes.block_total_in_kernel_order`'s
    bit for bit: the order its source states, written out in PyTorch."""
    _needs_card()
    a = bisect_accum.draw(grid_n, 9, "cuda")
    (out,) = probes.block_total_accum(a, [(1, 64)], False)
    want = probes.block_total_in_kernel_order(a, probes.accum_blocks(a.device))
    assert torch.equal(out, want.expand(1, 64))


@pytest.mark.cuda
def test_block_total_accum_replays_from_a_cuda_graph():
    """The cooperative launch captures into a CUDA graph, and two replays
    give the eager call's bits."""
    _needs_card()
    a = bisect_accum.draw(16, 10, "cuda")
    eager = probes.block_total_accum(a, bisect_accum.SHAPES, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = probes.block_total_accum(a, bisect_accum.SHAPES, True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, eager))


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


# (NQ, NC, C, xyz row length): a shape whose candidates fill no group's
# ring (3 slices for 4 groups, 3 channel tiles), and one whose rings wrap
# around 8 times (1,024 candidates), beside the script's (2,048, 512, 128)
P3_SHAPES = [(192, 96, 96, 3), (128, 1024, 64, 8)]


def _p3_inputs(nq, nc, c, ld, seed):
    """Uniform [0, 1) xyz (rows of ``ld``), standard normal features, with
    every 7th candidate planted within the radius of a query, on the card."""
    gen = torch.Generator().manual_seed(seed)
    qp, cp = torch.rand(nq, ld, generator=gen), torch.rand(nc, ld, generator=gen)
    near = torch.arange(0, nc, 7)
    cp[near, :3] = qp[(near * 5) % nq, :3] + 0.05 * torch.rand(near.numel(), 3, generator=gen)
    return qp.cuda(), cp.cuda(), torch.randn(nc, c, generator=gen).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", P3_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_masked_dist_product_at_other_shapes_matches_plain(shape):
    """At shapes the kernel takes besides the script's: pne bit for bit,
    the product within ``P3_RTOL * max |plain|``, two calls the same bits."""
    _needs_card()
    qp, cp, cf = _p3_inputs(*shape, seed=15)
    pne = torch.empty(qp.shape[0], cp.shape[0], device="cuda")
    got = cellconv_probes.masked_dist_product(qp, cp, cf, pne)
    again = cellconv_probes.masked_dist_product(qp, cp, cf)
    torch.cuda.synchronize()
    plain = cellconv_probes.masked_dist_pne(qp, cp)
    assert int((plain != 0).sum()) > 0
    assert torch.equal(pne, plain) and torch.equal(got, again)
    ref = cellconv_probes.masked_dist_product_reference(qp, cp, cf)
    assert float((got - ref).abs().max()) <= probe_cellconv.P3_RTOL * float(ref.abs().max())


@pytest.mark.cuda
def test_masked_dist_product_is_one_launch():
    _needs_card()
    x = probe_cellconv.draw("p3", 16, "cuda")
    pne = torch.empty(probe_cellconv.QB3 * probe_cellconv.Q3, probe_cellconv.CAND, device="cuda")
    before = cellconv_probes.masked_dist_product.launches
    assert _graph_node_types(lambda: cellconv_probes.masked_dist_product(x["qp"], x["cp"], x["cf"])) == [0]
    assert _graph_node_types(lambda: cellconv_probes.masked_dist_product(x["qp"], x["cp"], x["cf"], pne)) == [0]
    assert cellconv_probes.masked_dist_product.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(96, 96, 96), (128, 48, 64), (128, 96, 48), (0, 96, 64)])
def test_masked_dist_product_refuses_shapes_it_does_not_take(shape):
    """NQ not a multiple of 64, NC not of 32, C not of 32, or empty: the
    wrapper raises ``ValueError`` and the C entry returns
    ``cudaErrorInvalidValue`` (1); neither falls back to the plain version."""
    _needs_card()
    nq, nc, c = shape
    qp, cp, cf = torch.rand(nq, 8, device="cuda"), torch.rand(nc, 8, device="cuda"), torch.randn(nc, c, device="cuda")
    before = cellconv_probes.masked_dist_product.launches
    with pytest.raises(ValueError, match="the kernel takes"):
        cellconv_probes.masked_dist_product(qp, cp, cf)
    out = torch.empty(max(nq, 1), c, device="cuda")
    err = library("probe_cellconv").se3_probe_masked_dist_product(
        qp.data_ptr(), 8, nq, cp.data_ptr(), 8, nc, cf.data_ptr(), c, out.data_ptr(), None,
        torch.cuda.current_stream().cuda_stream)
    assert err == 1 and cellconv_probes.masked_dist_product.launches == before


# [S * TM, C]: p11's, odd widths (a partial 32-column chunk), many blocks,
# and block sums past 48 KB of shared memory (the raised limit)
COLUMN_SHAPES = [(8, 32), (3, 40), (16, 100), (2, 3000), (64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COLUMN_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grid_column_accum_sums_in_its_stated_order(shape):
    """The kernel's column sums are :func:`probes.grid_column_in_kernel_order`'s
    bit for bit (rows in order within each block of TM, then the blocks in
    order, each from zero), and a second call gives the same bits."""
    _needs_card()
    s, c = shape
    a = torch.randn(s * probes.TM, c, generator=torch.Generator().manual_seed(s + c)).cuda()
    got, again = probes.grid_column_accum(a), probes.grid_column_accum(a)
    assert torch.equal(got, probes.grid_column_in_kernel_order(a)) and torch.equal(got, again)


@pytest.mark.cuda
def test_grid_column_accum_is_one_launch():
    _needs_card()
    (a,) = probe_mosaic.draw("p11_grid_accum", 17, "cuda")
    before = probes.grid_column_accum.launches
    assert _graph_node_types(lambda: probes.grid_column_accum(a)) == [0]
    assert probes.grid_column_accum.launches == before + 2


@pytest.mark.cuda
def test_grid_column_accum_refuses_block_sums_past_shared_memory():
    """S * C block sums past the block's 227 KB: the wrapper raises
    ``ValueError`` and the C entry returns ``cudaErrorInvalidValue`` (1)."""
    _needs_card()
    s = 2
    c = probes.COLUMN_PARTIALS_MAX_BYTES // (4 * s) + 1
    a = torch.zeros(s * probes.TM, c, device="cuda")
    before = probes.grid_column_accum.launches
    with pytest.raises(ValueError, match="block sums"):
        probes.grid_column_accum(a)
    out = torch.empty(1, c, device="cuda")
    err = library("probe_accum").se3_probe_grid_column_accum(a.data_ptr(), s, probes.TM, c, out.data_ptr(),
                                                             torch.cuda.current_stream().cuda_stream)
    assert err == 1 and probes.grid_column_accum.launches == before


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
@pytest.mark.parametrize("name", ["p3_multi_contract", "p15_dim0_contract"])
def test_split_depth_products_are_one_launch(name):
    """p3 and p15 split K over a cluster and add the partial tiles in the
    same launch: one kernel a call, no second pass."""
    _needs_card()
    assert mosaic_probes.product_plans()[name]["splits"] > 1
    xs = probe_mosaic.draw(name, 14, "cuda")
    fn = mosaic_probes.PROBES[name]
    before = fn.launches
    assert _graph_node_types(lambda: fn(*xs)) == [0]
    assert fn.launches == before + 2


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
