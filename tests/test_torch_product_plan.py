"""The conv's shared product (``csrc/wg_product.cuh``) on the CPU: its tile
and split plan (the Python mirror in ``kernels/product.py``, which the card
tests hold equal to the C plans), the 3xTF32 split and the slice rule
emulated in numpy against float64, the bounds ``chip_smoke.py`` prints beside
each product, and the port's layout of the three products (``[L*G, C*Q] .
[C*Q, O]`` with W shared over g) against the JAX package's per-gq
contractions, its Pallas forward and backward run in interpret mode.
The kernel itself runs on the card: ``tests/test_torch_product_cuda.py``.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import se3conv3d_tpu.ops.pallas.fused_equiv as fe
from se3conv3d_tpu_torch.kernels import product as kp
from se3conv3d_tpu_torch.kernels.fused_equiv import FWD_SCRATCH_BYTES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (I, J, K) of products the recipes and chip_smoke.py's phase 39 give
SHAPES = [(131072, 64, 2048), (2048, 64, 131072), (131072, 2048, 64), (1000, 32, 1024), (4099, 64, 2048),
          (777, 18, 480), (2051, 320, 10240), (16384, 512, 6144), (264, 1024, 16384), (1, 1, 1)]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_products", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("i,j,k", SHAPES)
def test_items_cover_every_tile_and_depth_once_in_order(i, j, k, elem_bytes):
    n_splits = kp.splits(kp.tiles(i, j), k, j, kp.MAX_SPLITS)
    items = kp.items(i, j, k, n_splits, elem_bytes)
    bn, ks = kp.tile_cols(j), kp.stage_depth(elem_bytes)
    n_i, n_j = -(-i // kp.TILE_ROWS), -(-j // bn)
    assert len(items) == n_i * n_j * n_splits
    # the fixed order: split, then row tile, then column tile (fastest)
    assert [it[:3] for it in items] == [(z, a, b) for z in range(n_splits) for a in range(n_i) for b in range(n_j)]
    by_tile = {}
    for z, ti, tj, kb, ke in items:
        if kb < ke:
            by_tile.setdefault((ti, tj), []).append((kb, ke))
    assert len(by_tile) == n_i * n_j
    for ranges in by_tile.values():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(x[1] == y[0] for x, y in zip(ranges, ranges[1:]))  # no gap, no overlap
        assert all(kb % ks == 0 for kb, _ in ranges)  # whole stages, so a box never crosses a split
    assert 1 <= n_splits <= min(kp.MAX_SPLITS, -(-k // kp.MIN_SPLIT_DEPTH))


def test_splits_fill_the_card_where_the_tiles_do_not():
    # d_w at the ScanNet level 0: 16 tiles of 2,048 x 64 over 131,072 rows,
    # 33 splits: 528 items, four for every block of 132
    assert kp.splits(kp.tiles(2048, 64), 131072, 64, kp.MAX_SPLITS) == 33
    # the forward at the ScanNet level 0: 1,024 row tiles need no split
    assert kp.splits(kp.tiles(131072, 64), 2048, 64, kp.MAX_SPLITS) == 1
    # no more splits than room for their partials
    assert kp.splits(16, 131072, 64, 3) <= 3
    assert kp.split_depth(131072, 8, 4) == 16384 and kp.split_depth(100, 3, 2) == 64


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("n_live,g,q,c,o", [(131072, 1, 32, 64, 64), (22563, 1, 32, 64, 64), (512, 1, 32, 320, 320),
                                            (3072, 2, 32, 512, 512), (132, 2, 32, 512, 1024), (65536, 4, 32, 32, 32),
                                            (1, 1, 24, 20, 18), (3, 4, 16, 24, 20)])
def test_forward_chunks_stay_within_the_scratch_cap(n_live, g, q, c, o, elem_bytes):
    chunk, n_splits, scratch = kp.fwd_plan(n_live, g, q, c, o, FWD_SCRATCH_BYTES, elem_bytes)
    cq, rows = c * q, chunk * g
    image = kp.round16(kp.image_bytes(o, cq, elem_bytes))
    assert -(-n_live // chunk) * chunk >= n_live > (-(-n_live // chunk) - 1) * chunk
    partials = n_splits * rows * o * 4 if n_splits > 1 else 0
    assert scratch == image + kp.round16(rows * cq * elem_bytes) + partials
    if chunk > 1:  # a single row over the cap is taken alone
        assert rows * cq * elem_bytes + partials <= FWD_SCRATCH_BYTES
    assert rows * cq < 2**31 and kp.tiles(rows, o) * n_splits < 2**31  # the kernel's 32-bit tile indices
    bwd_scratch, w_splits, p_blocks = kp.bwd_plan(n_live, g, q, c, o, elem_bytes)
    assert bwd_scratch == (kp.round16(n_live * g * cq * elem_bytes) + kp.round16(n_live * g * o * elem_bytes)
                           + kp.round16(kp.image_bytes(cq, o, elem_bytes)))
    assert 1 <= w_splits <= kp.MAX_SPLITS and 1 <= p_blocks <= 1024


def test_weight_images_hold_eight_bytes_a_weight_in_float32():
    assert kp.image_bytes(64, 2048, 4) == 8 * 2048 * 64  # 1 MiB at the ScanNet level 0
    assert kp.image_bytes(1024, 16384, 4) == 128 << 20  # the global vector's O = 1024
    assert kp.image_bytes(64, 2048, 2) == 2 * 2048 * 64
    assert kp.image_bytes(18, 480, 4) == 8 * 64 * 480  # padded to a tile and a stage
    assert kp.product_plan("dw", 2048, 64, 131072, 4) == (33, 33 * 2048 * 64 * 4)
    assert kp.product_plan("dbasis", 131072, 2048, 64, 2) == (1, kp.image_bytes(2048, 64, 2))


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("a_mn,b_rows", [(False, False), (True, True)])
@pytest.mark.parametrize("bn", [64, 128])
def test_ring_has_four_stages_within_one_block(elem_bytes, a_mn, b_rows, bn):
    stages, nbytes = kp.ring_stages(elem_bytes, a_mn, b_rows, bn)
    assert 4 <= stages <= kp.MAX_STAGES and nbytes <= kp.SMEM_MAX
    # each stage keeps 16 KB of A in flight: with the ring, 48-112 KB an SM
    assert (stages - 1) * kp.TILE_ROWS * kp.DEPTH_BYTES >= 48 << 10


def to_tf32(x: np.ndarray) -> np.ndarray:
    """The kernel's to_tf32: an integer add and mask (round to nearest, ties
    away from zero, 10 mantissa bits)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_hi_lo_split_keeps_float32():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.integers(-6, 6, 100_000)).astype(np.float32)
    hi = to_tf32(x)
    lo = to_tf32((x - hi).astype(np.float32))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(x.astype(np.float64) - hi) <= 2.0 ** -11 * np.abs(x))  # TF32: half an ulp of 10 bits
    assert np.all(np.abs(x.astype(np.float64) - hi - lo) <= 2.0 ** -21 * np.abs(x))  # hi + lo: ~float32


def slice_sums(a: np.ndarray, b: np.ndarray, three: bool) -> np.ndarray:
    """The kernel's float32 arithmetic for C = a . b over its depth: each
    16-deep slice summed apart (lo.hi + hi.lo + hi.hi with 3xTF32, else hi.hi
    alone), then added to the running sum in float32."""
    ah, bh = to_tf32(a), to_tf32(b)
    al, bl = to_tf32(a - ah), to_tf32(b - bh)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 16):
        s = slice(k0, k0 + 16)
        part = ah[:, s].astype(np.float64) @ bh[s].astype(np.float64)
        if three:
            part += al[:, s].astype(np.float64) @ bh[s] + ah[:, s].astype(np.float64) @ bl[s]
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def test_three_tf32_products_in_slices_hold_the_forward_bound():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((64, 2048)).astype(np.float32)
    b = (rng.standard_normal((2048, 64)) / 45.0).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    three = np.abs(slice_sums(a, b, True) - exact).max() / scale
    one = np.abs(slice_sums(a, b, False) - exact).max() / scale
    assert three <= 1e-6 < 1e-5  # the forward's gate: 1e-5 of max |plain|
    assert one > 1e-4  # plain TF32 keeps about three digits: the control


def truncating_sum(terms: np.ndarray, slice_depth: int) -> np.ndarray:
    """Sums of ``terms [depth, n]`` as tensor cores add: toward zero in
    float32, within slices of ``slice_depth``, the slices added to the running
    sum rounded to nearest (``slice_depth`` = depth: one truncating chain)."""
    def rz(x64):
        x32 = x64.astype(np.float32)
        over = np.abs(x32.astype(np.float64)) > np.abs(x64)
        return np.where(over, np.nextafter(x32, np.float32(0)), x32)

    acc = np.zeros(terms.shape[1], np.float32)
    for k0 in range(0, terms.shape[0], slice_depth):
        part = np.zeros(terms.shape[1], np.float32)
        for t in terms[k0:k0 + slice_depth]:
            part = rz(part.astype(np.float64) + t)
        acc = (acc + part).astype(np.float32)
    return acc


def test_slice_rule_keeps_deep_sums_unbiased():
    # a d_w column over 16,384 rows of positive products: one truncating
    # chain drifts low by about depth x an ulp; 16-deep slices do not
    terms = np.abs(np.random.default_rng(3).standard_normal((16384, 32))).astype(np.float32)
    exact = terms.astype(np.float64).sum(0)
    sliced = np.abs(truncating_sum(terms, 16) - exact).max() / exact.max()
    chained = np.abs(truncating_sum(terms, 16384) - exact).max() / exact.max()
    assert sliced <= 1e-5 and chained >= 20 * sliced


def test_product_bounds(smoke):
    # the ScanNet level 0: bound by the pass over the basis scratch
    f = smoke.product_bound("fwd", 131072, 64, 2048)
    assert f["bound_by"] == "bytes"
    assert f["bound_ms"] == pytest.approx((4 * 131072 * 2048 + 4 * 2048 * 64 + 4 * 131072 * 64) / 3.35e12 * 1e3)
    assert f["bound_ms"] == pytest.approx(0.3307, abs=1e-4) and f["gflop"] == pytest.approx(34.36, abs=0.01)
    b = smoke.product_bound("fwd", 131072, 64, 2048, torch.bfloat16)
    assert b["bound_ms"] == pytest.approx(0.1704, abs=1e-4)
    d = smoke.product_bound("dbasis", 131072, 2048, 64, torch.bfloat16)  # the output in bfloat16
    assert d["bound_ms"] == pytest.approx((2 * 131072 * 64 + 4 * 2048 * 64 + 2 * 131072 * 2048) / 3.35e9)
    # the ModelNet40 level 5 fully live: 103 GFLOP at the 3xTF32 ceiling
    m = smoke.product_bound("dw", 16384, 512, 6144)
    assert m["bound_by"] == "operations" and m["bound_ms"] == pytest.approx(2 * 16384 * 512 * 6144 / 165e9)
    assert smoke.product_dims("dw", 6144, 16384, 512) == (16384, 512, 6144)
    assert smoke.product_dims("dbasis", 6144, 16384, 512) == (6144, 16384, 512)


# --- the port's layout against JAX's per-gq contractions ------------------------

M, E, C, Q, G, O, D = 16, 8, 8, 4, 2, 8, 9


def jax_case(seed: int):
    """Inputs of the TPU kernels (``_fused_single_fwd``: geometry rows with a
    ones row per frame for the bias, features, the folded parameters) and the
    basis in the port's layout, ``[M*G, C*Q]`` (row m*G + g, depth c*Q + q),
    computed in float64 from the pne the kernels compute (``act = 'linear'``:
    pne = projT . geo)."""
    rng = np.random.default_rng(seed)
    geo = rng.standard_normal((G, D + 1, M * E)).astype(np.float32)
    geo[:, D] = 1.0
    geo_t = geo.reshape(G * (D + 1), M * E)
    feat = rng.standard_normal((M, E, C)).astype(np.float32)
    pa = (rng.standard_normal((D, Q)) * 0.3).astype(np.float32)
    pb = (rng.standard_normal(Q) * 0.1).astype(np.float32)
    w = (rng.standard_normal((C, Q, O)) / np.sqrt(C * Q)).astype(np.float32)
    projT, w2 = fe._fold_params(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(w), G)
    pne = np.asarray(projT, np.float64) @ geo_t.astype(np.float64)  # [G*Q, M*E]
    pne3 = pne.T.reshape(M, E, G, Q)
    basis = np.einsum("megq,mec->mgcq", pne3, feat.astype(np.float64)).reshape(M * G, C * Q)
    return geo_t, feat, projT, w2, w, basis


def test_forward_layout_equals_the_per_gq_contraction_summed_over_q():
    geo_t, feat, projT, w2, w, basis = jax_case(5)
    out, _ = fe._fused_single_fwd(jnp.asarray(geo_t), jnp.asarray(feat), projT, w2, "linear", G, 8, None)
    jax_out = np.asarray(out, np.float64)  # [G, M, O]
    port = kp.product_reference("fwd", torch.from_numpy(basis), torch.from_numpy(w.reshape(C * Q, O)))
    port = port.double().numpy().reshape(M, G, O).transpose(1, 0, 2)
    assert np.abs(port - jax_out).max() <= 1e-5 * np.abs(jax_out).max()


def test_dw_layout_summed_over_g_equals_the_per_gq_contraction():
    geo_t, feat, projT, w2, w, basis = jax_case(6)
    gout = np.random.default_rng(7).standard_normal((G, M, O)).astype(np.float32)
    _, dfeat, dprojT, dw2 = fe._fused_single_bwd("linear", G, 8, None, (jnp.asarray(geo_t), jnp.asarray(feat),
                                                                          projT, w2), jnp.asarray(gout))
    _, _, jax_dw = fe._unfold_param_grads(dprojT, dw2, D, Q, G)  # [C, Q, O], dw2 summed over g
    gl = gout.transpose(1, 0, 2).reshape(M * G, O)  # the compact rows: row m*G + g
    port = kp.product_reference("dw", torch.from_numpy(basis), torch.from_numpy(gl).double())
    jax_dw = np.asarray(jax_dw, np.float64)
    assert np.abs(port.double().numpy().reshape(C, Q, O) - jax_dw).max() <= 1e-5 * np.abs(jax_dw).max()


def test_dbasis_layout_equals_the_per_gq_contraction():
    _, _, _, w2, w, _ = jax_case(8)
    gout = np.random.default_rng(9).standard_normal((G, M, O)).astype(np.float32)
    # _bwd_kernel: g_exp[gq, m, o] = gout[g, m, o]; dbasis_b[gq, m, c] = sum_o g_exp . W2[gq, c, o]
    g_exp = jnp.broadcast_to(jnp.asarray(gout)[:, None], (G, Q, M, O)).reshape(G * Q, M, O)
    dbasis_b = jax.lax.dot_general(g_exp, w2, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
                                   preferred_element_type=jnp.float32)  # [G*Q, M, C]
    want = np.asarray(dbasis_b, np.float64).reshape(G, Q, M, C).transpose(2, 0, 3, 1).reshape(M * G, C * Q)
    gl = torch.from_numpy(gout.transpose(1, 0, 2).reshape(M * G, O))
    port = kp.product_reference("dbasis", gl, torch.from_numpy(w.reshape(C * Q, O))).double().numpy()
    assert np.abs(port - want).max() <= 1e-5 * np.abs(want).max()


def test_cpu_wrapper_runs_the_plain_version_and_checks_its_arguments():
    a, w = torch.randn(40, 24), torch.randn(24, 8)
    before = kp.product.launches
    assert torch.equal(kp.product("fwd", a, w), kp.product_reference("fwd", a, w))
    rowmap = torch.tensor([3, -1, 7, 0, 99], dtype=torch.int32)
    mapped = kp.product("fwd", a, w, rowmap, 8, 10)
    assert mapped.shape == (80, 8)
    assert torch.equal(mapped[24:32], kp.product_reference("fwd", a, w)[:8])
    assert not mapped[8:24].any()  # rows no entry names stay zero; entries -1 and 99 store nothing
    assert kp.product.launches == before  # CPU calls do not count
    with pytest.raises(ValueError):
        kp.product("conv", a, w)
