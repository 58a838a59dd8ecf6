"""The conv's shared product (``csrc/wg_product.cuh``, alone through
``kernels.product``) on the card against its plain version in float64.

Needs an NVIDIA GPU and ``nvcc`` (``cuda`` marker): skipped elsewhere.  The
file imports torch only, so the card runs it without JAX:
``python -m pytest --noconftest -q tests/test_torch_product_cuda.py``.
Bounds, as the conv kernels' (``tests/test_torch_kernel_cuda.py``): the
forward layout ``1e-5 * max |plain|`` (3xTF32 keeps float32 accuracy; the
sums run in another order), d_w and dbasis ``1e-4`` (d_w sums thousands of
rows); bfloat16 operands ``1e-2`` max and ``1e-4`` mean of ``max |plain|``,
the plain version rounding W (and dbasis's output) as the kernel does.  Two
calls give the same bits: every split is summed in a fixed order.
"""
import ctypes

import pytest
import torch

from se3conv3d_tpu_torch.kernels import fused_equiv as kfe
from se3conv3d_tpu_torch.kernels import product as kp
from se3conv3d_tpu_torch.kernels.build import library
from se3conv3d_tpu_torch.kernels.fused_equiv import FWD_SCRATCH_BYTES

# name: (rows, C*Q, O, G of a forward row map or None): chip_smoke.py's phase
# 39 without its ScanNet level 0 (rows past the 128-row tile at O = 32, 64
# and 18, whose 72- and 36-byte rows are copied value by value; O = 320,
# 512, 1024; G = 4 through a row map)
CASES = {
    "o32_ragged": (1000, 1024, 32, None),
    "o64_ragged": (4099, 2048, 64, None),
    "o18_unaligned": (777, 480, 18, None),
    "o320": (2051, 10240, 320, None),
    "o512": (1537, 16384, 512, None),
    "o1024": (264, 16384, 1024, None),
    "g4_rowmap": (4 * 301, 1024, 32, 4),
}
RTOL = {"fwd": 1e-5, "dw": 1e-4, "dbasis": 1e-4}
BF16_RTOL, BF16_MEAN_RTOL = 1e-2, 1e-4
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the product is a CUDA kernel")


def _operands(layout, rows, cq, o, dtype, seed):
    """``(a, b)`` at ``layout``: basis [rows, C*Q] and gout rows [rows, O]
    in ``dtype``, W [C*Q, O] float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    basis = torch.randn(rows, cq, device="cuda", generator=gen).to(dtype)
    gout = torch.randn(rows, o, device="cuda", generator=gen).to(dtype)
    w = torch.randn(cq, o, device="cuda", generator=gen) / cq ** 0.5
    return {"fwd": (basis, w), "dw": (basis, gout), "dbasis": (gout, w)}[layout]


def _row_map(rows, g):
    n = rows // g
    entries = torch.arange(n, dtype=torch.int32) * 2
    entries[n // 3], entries[-1] = -1, 2 * n + 5  # store nothing
    return entries.cuda(), 2 * n


def _within(got, ref, layout, dtype):
    diff = (got.double() - ref.double()).abs()
    scale = ref.double().abs().max().item()
    if dtype == torch.bfloat16:
        return diff.max().item() <= BF16_RTOL * scale and diff.mean().item() <= BF16_MEAN_RTOL * scale
    return diff.max().item() <= RTOL[layout] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", sorted(kp.LAYOUTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_product_matches_plain_and_repeats_bitwise(case, layout, dtype):
    _needs_card()
    rows, cq, o, g = CASES[case]
    dt = DTYPES[dtype]
    a, b = _operands(layout, rows, cq, o, dt, sorted(CASES).index(case))
    rowmap, map_rows = _row_map(rows, g) if g and layout == "fwd" else (None, 0)
    g = g if rowmap is not None else 1
    got = kp.product(layout, a, b, rowmap, g, map_rows)
    again = kp.product(layout, a, b, rowmap, g, map_rows)
    ref = kp.product_reference(layout, a, b, rowmap, g, map_rows)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype and torch.isfinite(got.float()).all()
    assert got.dtype == (dt if layout == "dbasis" else torch.float32)
    assert _within(got, ref, layout, dt)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", sorted(kp.LAYOUTS))
def test_rows_off_sixteen_bytes_are_copied_value_by_value(layout, dtype):
    _needs_card()
    dt = DTYPES[dtype]
    a, b = _operands(layout, 300, 1000, 40, dt, 11)
    wide = torch.zeros(a.shape[0], a.shape[1] + 1, dtype=dt, device="cuda")
    wide[:, 1:] = a
    a_odd = wide[:, 1:]  # rows 1001 values apart, the base one value on
    got = kp.product(layout, a_odd, b)
    ref = kp.product_reference(layout, a, b)
    torch.cuda.synchronize()
    assert _within(got, ref, layout, dt)
    assert torch.equal(got, kp.product(layout, a, b))  # the same bits as through the tensor maps


@pytest.mark.cuda
def test_refuses_a_stride_it_does_not_take():
    _needs_card()
    a, w = _operands("fwd", 256, 512, 64, torch.float32, 12)
    with pytest.raises(ValueError):
        kp.product("fwd", a.t(), w.t().contiguous().t())  # columns not one value apart
    with pytest.raises(ValueError):
        kp.product("fwd", a[:, ::2], w[::2])
    out = torch.empty(256, 64, device="cuda")
    work = torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib = library("product")
    # rows shorter than their extent (lda < K) and an unknown layout: refused, nothing launched
    assert lib.se3_product(0, 0, a.data_ptr(), 100, w.data_ptr(), 64, out.data_ptr(), 64, None, 1, 0,
                           256, 64, 512, 1, work.data_ptr(), stream) == 1
    assert lib.se3_product(3, 0, a.data_ptr(), 512, w.data_ptr(), 64, out.data_ptr(), 64, None, 1, 0,
                           256, 64, 512, 1, work.data_ptr(), stream) == 1


@pytest.mark.cuda
def test_launches_a_call():
    _needs_card()
    a, w = _operands("fwd", 300, 256, 32, torch.float32, 13)
    before = kp.product.launches
    kp.product("fwd", a, w)
    kp.product("dbasis", *_operands("dbasis", 300, 256, 32, torch.float32, 13))
    assert kp.product.launches == before + 2
    # the conv wrappers count the product's launches inside them: one a
    # forward chunk, two a backward
    b, m, n, k, g, f, q, c, o = 2, 64, 50, 8, 2, 2, 16, 8, 16
    gen = torch.Generator(device="cuda").manual_seed(14)
    args = (torch.randn(b, m, k, g, 3, device="cuda", generator=gen), torch.randn(b, m, k, g, f, 6, device="cuda",
                                                                                   generator=gen),
            torch.randn(b, n, f, c, device="cuda", generator=gen),
            torch.randint(0, n, (b, m, k), device="cuda", generator=gen),
            torch.rand(b, m, k, device="cuda", generator=gen) < 0.7,
            torch.randn(9, q, device="cuda", generator=gen), torch.randn(q, device="cuda", generator=gen),
            torch.randn(c, q, o, device="cuda", generator=gen))
    fwd0, bwd0 = kfe.fused_equiv_fwd.product_launches, kfe.fused_equiv_bwd.product_launches
    kfe.fused_equiv_fwd(*args)
    kfe.fused_equiv_bwd(*args, torch.randn(b, m, g, o, device="cuda", generator=gen))
    assert kfe.fused_equiv_fwd.product_launches == fwd0 + 1
    assert kfe.fused_equiv_bwd.product_launches == bwd0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_plans_mirror_the_c_plans(elem_bytes):
    _needs_card()
    for rows, cq, o, _ in [*CASES.values(), (131072, 2048, 64, None), (6144, 16384, 512, None)]:
        for layout, code in kp.LAYOUTS.items():
            dims = {"fwd": (rows, o, cq), "dw": (cq, o, rows), "dbasis": (rows, cq, o)}[layout]
            n_splits, scratch = ctypes.c_int(), ctypes.c_longlong()
            library("product").se3_product_plan(code, *dims, elem_bytes, ctypes.byref(n_splits),
                                                ctypes.byref(scratch))
            assert (n_splits.value, scratch.value) == kp.product_plan(layout, *dims, elem_bytes)
        q, c = 32, cq // 32
        for g in (1, 2, 4):
            chunk, n_splits, scratch = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
            library("fwd").se3_fused_equiv_fwd_plan(rows, g, q, c, o, FWD_SCRATCH_BYTES, elem_bytes,
                                                    ctypes.byref(chunk), ctypes.byref(n_splits),
                                                    ctypes.byref(scratch))
            assert (chunk.value, n_splits.value, scratch.value) == kp.fwd_plan(rows, g, q, c, o, FWD_SCRATCH_BYTES,
                                                                               elem_bytes)
            scratch, w_splits, p_blocks = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
            library("bwd").se3_fused_equiv_bwd_plan(rows, g, q, c, o, elem_bytes, ctypes.byref(scratch),
                                                    ctypes.byref(w_splits), ctypes.byref(p_blocks))
            assert (scratch.value, w_splits.value, p_blocks.value) == kp.bwd_plan(rows, g, q, c, o, elem_bytes)
