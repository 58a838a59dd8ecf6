#!/usr/bin/env python3
"""Variants of one probe kernel's source, built side by side and timed in
turns on one NVIDIA GPU.

    python3 probe_variants.py p3|p11|stage|copy|b4|gather|b1|b5 [--rounds 4] [--skip-diagnostics]

Each variant is the kernel's source in this checkout with a few lines
replaced (``KERNELS``); the first is the source as it stands.  Every
variant is compiled with ``nvcc`` (``kernels.build``'s flags, all at once)
into its own library under the git-ignored ``kernels/_build/variants/``, and
called through the same C entry as the wrapper calls on the same inputs;
device ms per call from ``chip_smoke.graph_ms`` (a CUDA graph of as many
calls as ``probe_ab.floor_graph_ms`` picks, so that a replay's fixed cost
of ~11 us is about a tenth or less of what is read),
round r in the listed order on even rounds and reversed on odd ones, the
one PyTorch call (``torch.matmul(pne, cf)``, ``torch.sum(a, 0)``, the
stage's weight product alone as ``torch.bmm``, b4's two-call yardstick)
timed after each round (b1: ``F.gelu(a, approximate="tanh")``, b5:
``torch.mul(a, 2.0)``); ``stage`` times the whole-tensor forward at each
of s1-s5 (``bisect_fused``'s inputs), ``copy`` the strided copy at each
copy probe's view, beside ``.contiguous()`` of the same view, ``gather``
the block gather at p1, p2 and p4 (``probe_cellconv``'s inputs), beside a
``clone`` of p4's output.  A variant marked ``diagnostic`` computes something else
(it drops work to show what that work costs) and is timed only; every
other must give the plain version's result as the wrapper's checks hold
it (p3: pne bit for bit, the product within ``P3_RTOL`` of max |plain|;
p11: bit for bit ``probes.grid_column_in_kernel_order``; stage: each
stage within ``bisect_fused.RTOL`` of max |plain|; copy and gather: bit for
bit; b4: bit for bit ``probes.rank3_in_kernel_order``; b5: bit for bit
``2a``; b1: within ``bisect_fused.RTOL`` of max |plain|, its error over
``chip_smoke.gelu_jvp_sweep`` printed beside its bound).  ``b1`` and ``b5``
(one streaming kernel, ``stream_map``, one float4 a thread) try 2, 4 and 8
float4s a thread, a ring of ``cp.async.bulk`` copies, streaming cache
hints on the loads and stores, and for b1 the first design's two
``tanhf``, ``__expf`` without the folded constants and the accurate
``expf`` / ``__frcp_rn``.  Prints each
variant's registers and spills (``-Xptxas -v``), its check, and the median
and range of its times beside the card's name and power limit.  It runs on
the card only.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# kernel: (source, C entry, ctypes argtypes, {variant: ([(old, new), ...], diagnostic)})
_ONE_PRODUCT = [("mma_tf32(lh[mt][nt], al[mt], bh[nt]);", ""), ("mma_tf32(hl[mt][nt], ah[mt], bl[nt]);", "")]
_NO_PNE = [("const float dx = __fsub_rn(qx, c.x), dy = __fsub_rn(qy, c.y), dz = __fsub_rn(qz, c.z);", ""),
           ("const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));",
            "const float d2 = qx - c.x;"),
           ("return d2 < kRadius2 ? __fadd_rn(__fmul_rn(d2, 3.f), 1.f) : 0.f;", "return d2;")]
_LO_RAW = [("// (d2 < 0.04) * (3 d2 + 1)", "__device__ __forceinline__ void split_raw(float x, uint32_t& hi, uint32_t& lo) "
            "{\n  hi = to_tf32(x);\n  lo = __float_as_uint(x - __uint_as_float(hi));\n}\n\n// (d2 < 0.04) * (3 d2 + 1)"),
           ("split_tf32(", "split_raw(")]
_AHEAD = "constexpr int kColAhead = 64;"
_HI_ONLY = [("mma_tf32(p, al[ks], bh);", ""), ("mma_tf32(p, ah[ks], bl);", ""),
            ("mma_tf32(p, pl[rr][n], bh);", ""), ("mma_tf32(p, ph[rr][n], bl);", ""),
            ("        mma_tf32(p, al, bh);\n        mma_tf32(p, ah, bl);\n        mma_tf32(p, ah, bh);",
             "        mma_tf32(p, ah, bh);")]
_RING = "constexpr int ring_slots(int stage) { return stage >= kWcontract ? 2 : 3; }"
_HI_ONLY = [("mma_tf32(p, al[ks], bh);", ""), ("mma_tf32(p, ah[ks], bl);", ""),
            ("mma_tf32(p, pl[rr][n], bh);", ""), ("mma_tf32(p, ph[rr][n], bl);", ""),
            ("        mma_tf32(p, al, bh);\n        mma_tf32(p, ah, bl);\n        mma_tf32(p, ah, bh);",
             "        mma_tf32(p, ah, bh);")]
_NO_AGG_MMA = [("mma_tf32(p, pl[rr][n], bh);", ""), ("mma_tf32(p, ph[rr][n], bl);", ""),
               ("mma_tf32(p, ph[rr][n], bh);", "")]
_NO_FEAT = [("    if (s + kRing - 1 < kSteps) load_step(s + kRing - 1);",
             "    if (s + kRing - 1 < kSteps && s + kRing - 1 >= kFeat) load_step(s + kRing - 1);"),
            ("    if (s < kSteps) load_step(s);", "    if (s < kSteps && s >= kFeat) load_step(s);")]
_NO_STORES = [("          *reinterpret_cast<float4*>(dst) = v;", "          if (v.x == 12345.f) *reinterpret_cast<float4*>(dst) = v;")]
_NO_W = [("    if (s + kRing - 1 < kSteps) load_step(s + kRing - 1);",
          "    if (s + kRing - 1 < kFeat) load_step(s + kRing - 1);"),
         ("    if (s < kSteps) load_step(s);", "    if (s < kFeat) load_step(s);")]
_NOT_UNROLLED = [("#pragma unroll 2\n    for (int t = 0; t < kFeatSteps; ++t) {",
                   "#pragma unroll 1\n    for (int t = 0; t < kFeatSteps; ++t) {"),
                  ("#pragma unroll 2\n    for (int ks = 0; ks < kPC / kCT; ++ks) {",
                   "#pragma unroll 1\n    for (int ks = 0; ks < kPC / kCT; ++ks) {")]
_RAW_PNE = [("""    uint32_t ph[2][4][4], pl[2][4][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        split_tf32(pne[rr][n][0], ph[rr][n][0], pl[rr][n][0]);
        split_tf32(pne[rr][n][2], ph[rr][n][1], pl[rr][n][1]);
        split_tf32(pne[rr][n][1], ph[rr][n][2], pl[rr][n][2]);
        split_tf32(pne[rr][n][3], ph[rr][n][3], pl[rr][n][3]);
      }
""", ""), ("""          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, pl[rr][n], bh);
          mma_tf32(p, ph[rr][n], bl);
          mma_tf32(p, ph[rr][n], bh);""", """          uint32_t ph[4], pl[4];
          split_tf32(pne[rr][n][0], ph[0], pl[0]);
          split_tf32(pne[rr][n][2], ph[1], pl[1]);
          split_tf32(pne[rr][n][1], ph[2], pl[2]);
          split_tf32(pne[rr][n][3], ph[3], pl[3]);
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, pl, bh);
          mma_tf32(p, ph, bl);
          mma_tf32(p, ph, bh);""")]
_COPY_THREADS = ("constexpr int kCopyThreads = 128;", "constexpr int kCopyThreads = 256;")
_COPY_UNROLL2 = ("constexpr int kCopyUnroll = 4;", "constexpr int kCopyUnroll = 2;")
_COPY_UNROLL8 = ("constexpr int kCopyUnroll = 4;", "constexpr int kCopyUnroll = 8;")
_SLAB = "const int gq_slab = slab;"
_GATHER_THREADS = "const int block_threads = threads;"
_LAUNCH = "  stream_map<Op><<<"
_STREAM_ENTRY = "// stream_map's launch:"
_STREAM_BODY = """    const float4 v = a[i];
    out[i] = make_float4(Op::map(v.x), Op::map(v.y), Op::map(v.z), Op::map(v.w));"""


def _variant_launch(launch: str) -> str:
    """Text put before stream_map's launch so that ``launch`` (a statement
    on the entry's ``in``, ``o``, ``n4`` and ``st``) runs instead."""
    return f"  {{\n    {launch}\n    return static_cast<int>(cudaGetLastError());\n  }}\n" + _LAUNCH


def _unroll(u: int) -> list:
    """b1 / b5 with ``u`` float4s a thread (a block of 256 threads covers
    256 u), every load of a thread issued before its first map."""
    kernel = f"""template <class Op>
__global__ void __launch_bounds__(kStreamThreads)
stream_map_u(const float4* __restrict__ a, float4* __restrict__ out, unsigned n4) {{
  constexpr int U = {u};
  const unsigned i0 = blockIdx.x * static_cast<unsigned>(kStreamThreads * U) + threadIdx.x;
  float4 v[U];
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (i0 + k * kStreamThreads < n4) v[k] = a[i0 + k * kStreamThreads];
#pragma unroll
  for (int k = 0; k < U; ++k)
    if (i0 + k * kStreamThreads < n4)
      out[i0 + k * kStreamThreads] = make_float4(Op::map(v[k].x), Op::map(v[k].y), Op::map(v[k].z), Op::map(v[k].w));
}}

"""
    launch = (f"stream_map_u<Op><<<(n4 + {256 * u - 1}u) / {256 * u}u, kStreamThreads, 0, st>>>(in, o, n4);")
    return [(_STREAM_ENTRY, kernel + _STREAM_ENTRY), (_LAUNCH, _variant_launch(launch))]


def _bulk_ring(chunk_bytes: int) -> list:
    """b1 / b5 as a persistent grid of at most 132 blocks, each walking
    chunks of ``chunk_bytes`` through a 2-slot shared-memory ring: one
    thread issues ``cp.async.bulk`` copies in (completing on an mbarrier)
    and out (bulk groups), chunk k + 1 loading while chunk k is mapped in
    place."""
    kernel = f"""constexpr unsigned kBulkF4 = {chunk_bytes // 16};

template <class Op>
__global__ void __launch_bounds__(kStreamThreads)
stream_bulk(const float4* __restrict__ a, float4* __restrict__ out, unsigned n4) {{
  __shared__ __align__(128) float4 ring[2][kBulkF4];
  __shared__ __align__(8) unsigned long long full[2];
  const unsigned chunks = (n4 + kBulkF4 - 1) / kBulkF4;
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(&full[0]));
  if (threadIdx.x == 0) {{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar + 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }}
  __syncthreads();
  auto issue = [&](unsigned c, int s) {{
    const unsigned bytes = min(kBulkF4, n4 - c * kBulkF4) * 16;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar + 8 * s), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(ring[s]))),
                 "l"(a + c * kBulkF4), "r"(bytes), "r"(bar + 8 * s)
                 : "memory");
  }};
  if (threadIdx.x == 0 && blockIdx.x < chunks) issue(blockIdx.x, 0);
  unsigned k = 0;
  for (unsigned c = blockIdx.x; c < chunks; c += gridDim.x, ++k) {{
    const int s = k & 1;
    if (threadIdx.x == 0 && c + gridDim.x < chunks) {{
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // slot s ^ 1's store has read it
      issue(c + gridDim.x, s ^ 1);
    }}
    uint32_t done = 0;
    while (!done)
      asm volatile("{{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n selp.u32 %0, 1, 0, p;\\n}}"
                   : "=r"(done)
                   : "r"(bar + 8 * s), "r"((k >> 1) & 1)
                   : "memory");
    const unsigned nf = min(kBulkF4, n4 - c * kBulkF4);
    for (unsigned i = threadIdx.x; i < nf; i += kStreamThreads) {{
      const float4 v = ring[s][i];
      ring[s][i] = make_float4(Op::map(v.x), Op::map(v.y), Op::map(v.z), Op::map(v.w));
    }}
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {{
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(out + c * kBulkF4),
                   "r"(static_cast<uint32_t>(__cvta_generic_to_shared(ring[s]))), "r"(nf * 16)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }}
  }}
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}}

"""
    launch = ("const unsigned chunks = (n4 + kBulkF4 - 1) / kBulkF4;\n"
              "    stream_bulk<Op><<<chunks < 132 ? chunks : 132, kStreamThreads, 0, st>>>(in, o, n4);")
    return [(_STREAM_ENTRY, kernel + _STREAM_ENTRY), (_LAUNCH, _variant_launch(launch))]


# the first design's launch: one float4 a thread in a 64-bit
# grid-stride loop, grid_for's 256-thread blocks, plain loads and stores
_FIRST_LAUNCH = [(_STREAM_ENTRY, """template <class Op>
__global__ void __launch_bounds__(kThreads)
first_design(const float4* __restrict__ a, float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const float4 v = a[i];
    out[i] = make_float4(Op::map(v.x), Op::map(v.y), Op::map(v.z), Op::map(v.w));
  }
}

""" + _STREAM_ENTRY), (_LAUNCH, _variant_launch("first_design<Op><<<grid_for(n4), kThreads, 0, st>>>(in, o, n4);"))]
_TANHF = [("return gelu_tanh_jvp(x);", "return gelu_tanh(x) + gelu_tanh_grad(x);")]
_STORE_CS = "    __stcs(out + i, make_float4(Op::map(v.x), Op::map(v.y), Op::map(v.z), Op::map(v.w)));"
# streaming cache hints: loads on the read-only path with no L1 allocation,
# or ld.global.cs (__ldcs), and evict-first stores (__stcs)
_NC_NO_ALLOCATE = [(_STREAM_BODY, """    float4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(a + i));
""" + _STORE_CS)]
_LDCS = [(_STREAM_BODY, "    const float4 v = __ldcs(a + i);\n" + _STORE_CS)]
_ACCURATE = [("struct GeluJvp {", """__device__ __forceinline__ float gelu_jvp_accurate(float x) {
  const float x2 = x * x;
  const float u = kSqrt2OverPi * (x + kGeluCubic * (x2 * x));
  const float e = expf(fminf(-2.0f * u, 88.0f));
  if (1.0f + e > 0x1p126f) return 0.0f;  // as gelu_tanh_jvp
  const float s = __frcp_rn(1.0f + e);
  const float es2 = (e * s) * s;
  return x * s + s + 2.0f * x * es2 * (kSqrt2OverPi * (1.0f + 3.0f * kGeluCubic * x2));
}

struct GeluJvp {"""), ("return gelu_tanh_jvp(x);", "return gelu_jvp_accurate(x);")]


# b1 unfolded: __expf of -2u (log2(e) multiplied in it) and the sum term by
# term, x s + s + 2x (e s) s sqrt(2/pi) (1 + 3 * 0.044715 x^2)
_UNFOLDED = [("struct GeluJvp {", """__device__ __forceinline__ float gelu_jvp_unfolded(float x) {
  const float x2 = x * x;
  const float u = kSqrt2OverPi * (x + kGeluCubic * (x2 * x));
  const float e = __expf(fminf(-2.0f * u, 88.0f));
  const float s = __fdividef(1.0f, 1.0f + e);
  return x * s + s + 2.0f * x * ((e * s) * s) * (kSqrt2OverPi * (1.0f + 3.0f * kGeluCubic * x2));
}

struct GeluJvp {"""), ("return gelu_tanh_jvp(x);", "return gelu_jvp_unfolded(x);")]


def _stream_variants(gelu: bool) -> dict:
    v = {"as built (one float4 a thread, 256 blocks at the bisect shape)": ([], False),
         "U = 2 float4s a thread (128 blocks)": (_unroll(2), False),
         "U = 4 (64 blocks)": (_unroll(4), False),
         "U = 8 (32 blocks)": (_unroll(8), False),
         "bulk-copy ring, 8 KB chunks": (_bulk_ring(8192), False),
         "bulk-copy ring, 4 KB chunks (2 a block)": (_bulk_ring(4096), False),
         "ld.global.nc.L1::no_allocate loads, __stcs stores": (_NC_NO_ALLOCATE, False),
         "__ldcs loads, __stcs stores": (_LDCS, False),
         "128 threads a block (512 blocks)": ([("constexpr int kStreamThreads = 256;",
                                                 "constexpr int kStreamThreads = 128;")], False),
         "the first design's launch (one float4 a thread, 256 blocks, 64-bit grid-stride loop)": (_FIRST_LAUNCH,
                                                                                                  False)}
    if gelu:
        v["tanhf twice (gelu_tanh + gelu_tanh_grad, the first design's arithmetic)"] = (_TANHF, False)
        v["the first design (its launch and its two tanhf)"] = (_FIRST_LAUNCH + _TANHF, False)
        v["expf and __frcp_rn, unfolded"] = (_ACCURATE, False)
        v["unfolded: __expf(-2u), x s + s + 2x (e s) s k (1 + 3c x^2)"] = (_UNFOLDED, False)
    return v


KERNELS = {
    "p3": ("probe_cellconv.cu", "se3_probe_masked_dist_product",
           [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
           {"as built": ([], False),
            "lo unrounded (the tensor cores read its top 19 bits)": (_LO_RAW, False),
            "32 x 64 tiles (a warp 16 x 64)": ([("constexpr int kMT = 2;", "constexpr int kMT = 1;"),
                                                ("constexpr int kNT = 4;", "constexpr int kNT = 8;")], False),
            "one product a tile (hi.hi)": (_ONE_PRODUCT, True),
            "no pne math": (_NO_PNE, True),
            "one product, no pne math": (_ONE_PRODUCT + _NO_PNE, True)}),
    "p11": ("probe_accum.cu", "se3_probe_grid_column_accum",
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
            {"as built (64 rows ahead)": ([], False),
             "32 rows ahead": ([(_AHEAD, "constexpr int kColAhead = 32;")], False),
             "128 rows ahead": ([(_AHEAD, "constexpr int kColAhead = 128;")], False)}),
    "stage": ("probe_stage_fwd.cu", "se3_probe_stage_fwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
              {"as built": ([], False),
               "feat and W steps not unrolled": (_NOT_UNROLLED, False),
               "pne split at each use": (_RAW_PNE, False),
               "W stages' ring of 3 slots": ([(_RING, _RING.replace("? 2 : 3", "? 3 : 3"))], False),
               "one product a tile (hi.hi)": (_HI_ONLY, True),
               "no W copies (W slots stale)": (_NO_W, True),
               "no aggregation products": (_NO_AGG_MMA, True),
               "no feat copies (feat slots stale)": (_NO_FEAT, True),
               "s2 / s3 store nothing": (_NO_STORES, True)}),
    "copy": ("probe_mosaic.cu", "se3_probe_strided_copy", [ctypes.c_void_p] + [ctypes.c_longlong] * 8
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
             {"as built (128 threads, 4 float4s each)": ([], False),
              "256 threads, 4 float4s each": ([_COPY_THREADS], False),
              "128 threads, 2 float4s each": ([_COPY_UNROLL2], False),
              "128 threads, 8 float4s each": ([_COPY_UNROLL8], False)}),
    "b4": ("probe_bwd_ops.cu", "se3_probe_rank3_accum", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
           {"as built (slabs of 8 gq: 64 blocks)": ([], False),
            "slabs of 4 gq (128 blocks)": ([(_SLAB, "const int gq_slab = 4;")], False),
            "slabs of 16 gq (32 blocks)": ([(_SLAB, "const int gq_slab = 16;")], False),
            "ring slots of 5 KB (8 pieces a row block)": ([("constexpr int kColSlot = 4096 + kColWave * kColGroup;",
                                                            "constexpr int kColSlot = 1024 + kColWave * kColGroup;")],
                                                          False),
            "no sums (the stores alone)": ([("for (int s0 = 0; s0 < S; s0 += kColWave) {",
                                             "for (int s0 = 0; s0 < 0; s0 += kColWave) {")], True),
            "no stores (the sums alone)": ([("reinterpret_cast<float4*>(row)[o4] = v4;",
                                             "if (v == 12345.f) reinterpret_cast<float4*>(row)[o4] = v4;")], True),
            "no row loads (sums of stale shared memory)": ([("if (h < ncols) cp_async16(", "if (h < 0) cp_async16(")],
                                                           True),
            "no adds (one value a row block)": ([("for (int r = 0; r < len; ++r) sum += p[r * kColGroup];",
                                                  "sum += p[0];")], True)}),
    "gather": ("probe_cellconv.cu", "se3_probe_block_gather",
               [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
               {"as built (128 threads a block)": ([], False),
                "64 threads a block": ([(_GATHER_THREADS, "const int block_threads = 64;")], False),
                "256 threads a block": ([(_GATHER_THREADS, "const int block_threads = 256;")], False),
                "8 loads ahead": ([("constexpr int kGatherAhead = 4;", "constexpr int kGatherAhead = 8;")], False),
                "no table loads (ids only)": ([("if (r0 + k < R) x[k] = __ldg(tab + id[k] * blk4 + j);",
                                                "if (r0 + k < R) x[k] = make_float4(id[k], 0.f, 0.f, 0.f);")],
                                              True)}),
    "b1": ("probe_bwd_ops.cu", "se3_probe_gelu_jvp", [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p],
           _stream_variants(True)),
    "b5": ("probe_bwd_ops.cu", "se3_probe_scale2", [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p],
           _stream_variants(False)),
}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_variants", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"probe_variants: the source has no {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(kernel: str, skip_diagnostics: bool = False) -> dict:
    """{variant: (C entry, ptxas lines of the kernel)}, every variant
    (but the diagnostic ones where ``skip_diagnostics``) compiled at once."""
    from se3conv3d_tpu_torch.kernels import build

    source, entry, argtypes, variants = KERNELS[kernel]
    if skip_diagnostics:
        variants = {k: v for k, v in variants.items() if not v[1]}
    csrc = build.SOURCES["probe_accum"].parent
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = (csrc / source).read_text()
    procs = {}
    for i, (name, (edits, _)) in enumerate(variants.items()):
        path = out_dir / f"{kernel}_{i}.cu"
        path.write_text(variant_source(base, edits))
        procs[name] = (path, subprocess.Popen([build._nvcc(), "-Xptxas=-v", *build.NVCC_FLAGS, "-I", str(csrc),
                                               "-o", str(path.with_suffix(".so")), str(path)],
                                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kern_name = {"p3": "masked_dist_product", "p11": "grid_column_accum", "stage": "stage_fwd",
                 "copy": "copy_", "b4": "colsum_broadcast", "gather": "block_gather", "b1": "GeluJvp",
                 "b5": "Scale2"}[kernel]
    built = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe_variants: {name!r} does not build:\n{log[-4000:]}")
        lines, on = [], False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                on = kern_name in line
            elif on and ("registers" in line or "spill" in line):
                lines.append(line.split(":", 1)[-1].strip())
                on = on and "registers" not in line
        fn = getattr(ctypes.CDLL(str(path.with_suffix(".so"))), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        built[name] = (fn, "; ".join(lines))
    return built


def p3_calls(dev):
    import torch
    from se3conv3d_tpu_torch.experiments import probe_cellconv as pc
    from se3conv3d_tpu_torch.kernels import cellconv_probes as cc

    x = pc.draw("p3", 462, dev)
    nq, nc, c = x["qp"].shape[0], x["cp"].shape[0], x["cf"].shape[1]
    pne_plain = cc.masked_dist_pne(x["qp"], x["cp"])
    ref = cc.masked_dist_product_reference(x["qp"], x["cp"], x["cf"])

    def call(fn, pne=None):
        out = torch.empty(nq, c, device=dev)
        err = fn(x["qp"].data_ptr(), x["qp"].shape[1], nq, x["cp"].data_ptr(), x["cp"].shape[1], nc,
                 x["cf"].data_ptr(), c, out.data_ptr(), None if pne is None else pne.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"probe_variants: CUDA error {err}")
        return out

    def check(fn):
        pne = torch.empty(nq, nc, device=dev)
        got = call(fn, pne)
        rel = float((got - ref).abs().max() / ref.abs().max())
        return rel <= pc.P3_RTOL and torch.equal(pne, pne_plain), f"pne bitwise {torch.equal(pne, pne_plain)}, " \
                                                                  f"product {rel:.3e} of max |plain|"

    return call, check, ("torch.matmul(pne, cf)", lambda: torch.matmul(pne_plain, x["cf"]))


def p11_calls(dev):
    import torch
    from se3conv3d_tpu_torch.experiments import probe_mosaic
    from se3conv3d_tpu_torch.kernels import probes

    (a,) = probe_mosaic.draw("p11_grid_accum", 440, dev)
    want = probes.grid_column_in_kernel_order(a)

    def call(fn):
        out = torch.empty(1, a.shape[1], device=dev)
        err = fn(a.data_ptr(), a.shape[0] // probes.TM, probes.TM, a.shape[1], out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"probe_variants: CUDA error {err}")
        return out

    def check(fn):
        same = torch.equal(call(fn), want)
        return same, f"bitwise the stated order: {same}"

    return call, check, ("torch.sum(a, 0)", lambda: torch.sum(a, 0))


def stage_calls(dev):
    import torch
    from se3conv3d_tpu_torch.experiments import bisect_fused as bf
    from se3conv3d_tpu_torch.kernels import probes

    geo, feat, proj, bias, w2 = bf.draw("s5_reduce", 464, dev)
    refs = {s: probes.stage_forward_reference(geo, feat, proj, w2, bias, s) for s in probes.STAGES}

    def call(fn, stage="reduce"):
        out = torch.empty(refs[stage].shape, device=dev)
        err = fn(geo.data_ptr(), feat.data_ptr(), proj.data_ptr(), bias.data_ptr(), w2.data_ptr(), None,
                 out.data_ptr(), None, None, 1, bf.MP, bf.GD, probes.STAGES[stage], 0, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"probe_variants: CUDA error {err}")
        return out

    def check(fn):
        errs = {s: float((call(fn, s) - r).abs().max() / r.abs().max()) for s, r in refs.items()}
        return max(errs.values()) <= bf.RTOL, "max |kernel - plain| / max |plain| " + ", ".join(
            f"{s} {e:.3e}" for s, e in errs.items())

    basis = torch.randn(bf.GQ, bf.MP, bf.C, device=dev)
    return call, check, ("s4-s6 weight product alone torch.bmm", lambda: torch.bmm(basis, w2))


def copy_calls(dev):
    import torch
    from se3conv3d_tpu_torch.experiments import probe_mosaic
    from se3conv3d_tpu_torch.kernels import mosaic_probes as mp

    views = {name: view(probe_mosaic.draw(name, 466, dev)[0]) for name, view in mp.COPY_VIEWS.items()}

    def call(fn, name="p5_lane_merge"):
        v = views[name]
        plan = mp.copy_plan(v.shape, v.stride(), mp._align(v.data_ptr()))
        out = torch.empty(v.shape, device=dev)
        err = fn(v.data_ptr(), *plan["dims"], *plan["strides"], mp.COPY_PATHS.index(plan["path"]), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"probe_variants: CUDA error {err}")
        return out

    def check(fn):
        same = {name: torch.equal(call(fn, name), v.contiguous()) for name, v in views.items()}
        return all(same.values()), f"bit for bit {same}"

    return call, check, ("p5 .contiguous()", lambda: views["p5_lane_merge"].clone())


def b4_calls(dev):
    import torch
    from se3conv3d_tpu_torch.experiments import bisect_fused as bf
    from se3conv3d_tpu_torch.kernels import probes

    (a,) = bf.draw("b4_rank3_accum", 468, dev)
    shape = (bf.GQ, a.shape[1], bf.O)
    want = probes.rank3_in_kernel_order(a, bf.TM)[None, :, None].expand(shape)

    def call(fn):
        out = torch.empty(shape, device=dev)
        err = fn(a.data_ptr(), out.data_ptr(), a.shape[0] // bf.TM, bf.TM, a.shape[1], bf.GQ, bf.O,
                 probes.rank3_accum_plan(a.shape[1], bf.GQ)["slab"], torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"probe_variants: CUDA error {err}")
        return out

    def check(fn):
        same = torch.equal(call(fn), want)
        return same, f"bitwise the row-order, block-order sum: {same}"

    yardstick = load_smoke().BISECT_YARDSTICK["b4_rank3_accum"]
    return call, check, ("b4 yardstick (torch.sum, a copy)", lambda: yardstick(a, *shape))


def gather_calls(dev):
    import torch
    from se3conv3d_tpu_torch.experiments import probe_cellconv as pc
    from se3conv3d_tpu_torch.kernels import cellconv_probes as cc

    xs = {part: pc.draw(part, 470 + i, dev) for i, part in enumerate(("p1", "p2", "p4"))}

    def call(fn, part="p2"):
        x = xs[part]
        tab = x["tab"] if "tab" in x else x["g"]
        ids = x["ids"]
        nq, r = ids.shape[0], 1 if ids.dim() == 1 else ids.shape[1]
        block = pc.P * pc.C
        out = torch.empty(nq * pc.P, pc.C, device=dev)
        err = fn(ids.data_ptr(), nq, r, tab.data_ptr(), tab.shape[0] // pc.P, block, int(part == "p1"),
                 cc.GATHER_SCALE, cc.gather_plan(nq, block)["threads"], out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"probe_variants: CUDA error {err}")
        return out

    def check(fn):
        same = {part: torch.equal(call(fn, part), pc.reference(part, x)) for part, x in xs.items()}
        return all(same.values()), f"bit for bit {same}"

    out = pc.reference("p4", xs["p4"])
    return call, check, ("p4 clone of the output", lambda: out.clone())


def stream_calls(kernel: str):
    """b1 or b5 at the bisect draw, through the C entry with the plan's U."""
    def make(dev):
        import torch
        import torch.nn.functional as F
        from se3conv3d_tpu_torch.experiments import bisect_fused as bf
        from se3conv3d_tpu_torch.kernels import probes

        (a,) = bf.draw({"b1": "b1_jvp_gelu", "b5": "b5_merge_back"}[kernel], 472, dev)
        smoke = load_smoke()
        sweep = smoke.gelu_jvp_sweep(dev)

        def call(fn, x=a):
            out = torch.empty(x.shape, device=dev)
            err = fn(x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"probe_variants: CUDA error {err}")
            return out

        if kernel == "b5":
            def check(fn):
                same = torch.equal(call(fn).view(torch.int32), (a * 2.0).view(torch.int32))
                return same, f"bit for bit 2a: {same}"

            return call, check, ("torch.mul(a, 2.0)", lambda: torch.mul(a, 2.0))

        ref = probes.gelu_jvp_reference(a)

        def check(fn):
            rel = float((call(fn) - ref).abs().max() / ref.abs().max())
            sweep_err = smoke.gelu_jvp_sweep_error(call(fn, sweep), sweep)
            return rel <= bf.RTOL, (f"{rel:.3e} of max |plain| (bound {bf.RTOL:g}); over the sweep {sweep_err:.3e} "
                                    f"of 1 + |ref| (bound {smoke.GELU_JVP_SWEEP_RTOL:g}, within: "
                                    f"{sweep_err <= smoke.GELU_JVP_SWEEP_RTOL})")

        return call, check, ('F.gelu(a, approximate="tanh")', lambda: F.gelu(a, approximate="tanh"))

    return make


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--skip-diagnostics", action="store_true", help="time only the variants that keep the result")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    sys.path.insert(0, str(HERE))
    from probe_ab import floor_graph_ms

    graph_ms = floor_graph_ms(smoke.graph_ms)
    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    built = build_variants(a.kernel, a.skip_diagnostics)
    dev, side = torch.device("cuda"), torch.cuda.Stream()
    call, check, (lib_name, lib) = {"p3": p3_calls, "p11": p11_calls, "stage": stage_calls, "copy": copy_calls,
                                    "b4": b4_calls, "gather": gather_calls, "b1": stream_calls("b1"),
                                    "b5": stream_calls("b5")}[a.kernel](dev)
    diagnostic = {name: d for name, (_, d) in KERNELS[a.kernel][3].items()}
    for name, (fn, ptxas) in built.items():
        ok, what = check(fn)
        torch.cuda.synchronize()
        print(f"{name}: {ptxas}; {what}" + (" (diagnostic)" if diagnostic[name] else ""), flush=True)
        if not ok and not diagnostic[name]:
            raise SystemExit(f"probe_variants: {name!r} disagrees with the plain version")
    from se3conv3d_tpu_torch.kernels import mosaic_probes

    stages = {"stage": ["pne", "agg", "swap", "wcontract", "reduce"],
              "copy": list(mosaic_probes.COPY_VIEWS), "gather": ["p1", "p2", "p4"]}.get(a.kernel, [None])
    names = [(name, st) for name in built for st in stages]
    label = lambda name, st: name if st is None else f"{name} [{st}]"  # noqa: E731
    ms = {label(*n): [] for n in names}
    ms[lib_name] = []
    for r in range(a.rounds):
        for name, st in (names if r % 2 == 0 else names[::-1]):
            run = (lambda fn=built[name][0]: call(fn)) if st is None else (lambda fn=built[name][0], st=st: call(fn, st))
            ms[label(name, st)].append(graph_ms(run, side))
        ms[lib_name].append(graph_ms(lib, side))
    for name, v in ms.items():
        print(f"{name:55s} median {statistics.median(v):.5f} ms, range {min(v):.5f}-{max(v):.5f} [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
