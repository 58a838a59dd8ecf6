// The five backward building blocks of the fused-forward bisection, for
// NVIDIA Hopper (sm_90a), float32:
//
//   b1 (stream_map<GeluJvp>): out = gelu(a) + gelu'(a), tanh GELU  a [R, GQ]
//   b2 (expand_groups): out[g*Q + q, t, o] = a[g, t, o]           a [G, TM, O]
//   b3 (batched_contract): out[gq, c, o] = sum_m a[gq, m, c] * b[gq, m, o]
//   b4 (colsum_broadcast): out[gq, c, o] = sum_m a[m, c]
//   b5 (stream_map<Scale2>): out = 2 * a, [TM, E, GQ] read as [TM*E, GQ]
//
// Replace the TPU Pallas kernels of experiments/bisect_fused.py: b1_jvp_gelu
// (:218), b2_gexp (:232), b3_dw2_contract11 (:249), b4_rank3_accum (:265)
// and b5_merge_back (:283), each one pl.pallas_call that checked whether
// Mosaic lowered a pattern of the fused backward (jvp of GELU, the
// out-frame broadcast, the d_w contraction over rows, an output revisited
// by every grid step, the merge of the edge axis).  See
// se3conv3d_tpu_torch/kernels/probes.py for the wrappers and the plain
// PyTorch versions.
//
// What bounds them: bytes for b1, b2, b4 and b5 (b1 an exponential per
// value, the rest copies and adds); b3 is 2*GQ*C*O*R FLOPs (67 MFLOP at GQ = C = O =
// 64, R = 128) over 4 MiB of operands, so bytes too on tensor cores: each
// block takes one 32 x 32 quadrant of one gq's output (256 blocks at GQ =
// 64, against 132 SMs), stages 32-row slices of its operand columns in
// shared memory with cp.async (double-buffered; rows padded to 40 floats,
// so that the fragment reads hit 32 banks) and runs the product on
// mma.sync in the port's 3xTF32 form, each 8-deep slice summed into a
// zeroed tile and added by a rounded float32 add.  No sum crosses blocks:
// two calls give the same bits.
//
// b4 runs on the TPU as a sequential grid whose output block every step
// revisits: each step adds a block of `rows` rows' column sums into it, so
// the sums run block by block in row order and the block sums in block
// order from zero.  Hopper blocks run in parallel; the TPU's order is kept
// bit for bit, so each column's chain of adds stays sequential (rows adds
// for a block's sum, then S adds for the total).  What bounds it is bytes
// (256 KB read and 1 MiB written at the bisect shape: 0.4 us) and a
// launch's latency; the chains' adds (128 + 8 dependent adds, ~0.3 us) come
// next.  One launch, colsum_broadcast, no scratch: block (x, y) takes the
// 8 columns 8x .. 8x + 7 (a narrower last group where C % 8 != 0) and the
// gq slabs y, y + gridDim.y, ... (probes.rank3_accum_plan: 8 groups x 8
// slabs of 8 gq = 64 blocks at the bisect shape).  Its 256 threads stage
// the columns' strip into a ring of 2 shared-memory slots by cp.async
// (16-byte copies where C % 4 == 0; at the bisect shape the whole 32 KB
// strip in two pieces, both in flight at once), a warp a row block; thread
// (k, c) adds row block k's column c in row order, 32 row blocks at a
// time, and the first 8 threads add the block sums in block order.  Every
// block that takes a column runs the same chain, so every slab holds the
// same bits.  The stores: 16 threads a row (gq, c) of O values, float4
// where O % 4 == 0 (a warp writes 512 contiguous bytes at O = 64), no
// division per element.  Each block reads its columns over every row, so
// more slabs read the strip again: 64 blocks beat 128 and 256
// (probe_variants.py b4), and sharing the sums over a cluster of 8 blocks
// through distributed shared memory was no faster at this shape (PERF.md
// section 6).
//
// b1 (b1_jvp_gelu, :218) and b5 (b5_merge_back, :283) are one streaming
// kernel, stream_map<Op>, over a contiguous [4096, 64] float32 array at the
// bisect shape: 1 MiB read and 1 MiB written, 0.63 us at 3.35 TB/s, plus a
// launch, which at this size is most of the time.  The first design gave
// each thread one float4 in a 64-bit grid-stride loop (256 blocks of 256
// threads here), and b1 the cubic and an accurate tanhf, which takes two
// paths by |u|, in both gelu_tanh and gelu_tanh_grad (nvcc merged the two
// into one exponential a value).  Timed in CUDA graphs long enough to hide
// a replay's fixed cost, both were already near a launch's floor, ~1.8 us
// a call as torch.mul and F.gelu are.  Now each thread maps one float4,
// with 32-bit indices and a masked tail, no loop: one wave of 256 blocks
// here.  More float4s a thread (2, 4 or 8, every load issued first), a
// ring of cp.async.bulk copies, and streaming cache hints on the loads and
// stores each read level or slower (probe_variants.py b1 / b5, PERF.md
// section 6).  b1 is gelu_tanh_jvp (probe_common.cuh): one ex2.approx and
// one fast division a value, no branch, within 2.0e-7 (1 + |ref|) of
// float64 over [-20, 20] and +-1e4 where the two tanhf gave 6.2e-7, and 3%
// under them a call.  b5 is 2 v, exact, so its output is bit for bit 2a.

#include <stdint.h>

#include "fused_equiv_common.cuh"
#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 4096;

inline unsigned grid_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b < kMaxGrid ? b : kMaxGrid));
}

// b1 and b5: one streaming kernel for an elementwise map of float4s, one
// float4 a thread, 32-bit indices (the C entry refuses n / 4 >= 2^31), the
// tail masked, no grid-stride loop.
constexpr int kStreamThreads = 256;

struct GeluJvp {  // b1
  __device__ __forceinline__ static float map(float x) { return gelu_tanh_jvp(x); }
};
struct Scale2 {  // b5: exact in float32
  __device__ __forceinline__ static float map(float x) { return 2.f * x; }
};

template <class Op>
__global__ void __launch_bounds__(kStreamThreads)
stream_map(const float4* __restrict__ a, float4* __restrict__ out, unsigned n4) {
  const unsigned i = blockIdx.x * static_cast<unsigned>(kStreamThreads) + threadIdx.x;
  if (i < n4) {
    const float4 v = a[i];
    out[i] = make_float4(Op::map(v.x), Op::map(v.y), Op::map(v.z), Op::map(v.w));
  }
}

// out [G*Q, inner4] float4 = a [G, inner4] float4, row gq from row gq / Q
__global__ void __launch_bounds__(kThreads)
expand_groups(const float4* __restrict__ a, float4* __restrict__ out, int Q, long long inner4,
              long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long gq = i / inner4;
    out[i] = a[(gq / Q) * inner4 + (i - gq * inner4)];
  }
}

// b3 on tensor cores: block (quadrant x, gq y) owns out[gq][c0 .. c0+31][o0 ..
// o0+31] = a[gq]^T . b[gq]; warp w of 4 the 16 x 16 at c0 + 16 (w / 2), o0 +
// 16 (w % 2) as two m16n8k8 tiles.  Operand slices [32 rows][32 columns],
// columns past C or O and rows past R zero-filled.
constexpr int kB3Tile = 32, kB3Depth = 32, kB3Threads = 128, kB3Stride = kB3Tile + 8;

__device__ __forceinline__ void b3_slice(float (*s)[kB3Stride], const float* __restrict__ x, int R, int W,
                                         int col0, int r0, int tid) {
  for (int i = tid; i < kB3Depth * kB3Tile / 4; i += kB3Threads) {
    const int r = i / (kB3Tile / 4), c = (i % (kB3Tile / 4)) * 4;
    const bool in = r0 + r < R && col0 + c < W;
    cp_async16(&s[r][c], in ? x + static_cast<long long>(r0 + r) * W + col0 + c : x, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kB3Threads)
batched_contract(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out, int R,
                 int C, int O, int tiles_o) {
  __shared__ __align__(16) float as[2][kB3Depth][kB3Stride], bs[2][kB3Depth][kB3Stride];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int gq = blockIdx.y, c0 = (blockIdx.x / tiles_o) * kB3Tile, o0 = (blockIdx.x % tiles_o) * kB3Tile;
  const float* ag = a + static_cast<long long>(gq) * R * C;
  const float* bg = b + static_cast<long long>(gq) * R * O;
  const int mc = 16 * (warp >> 1), no = 16 * (warp & 1);
  float acc[2][4] = {};
  const int slices = (R + kB3Depth - 1) / kB3Depth;
  b3_slice(as[0], ag, R, C, c0, 0, tid);
  b3_slice(bs[0], bg, R, O, o0, 0, tid);
  for (int sl = 0; sl < slices; ++sl) {
    const int cur = sl & 1;
    if (sl + 1 < slices) {
      b3_slice(as[cur ^ 1], ag, R, C, c0, (sl + 1) * kB3Depth, tid);
      b3_slice(bs[cur ^ 1], bg, R, O, o0, (sl + 1) * kB3Depth, tid);
      asm volatile("cp.async.wait_group 2;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kB3Depth; k0 += 8) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int v = 0; v < 4; ++v)  // A = a^T: A[c][r] = as[r][c]
        split_tf32(as[cur][k0 + tig + 4 * (v >> 1)][mc + gid + 8 * (v & 1)], ah[v], al[v]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int v = 0; v < 2; ++v) split_tf32(bs[cur][k0 + tig + 4 * v][no + 8 * n + gid], bh[v], bl[v]);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, al, bh);
        mma_tf32(part, ah, bl);
        mma_tf32(part, ah, bh);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[n][v] += part[v];
      }
    }
    __syncthreads();  // the next slice's copies overwrite this buffer
  }
  float* og = out + static_cast<long long>(gq) * C * O;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + mc + gid + 8 * (v >> 1), o = o0 + no + 8 * n + 2 * tig + (v & 1);
      if (c < C && o < O) og[static_cast<long long>(c) * O + o] = acc[n][v];
    }
}

// colsum_broadcast: columns a block sums; threads; row blocks summed at
// once (a thread each column); a ring slot's floats (16 KB of rows, plus 8
// floats of padding a row block); threads a row of the stores
constexpr int kColGroup = 8;
constexpr int kColThreads = 256;
constexpr int kColWave = kColThreads / kColGroup;
constexpr int kColSlot = 4096 + kColWave * kColGroup;
constexpr int kColStoreLanes = 16;

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// out[gq, c, o] = ((0 + p_0[c]) + p_1[c]) + ... + p_{S-1}[c] for the
// block's columns c and gq slabs, p_s[c] = ((0 + a[s rows, c]) + a[s rows
// + 1, c]) + ... over row block s.  vec_loads: C % 4 == 0 and a 16-byte
// aligned; vec_stores: O % 4 == 0 and out 16-byte aligned.
__global__ void __launch_bounds__(kColThreads)
colsum_broadcast(const float* __restrict__ a, int S, int rows, int C, int GQ, int O, int slab, bool vec_loads,
                 bool vec_stores, float* __restrict__ out) {
  __shared__ __align__(16) float ring[2 * kColSlot];
  __shared__ float part[kColWave][kColGroup];
  __shared__ float total[kColGroup];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chain = tid / kColGroup, cl = tid % kColGroup;
  const int c0 = blockIdx.x * kColGroup, ncols = min(kColGroup, C - c0);
  float run = 0.f;  // threads tid < ncols: column c0 + tid, the block sums added in order
  for (int s0 = 0; s0 < S; s0 += kColWave) {
    const int n = min(kColWave, S - s0);
    // rows a row block stages at once: what a slot holds, in equal pieces;
    // a row block's stride in a slot is 8 floats past a multiple of 32, so
    // the 4 row blocks of a warp read 32 banks
    const int fit = 4 * ((kColSlot / n - kColGroup) / 32);
    const int pieces = (rows + fit - 1) / fit, sub = (rows + pieces - 1) / pieces;
    const int stride = 32 * ((sub + 3) / 4) + kColGroup;
    auto stage = [&](int t) {
      float* slot = ring + (t & 1) * kColSlot;
      const int r0 = t * sub, len = min(sub, rows - r0);
      for (int k = warp; k < n; k += kColThreads / 32) {
        const float* src = a + (static_cast<long long>(s0 + k) * rows + r0) * C + c0;
        float* dst = slot + k * stride;
        if (vec_loads) {
          for (int q = lane; q < 2 * len; q += 32) {
            const int r = q >> 1, h = 4 * (q & 1);
            if (h < ncols) cp_async16(dst + r * kColGroup + h, src + static_cast<long long>(r) * C + h, 16);
          }
        } else {
          for (int q = lane; q < kColGroup * len; q += 32) {
            const int r = q / kColGroup, c = q % kColGroup;
            if (c < ncols) cp_async4(dst + r * kColGroup + c, src + static_cast<long long>(r) * C + c, 4);
          }
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    float sum = 0.f;
    stage(0);
    for (int t = 0; t < pieces; ++t) {
      if (t + 1 < pieces) {
        stage(t + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();  // piece t landed in slot t & 1
      if (chain < n && cl < ncols) {
        const float* p = ring + (t & 1) * kColSlot + chain * stride + cl;
        const int len = min(sub, rows - t * sub);
#pragma unroll 8
        for (int r = 0; r < len; ++r) sum += p[r * kColGroup];
      }
      __syncthreads();  // slot t & 1 is free for piece t + 2
    }
    if (chain < n && cl < ncols) part[chain][cl] = sum;
    __syncthreads();
    if (tid < ncols)
      for (int k = 0; k < n; ++k) run += part[k][tid];
    __syncthreads();  // part is rewritten by the next wave
  }
  if (tid < ncols) total[tid] = run;
  __syncthreads();
  // the stores: lane x of row (gq, c) = (g0 + rr / 8, c0 + rr % 8) for rr = y, y + 16, ...
  const int x = tid % kColStoreLanes, y = tid / kColStoreLanes;
  for (int g0 = blockIdx.y * slab; g0 < GQ; g0 += gridDim.y * slab) {
    const int nrows = min(slab, GQ - g0) * kColGroup;
    for (int rr = y; rr < nrows; rr += kColThreads / kColStoreLanes) {
      const int c = rr % kColGroup;
      if (c >= ncols) continue;
      const float v = total[c];
      float* row = out + (static_cast<long long>(g0 + rr / kColGroup) * C + c0 + c) * O;
      if (vec_stores) {
        const float4 v4 = make_float4(v, v, v, v);
        for (int o4 = x; o4 < O / 4; o4 += kColStoreLanes) reinterpret_cast<float4*>(row)[o4] = v4;
      } else {
        for (int o = x; o < O; o += kColStoreLanes) row[o] = v;
      }
    }
  }
}

// stream_map's launch: n floats (a positive multiple of 4, n / 4 < 2^31),
// a and out 16-byte aligned
template <class Op>
int stream_launch(const void* a, void* out, long long n, void* stream_ptr) {
  if (n < 4 || n % 4 != 0 || n / 4 >= (1LL << 31) || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned n4 = static_cast<unsigned>(n / 4);
  const float4* in = static_cast<const float4*>(a);
  float4* o = static_cast<float4*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  stream_map<Op><<<(n4 + kStreamThreads - 1) / kStreamThreads, kStreamThreads, 0, st>>>(in, o, n4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every array below is float32, contiguous and 16-byte aligned; element
// counts and the inner widths are multiples of 4.

// b1 and b5 (stream_launch): a [n], out [n]
extern "C" int se3_probe_gelu_jvp(const void* a, void* out, long long n, void* stream_ptr) {
  return stream_launch<GeluJvp>(a, out, n, stream_ptr);
}

extern "C" int se3_probe_scale2(const void* a, void* out, long long n, void* stream_ptr) {
  return stream_launch<Scale2>(a, out, n, stream_ptr);
}

// registers, local bytes and shared memory (kernel_attrs) of
// stream_map<GeluJvp> (which 0) or stream_map<Scale2> (which 1)
extern "C" int se3_probe_stream_attrs(int which, int* attrs) {
  if (which == 0) return kernel_attrs(stream_map<GeluJvp>, 0, attrs);
  if (which == 1) return kernel_attrs(stream_map<Scale2>, 0, attrs);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a [G, inner], out [G*Q, inner]
extern "C" int se3_probe_expand_groups(const void* a, void* out, int G, int Q, long long inner,
                                       void* stream_ptr) {
  if (inner % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = static_cast<long long>(G) * Q * inner / 4;
  expand_groups<<<grid_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float4*>(a), static_cast<float4*>(out), Q, inner / 4, n4);
  return static_cast<int>(cudaGetLastError());
}

// a [GQ, R, C], b [GQ, R, O], out [GQ, C, O]
extern "C" int se3_probe_batched_contract(const void* a, const void* b, void* out, int GQ, int R,
                                          int C, int O, void* stream_ptr) {
  if (C % 4 != 0 || O % 4 != 0 || GQ < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_c = (C + kB3Tile - 1) / kB3Tile, tiles_o = (O + kB3Tile - 1) / kB3Tile;
  batched_contract<<<dim3(tiles_c * tiles_o, GQ), kB3Threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), R, C, O, tiles_o);
  return static_cast<int>(cudaGetLastError());
}

// a [S*rows, C], out [GQ, C, O]; slab: gq a block (probes.rank3_accum_plan,
// whose grid this is)
extern "C" int se3_probe_rank3_accum(const void* a, void* out, int S, int rows, int C, int GQ, int O, int slab,
                                     void* stream_ptr) {
  if (S < 1 || rows < 1 || C < 1 || GQ < 1 || O < 1 || slab < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int gq_slab = slab;
  const int groups = (C + kColGroup - 1) / kColGroup, slabs = (GQ + gq_slab - 1) / gq_slab;
  const dim3 grid(groups, slabs < 65535 ? slabs : 65535);
  colsum_broadcast<<<grid, kColThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(a), S, rows, C, GQ, O, gq_slab, C % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0,
      O % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
