// Accumulation into outputs that every block of a grid revisits, for NVIDIA
// Hopper (sm_90a), float32:
//
//   block_total_accum:  out_k[...] = sum of every value of a, for 0-3
//                       outputs k, and dfeat = 2a where asked
//   grid_column_accum:  out[c] = sum over the row blocks s, in order, of
//                       the block's column sum over its rows r
//
// Replace the TPU Pallas kernels of experiments/bisect_accum.py:46 (kernel k,
// :15, of trial(name, grid_n, n_accum, with_dfeat): a grid of grid_n blocks
// of a [128, 32, 64] that adds each block's total into d_proj [18, 64],
// d_bias [1, 64] and dW2 [64, 64, 64], all zeroed at step 0, and writes
// dfeat = 2a), experiments/bisect_accum2.py:40 (the same, each output
// += sum(block), one combination of the three at a time) and
// experiments/probe_mosaic.py:218 (p11_grid_accum: the column sum of
// [1024, 32] over 8 blocks of 128 rows into one revisited [1, 32]).  Each
// checked whether Mosaic lowered an output block that every grid step
// revisits.  See se3conv3d_tpu_torch/kernels/probes.py for the wrappers and
// the plain PyTorch versions.
//
// What bounds them: bytes.  block_total_accum at grid 64 reads a (67.1 MB)
// once and writes dfeat (67.1 MB) and the three outputs (1.1 MB): 0.041 ms
// at 3.35 TB/s, 0.020 ms without dfeat.  grid_column_accum moves 128 KB and
// is bound by launch latency.  On the TPU the grid ran in order, so the
// revisited output carried a running sum; Hopper blocks run in parallel, in
// no order.  So, as probe_bwd_ops.cu's b4: one pass reads each value once
// with 16-byte loads (and writes 2a in the same pass), each block of 256
// threads summing a chunk of kChunk values into one partial; a second pass
// adds the partials in a fixed order (sum_partials' order: thread t the
// partials t, t + 256, ..., then block_sum) in every block and broadcasts
// the total into the outputs.  No atomics: two calls give the same bits.
// The column form keeps the TPU's order exactly: each block sums its rows
// column by column in row order, and sum_rows_ordered adds the blocks'
// rows in block order from zero, as the grid's += did.

#include <stdint.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;
// values a block of chunk_totals sums: 16 float4 loads a thread
constexpr int kChunk = 16384;
constexpr int kMaxOuts = 3;

// part[b] = the sum of a's b-th chunk of kChunk values (the last may be
// short): each thread its float4s in order, then block_sum; dfeat, where
// not null, = 2a.
__global__ void __launch_bounds__(kThreads)
chunk_totals(const float4* __restrict__ a, long long n4, float4* __restrict__ dfeat,
             float* __restrict__ part) {
  __shared__ float red[32];
  const long long base = static_cast<long long>(blockIdx.x) * (kChunk / 4);
  float s = 0.f;
#pragma unroll 4
  for (int u = 0; u < kChunk / 4 / kThreads; ++u) {
    const long long i = base + u * kThreads + threadIdx.x;
    if (i < n4) {
      const float4 v = __ldcs(a + i);
      if (dfeat != nullptr) __stcs(dfeat + i, make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w));
      s += (v.x + v.y) + (v.z + v.w);
    }
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

struct Outs {
  float* ptr[kMaxOuts];
  long long n[kMaxOuts];
};

// every element of every output = the sum of part[0..P) in a fixed order,
// the same in every block
__global__ void __launch_bounds__(kThreads)
broadcast_total(const float* __restrict__ part, int P, Outs outs, long long n_all) {
  __shared__ float red[32];
  __shared__ float total;
  float s = 0.f;
  for (int p = threadIdx.x; p < P; p += kThreads) s += part[p];
  s = block_sum(s, red);
  if (threadIdx.x == 0) total = s;
  __syncthreads();
  const float t = total;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n_all;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    // the output that element i falls in, by selects (an index into the
    // parameter struct would copy it to local memory)
    if (i < outs.n[0])
      outs.ptr[0][i] = t;
    else if (i < outs.n[0] + outs.n[1])
      outs.ptr[1][i - outs.n[0]] = t;
    else
      outs.ptr[2][i - outs.n[0] - outs.n[1]] = t;
  }
}

// part[s, c] = sum of a[r, c] over block s's rows r in [s*rows, (s+1)*rows), in row order
__global__ void __launch_bounds__(kThreads)
block_column_sums(const float* __restrict__ a, int rows, int C, float* __restrict__ part) {
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += a[(r0 + r) * C + c];
    part[static_cast<long long>(blockIdx.x) * C + c] = s;
  }
}

inline unsigned blocks_for(long long n, long long per_block, long long cap) {
  const long long b = (n + per_block - 1) / per_block;
  return static_cast<unsigned>(b < 1 ? 1 : (b < cap ? b : cap));
}

}  // namespace

// Partials block_total_accum needs for n values: part holds this many floats.
extern "C" long long se3_probe_accum_parts(long long n) { return (n + kChunk - 1) / kChunk; }

// a [n] float32, 16-byte aligned, n a multiple of 4; dfeat [n] or null;
// part [se3_probe_accum_parts(n)] scratch; out_k [n_k] for k < 3, null
// with n_k = 0 where absent.
extern "C" int se3_probe_block_total_accum(const void* a, long long n, void* dfeat, void* part,
                                           void* out0, long long n0, void* out1, long long n1,
                                           void* out2, long long n2, void* stream_ptr) {
  if (n < 4 || n % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dfeat) % 16 != 0 || n0 < 0 || n1 < 0 || n2 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long parts = se3_probe_accum_parts(n);
  if (parts > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  chunk_totals<<<static_cast<unsigned>(parts), kThreads, 0, stream>>>(
      static_cast<const float4*>(a), n / 4, static_cast<float4*>(dfeat), p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_all = n0 + n1 + n2;
  if (n_all == 0) return 0;
  Outs outs{{static_cast<float*>(out0), static_cast<float*>(out1), static_cast<float*>(out2)}, {n0, n1, n2}};
  broadcast_total<<<blocks_for(n_all, 4LL * kThreads, 1024), kThreads, 0, stream>>>(
      p, static_cast<int>(parts), outs, n_all);
  return static_cast<int>(cudaGetLastError());
}

// a [S*rows, C] float32, part [S, C] scratch, out [C]
extern "C" int se3_probe_grid_column_accum(const void* a, int S, int rows, int C, void* part, void* out,
                                           void* stream_ptr) {
  if (S < 1 || rows < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* p = static_cast<float*>(part);
  block_column_sums<<<S, kThreads, 0, stream>>>(static_cast<const float*>(a), rows, C, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_ordered<<<blocks_for(C, kPartThreads, 1 << 30), kPartThreads, 0, stream>>>(
      p, S, C, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// attrs[0..3] of kernel `which`: 0 chunk_totals, 1 broadcast_total,
// 2 block_column_sums, 3 sum_rows_ordered (probe_common.cuh: kernel_attrs).
extern "C" int se3_probe_accum_attrs(int which, int* attrs) {
  switch (which) {
    case 0: return kernel_attrs(chunk_totals, 0, attrs);
    case 1: return kernel_attrs(broadcast_total, 0, attrs);
    case 2: return kernel_attrs(block_column_sums, 0, attrs);
    case 3: return kernel_attrs(sum_rows_ordered, 0, attrs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
