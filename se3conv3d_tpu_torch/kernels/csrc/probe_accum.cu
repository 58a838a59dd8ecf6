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
// revisits.  See se3conv3d_tpu_torch/kernels/probes.py for the wrappers, the
// plain PyTorch versions, the share plan (accum_plan) and the kernels'
// summation orders written out in PyTorch (block_total_in_kernel_order,
// grid_column_in_kernel_order).
//
// What bounds them: bytes.  block_total_accum at grid 64 reads a (67.1 MB)
// once and writes dfeat (67.1 MB) and the three outputs (1.1 MB): 0.040 ms
// at 3.35 TB/s, 0.020 ms without dfeat.  grid_column_accum moves 128 KB
// (0.04 us at 3.35 TB/s) and is bound by launch latency, about 2 us, so it
// is one launch of one block with no scratch in device memory.  On the TPU
// the grid ran in order, so the revisited output carried a running sum;
// Hopper blocks run in parallel, in no order.
//
// block_total_accum is one pass in one launch: a persistent grid
// of as many blocks as fit the card at once (at most kMaxBlocksPerSM an SM,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor), launched cooperatively.
// Each block streams one contiguous share of a, each thread kUnroll
// 16-byte loads in flight (the bounds test out of the main loop), writes
// 2a with streaming stores in the same pass, and sums its values into one
// float32 run (at most a few hundred values), then the block's runs by a
// fixed tree (block_sum) into its partial.  One grid-wide step
// (cooperative_groups' grid.sync) follows; then every block adds all the
// partials in the same fixed order (thread t the partials t, t + 512, ...,
// then block_sum), so each gets the same bits of the total, and writes its
// share of the outputs.  No atomics on data, no counter of our own: two
// calls give the same bits.  The cooperative launch was kept over a
// programmatic dependent pair (a second kernel waiting in
// cudaGridDependencySynchronize) because it is one launch and captures into
// a CUDA graph (chip_smoke.graph_ms times through one).
//
// grid_column_accum keeps the TPU's order exactly: each block of TM rows
// summed column by column in row order from zero, then the block sums added
// in block order from zero, as the grid's += did.  One block of 8 warps:
// warp w takes the (row block, 32 columns) items w, w + 8, ..., lane c
// column c of the item, its loads issued 64 rows ahead into registers (a
// row's slot refilled with the row 64 further on as soon as it is added)
// while the adds run in row order; the block sums go to shared memory
// [S][C], and thread c adds column c's in block order.  The wrapper takes every [S*TM, C] whose
// S*C block sums fit the block's shared memory.

#include <stdint.h>

#include "probe_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

// block_total_accum: threads a block, float4 loads a thread in flight,
// blocks an SM at most (every block reads every partial after the grid
// step, so the grid stays a few hundred blocks)
constexpr int kAccThreads = 512;
constexpr int kUnroll = 8;
constexpr int kMaxBlocksPerSM = 2;
constexpr int kMaxOuts = 3;
// grid_column_accum: threads of its one block, rows a lane loads ahead,
// shared memory the block's partials may take (an H100's 227 KB)
constexpr int kColThreads = 256;
constexpr int kColAhead = 64;
constexpr int kColMaxSmem = 232448;

struct Outs {
  float* ptr[kMaxOuts];
  long long n[kMaxOuts];
};

__device__ __forceinline__ float quad_sum(float4 v) { return (v.x + v.y) + (v.z + v.w); }

// Every element of outs[k] = t: float4 stores where the output's length
// allows, this block's share of a grid-strided walk.
__device__ __forceinline__ void fill_output(float* o, long long n, float t) {
  const long long n4 = n / 4, stride = static_cast<long long>(gridDim.x) * kAccThreads;
  const float4 t4 = make_float4(t, t, t, t);
  for (long long j = blockIdx.x * static_cast<long long>(kAccThreads) + threadIdx.x; j < n4; j += stride)
    reinterpret_cast<float4*>(o)[j] = t4;
  for (long long j = 4 * n4 + blockIdx.x * static_cast<long long>(kAccThreads) + threadIdx.x; j < n; j += stride)
    o[j] = t;
}

// Block b sums a's float4s [b*per, (b+1)*per) (clipped to n4): thread t the
// float4s b*per + t + j*kAccThreads, j = 0, 1, ..., into one run s +=
// (x + y) + (z + w), then block_sum into part[b]; dfeat = 2a on the way.
// Rounds of kUnroll loads a thread, all issued before the first is used;
// the bounds test only in the last, partial round.
// After grid.sync every block adds part[0..gridDim.x) in a fixed order and
// fills the outputs (skipped, with the grid step, where there are none).
template <bool kDfeat>
__global__ void __launch_bounds__(kAccThreads)
block_total_accum(const float4* __restrict__ a, long long n4, long long per, float4* __restrict__ dfeat,
                  float* __restrict__ part, Outs outs) {
  __shared__ float red[32];
  __shared__ float total;
  const long long beg = min(n4, blockIdx.x * per), end = min(n4, beg + per);
  float s = 0.f;
  long long i = beg + threadIdx.x;
  for (; i + (kUnroll - 1) * kAccThreads < end; i += kUnroll * kAccThreads) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(a + i + u * kAccThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kDfeat)
        __stcs(dfeat + i + u * kAccThreads, make_float4(2.f * v[u].x, 2.f * v[u].y, 2.f * v[u].z, 2.f * v[u].w));
      s += quad_sum(v[u]);
    }
  }
  if (i < end) {  // the last, partial round: its loads issued together, as the full rounds' are
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * kAccThreads < end) v[u] = __ldcs(a + i + u * kAccThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * kAccThreads >= end) break;
      if (kDfeat)
        __stcs(dfeat + i + u * kAccThreads, make_float4(2.f * v[u].x, 2.f * v[u].y, 2.f * v[u].z, 2.f * v[u].w));
      s += quad_sum(v[u]);
    }
  }
  if (outs.n[0] + outs.n[1] + outs.n[2] == 0) return;  // dfeat alone: no total to broadcast
  s = block_sum(s, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
  cg::this_grid().sync();
  float t = 0.f;
  for (int q = threadIdx.x; q < static_cast<int>(gridDim.x); q += kAccThreads) t += __ldcg(part + q);
  __syncthreads();  // red is free again
  t = block_sum(t, red);
  if (threadIdx.x == 0) total = t;
  __syncthreads();
  const float tot = total;
#pragma unroll
  for (int k = 0; k < kMaxOuts; ++k) fill_output(outs.ptr[k], outs.n[k], tot);
}

// out[c] = sum over s < S, in order from zero, of the sum over r < rows, in
// order from zero, of a[s*rows + r, c]; one block of kColThreads, S*C*4
// bytes of dynamic shared memory; rows a multiple of kColAhead.
__global__ void __launch_bounds__(kColThreads)
grid_column_accum(const float* __restrict__ a, int S, int rows, int C, float* __restrict__ out) {
  extern __shared__ float part[];  // [S][C]: each row block's column sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, chunks = (C + 31) / 32;
  for (int item = warp; item < S * chunks; item += kColThreads / 32) {
    const int s = item / chunks, c = 32 * (item - s * chunks) + lane;
    if (c >= C) continue;
    const float* p = a + static_cast<long long>(s) * rows * C + c;
    // rows r .. r + kColAhead - 1 in v, each slot refilled with the row
    // kColAhead further on as soon as it is added
    float v[kColAhead], sum = 0.f;
#pragma unroll
    for (int u = 0; u < kColAhead; ++u) v[u] = __ldg(p + static_cast<long long>(u) * C);
    for (int r = kColAhead;; r += kColAhead) {
      const bool more = r < rows;
#pragma unroll
      for (int u = 0; u < kColAhead; ++u) {
        sum += v[u];
        if (more) v[u] = __ldg(p + static_cast<long long>(r + u) * C);
      }
      if (!more) break;
    }
    part[static_cast<long long>(s) * C + c] = sum;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kColThreads) {
    float t = 0.f;
    for (int s = 0; s < S; ++s) t += part[static_cast<long long>(s) * C + c];
    out[c] = t;
  }
}

}  // namespace

// The persistent grid of block_total_accum on the current device: the
// blocks of either instantiation that fit an SM at once, at most
// kMaxBlocksPerSM, times the SMs; a negative CUDA error on failure.
extern "C" int se3_probe_accum_blocks() {
  int dev = 0, sms = 0, occ = 0, occ_dfeat = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, block_total_accum<false>, kAccThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_dfeat, block_total_accum<true>, kAccThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (occ_dfeat < occ) occ = occ_dfeat;
  if (occ > kMaxBlocksPerSM) occ = kMaxBlocksPerSM;
  return occ < 1 ? -static_cast<int>(cudaErrorInvalidConfiguration) : occ * sms;
}

// a [n] float32, 16-byte aligned, n a multiple of 4; dfeat [n] or null;
// part [blocks] scratch; block b streams a's float4s [b*per, (b+1)*per)
// (probes.accum_plan; blocks at most se3_probe_accum_blocks()); out_k
// [n_k] for k < 3, 16-byte aligned, null with n_k = 0 where absent.  One
// cooperative launch.
extern "C" int se3_probe_block_total_accum(const void* a, long long n, void* dfeat, void* part, int blocks,
                                           long long per, void* out0, long long n0, void* out1, long long n1,
                                           void* out2, long long n2, void* stream_ptr) {
  const void* outs_p[kMaxOuts] = {out0, out1, out2};
  const long long outs_n[kMaxOuts] = {n0, n1, n2};
  bool ok = n >= 4 && n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(dfeat) % 16 == 0 && part != nullptr && blocks >= 1 && per >= 1 &&
            per * blocks >= n / 4;
  for (int k = 0; k < kMaxOuts; ++k)
    ok = ok && outs_n[k] >= 0 && (outs_n[k] == 0 || (outs_p[k] != nullptr &&
                                                     reinterpret_cast<uintptr_t>(outs_p[k]) % 16 == 0));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Outs outs{{static_cast<float*>(out0), static_cast<float*>(out1), static_cast<float*>(out2)}, {n0, n1, n2}};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kAccThreads);
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float4* a4 = static_cast<const float4*>(a);
  float* p = static_cast<float*>(part);
  const cudaError_t err =
      dfeat != nullptr
          ? cudaLaunchKernelEx(&cfg, block_total_accum<true>, a4, n / 4, per, static_cast<float4*>(dfeat), p, outs)
          : cudaLaunchKernelEx(&cfg, block_total_accum<false>, a4, n / 4, per, static_cast<float4*>(nullptr), p,
                               outs);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// a [S*rows, C] float32, out [C]; rows a multiple of 64, S*C*4 bytes at
// most kColMaxSmem.  One launch of one block.
extern "C" int se3_probe_grid_column_accum(const void* a, int S, int rows, int C, void* out, void* stream_ptr) {
  if (S < 1 || rows < kColAhead || rows % kColAhead != 0 || C < 1 ||
      static_cast<long long>(S) * C * 4 > kColMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = S * C * 4;
  static bool raised[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_dynamic_smem(grid_column_accum, kColMaxSmem, raised);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  grid_column_accum<<<1, kColThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(a), S, rows, C, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// attrs[0..3] of kernel `which`: 0 block_total_accum<dfeat>, 1
// block_total_accum, 2 grid_column_accum (its dynamic shared memory, S*C*4
// bytes, is the call's: 0 here) (probe_common.cuh: kernel_attrs).
extern "C" int se3_probe_accum_attrs(int which, int* attrs) {
  switch (which) {
    case 0: return kernel_attrs(block_total_accum<true>, 0, attrs);
    case 1: return kernel_attrs(block_total_accum<false>, 0, attrs);
    case 2: return kernel_attrs(grid_column_accum, 0, attrs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
