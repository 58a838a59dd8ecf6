// Streaming column sums for NVIDIA Hopper (sm_90a): the read-rate probe.
//
//   out[j] = sum_r x[r, j]  (j < L),   out[L] = out[0] + ... + out[L-1]
//
// for a row-major float32 array x [R, L].  Replaces the TPU Pallas kernel
// experiments/chip_stream.py:k_sum, reached through pallas_sum_feat (feat
// [M, E, C] seen as [M*E, C], L = 64) and pallas_sum_geo (the geometry
// table [M*E, 19], and [M*E, 128]): each of those sums a table once from
// HBM to measure the rate at which a hand kernel streams it.  See
// se3conv3d_tpu_torch/kernels/probes.py for the wrapper and the plain
// PyTorch version.
//
// What bounds it: the bytes, 4*R*L read once (152 MiB to 1 GiB at the
// probe's sizes), against 3.35 TB/s; one add per float.  The design reads
// the flat array with 16-byte vector loads, neighbouring threads on
// neighbouring addresses, kUnroll loads in flight per thread, over a grid
// of kBlocks x kThreads threads whose stride (4 floats a thread) is a
// multiple of L: each thread then always meets the same 4 columns, the flat
// index mod L, and keeps 4 sums.  A 19-wide row is 76 bytes; its columns
// wrap across the vector loads, and nothing is padded to 128 lanes (that was
// the TPU's layout, not the function).  Each block adds its threads' sums
// column by column in slot order into a partial row; sum_partials_fixed
// adds the blocks' rows in a fixed order: two calls give the same bits.

#include <stdint.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;
// 4 * kThreads * kBlocks = 2^10 * 5 * 11 * 19: a multiple of 19, 64 and 128;
// 1045 blocks of 256 threads, about 8 an SM on 132 SMs: one wave
constexpr int kBlocks = 19 * 55;
constexpr int kUnroll = 4;
constexpr int kSlots = 4 * kThreads;

__global__ void __launch_bounds__(kThreads)
column_partials(const float4* __restrict__ x, long long n4, int L, float* __restrict__ part) {
  __shared__ float slots[kSlots];
  const long long T = static_cast<long long>(gridDim.x) * kThreads;
  long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (; j + (kUnroll - 1) * T < n4; j += kUnroll * T) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(x + j + u * T);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a0 += v[u].x;
      a1 += v[u].y;
      a2 += v[u].z;
      a3 += v[u].w;
    }
  }
  for (; j < n4; j += T) {
    const float4 v = __ldcs(x + j);
    a0 += v.x;
    a1 += v.y;
    a2 += v.z;
    a3 += v.w;
  }
  const int s0 = 4 * threadIdx.x;
  slots[s0] = a0;
  slots[s0 + 1] = a1;
  slots[s0 + 2] = a2;
  slots[s0 + 3] = a3;
  __syncthreads();
  // slot s holds column (4 * blockIdx.x * kThreads + s) mod L
  const int base = static_cast<int>((4LL * blockIdx.x * kThreads) % L);
  for (int c = threadIdx.x; c < L; c += kThreads) {
    float s = 0.f;
    for (int k = ((c - base) % L + L) % L; k < kSlots; k += L) s += slots[k];
    part[static_cast<long long>(blockIdx.x) * L + c] = s;
  }
}

// out[L] = out[0] + out[1] + ... + out[L-1], in order.
__global__ void sum_row_fixed(float* __restrict__ out, int L) {
  float s = 0.f;
  for (int j = 0; j < L; ++j) s += out[j];
  out[L] = s;
}

}  // namespace

// Per-block partial rows the call needs: part holds kBlocks * L floats.
extern "C" int se3_probe_stream_blocks() { return kBlocks; }

// x [R, L] float32, 16-byte aligned, R * L a multiple of 4; L divides
// 4 * kThreads * kBlocks and is at most kSlots; part [kBlocks, L] scratch,
// out [L + 1].
extern "C" int se3_probe_column_sums(const void* x, long long R, int L, void* part, void* out,
                                     void* stream_ptr) {
  const long long n = R * L;
  if (L < 1 || L > kSlots || n % 4 != 0 || (4LL * kThreads * kBlocks) % L != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  column_partials<<<kBlocks, kThreads, 0, stream>>>(static_cast<const float4*>(x), n / 4, L, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_fixed<<<L, kPartThreads, 0, stream>>>(p, kBlocks, L, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_row_fixed<<<1, 1, 0, stream>>>(o, L);
  return static_cast<int>(cudaGetLastError());
}
