// Pieces shared by the probe kernels (probe_stage_fwd.cu, probe_bwd_ops.cu,
// probe_stream.cu, probe_accum.cu, probe_cellconv.cu, probe_mosaic.cu), sm_90a: the tanh form of GELU that jax.nn.gelu computes
// by default (approximate=True) and its derivative, sums of per-block
// partials in a fixed order, so that two calls give the same bits, a
// kernel's registers, local bytes and shared memory for the wrappers, and
// the dynamic shared memory a kernel may take past 48 KB.
// Everything here sits in an anonymous namespace: each source that includes
// it builds into its own library with its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kPartThreads = 256;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluCubic = 0.044715f;

// x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))), in jax.nn.gelu's order
__device__ __forceinline__ float gelu_tanh(float x) {
  const float cdf = 0.5f * (1.0f + tanhf(kSqrt2OverPi * (x + kGeluCubic * (x * x * x))));
  return x * cdf;
}

// d/dx gelu_tanh(x): cdf + x * 0.5 * (1 - t^2) * sqrt(2/pi) * (1 + 3 * 0.044715 x^2)
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float t = tanhf(kSqrt2OverPi * (x + kGeluCubic * (x * x * x)));
  const float cdf = 0.5f * (1.0f + t);
  return cdf + x * (0.5f * (1.0f - t * t)) * (kSqrt2OverPi * (1.0f + 3.0f * kGeluCubic * (x * x)));
}

// The sum of v over the block's threads in a fixed order: a shuffle tree in
// each warp, then the warps' sums in warp order.  The result is valid in
// thread 0; every thread of the block must call it (it holds a barrier).
// red: 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// out[j] = sum over p < P of part[p*L + j], block j of L: thread t adds the
// partials p = t, t + 256, ... in order, then block_sum.
__global__ void __launch_bounds__(kPartThreads)
sum_partials_fixed(const float* __restrict__ part, int P, int L, float* __restrict__ out) {
  __shared__ float red[32];
  const int j = blockIdx.x;
  float s = 0.f;
  for (int p = threadIdx.x; p < P; p += kPartThreads) s += part[static_cast<long long>(p) * L + j];
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[j] = s;
}

// Lets kernel fn take `bytes` of dynamic shared memory past the default 48
// KB (cudaFuncSetAttribute), once per device: raised[d] records device d.
constexpr int kMaxDevices = 64;
template <typename F>
cudaError_t allow_dynamic_smem(F* fn, int bytes, bool* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || bytes <= 48 * 1024 || (dev < kMaxDevices && raised[dev])) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return err;
}

// attrs[0..3] = registers a thread, local (stack and spill) bytes, static
// and dynamic shared memory bytes of kernel fn (cudaFuncGetAttributes).
template <typename F>
int kernel_attrs(F* fn, int dynamic_smem, int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = a.numRegs;
  attrs[1] = static_cast<int>(a.localSizeBytes);
  attrs[2] = static_cast<int>(a.sharedSizeBytes);
  attrs[3] = dynamic_smem;
  return 0;
}

}  // namespace
