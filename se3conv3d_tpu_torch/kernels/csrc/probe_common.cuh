// Pieces shared by the probe kernels (probe_stage_fwd.cu, probe_bwd_ops.cu,
// probe_stream.cu, probe_accum.cu, probe_cellconv.cu, probe_mosaic.cu), sm_90a: the tanh form of GELU that jax.nn.gelu computes
// by default (approximate=True), its derivative and the two summed with
// one exponential, sums of per-block
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

// gelu_tanh(x) + gelu_tanh_grad(x) with one exponential and no branch.
// With u = sqrt(2/pi) (x + 0.044715 x^3), e = exp(-2u) and s = 1 / (1 + e)
// = (1 + tanh u) / 2: gelu = x s, gelu' = s + 2x s(1 - s) sqrt(2/pi) (1 +
// 3 * 0.044715 x^2), and s(1 - s) = e s^2 (s - s^2 cancels where s is
// near 1), so gelu + gelu' = s (x + 1 + (e s) g), g = x (2 sqrt(2/pi) + 6 *
// 0.044715 sqrt(2/pi) x^2).  The constants are folded: e = 2^(x (kA + kB
// x^2)) on ex2.approx (what __expf runs, its log2(e) multiply folded in).
// The exponent is clamped to 127, so e (<= 2^127) stays finite, and where 1
// + e > 2^126 (x below about -9.9) __fdividef gives s = 0 and the output 0,
// as gelu + gelu' there is below 1e-35 (an s left above 0 would leave s e s
// g, which grows as x^3, far from 0 at large |x|).  Errors: ex2.approx is
// within 2 ulp plus the rounding of its argument (|y| 2^-24 relative in e,
// y the exponent), __fdividef within 2 ulp below 2^126; each output is
// within 1e-6 (1 + |ref|) of the float64 gelu + gelu' over [-20, 20] and
// +-1e4 (4e-7 with both errors at their worst in a float32 mirror;
// probes.gelu_jvp_exp_form is the exact one).  It is kept for its
// accuracy and its one path more than for speed: on an H100 it reads
// 2.0e-7 of 1 + |ref| over that sweep where gelu_tanh + gelu_tanh_grad
// read 6.2e-7 (which nvcc also brought to one exponential a value), and 3%
// under them a call, inside their spread (PERF.md section 6).  expf (2 ulp) and __frcp_rn (exact) meet the bound too, at more
// instructions each (20% slower, probe_variants.py b1).
__device__ __forceinline__ float gelu_tanh_jvp(float x) {
  constexpr float kA = -2.0f * 1.4426950408889634f * kSqrt2OverPi, kB = kA * kGeluCubic;
  constexpr float kG1 = 2.0f * kSqrt2OverPi, kG3 = 6.0f * kGeluCubic * kSqrt2OverPi;
  const float x2 = x * x;
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fminf(x * (kA + kB * x2), 127.0f)));
  const float s = __fdividef(1.0f, 1.0f + e);
  return s * ((x + 1.0f) + (e * s) * (x * (kG1 + kG3 * x2)));
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
