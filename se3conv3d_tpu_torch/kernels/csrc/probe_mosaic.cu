// The Mosaic pattern probes' sixteen one-block kernels, for NVIDIA Hopper
// (sm_90a), as four kernels over a grid of tiles:
//
//   strided_product:  out[b, i, j] = sum over k of A[b, i, k] * B[b, k, j], A and
//                     B read through given strides, float32 or bfloat16
//                     operands, float32 FMA sums (p1-p4, p8, p10, p13, p15)
//   strided_copy:     out[i0, i1, i2, i3] = x[sum_d i_d * s_d], the
//                     reshapes, the slice and the transposes (p5-p7, p12,
//                     p16, p17)
//   blockdiag_build:  out[p, h*C + c, h'*E + e] = x[2p + h, c, e] if h == h',
//                     else 0 (p9)
//   mid_write:        out[m, q, :] = a[m, :] * q for q < Q (p14)
//
// Replace the TPU Pallas kernel of experiments/probe_mosaic.py:53
// (run_kernel: one launcher, one block, whole arrays in VMEM, reached by
// p1-p10 and p12-p17), each probe one dot_general, reshape, slice,
// transpose or mid-index write at TM = 128, E = 32, G = 2, D = 9, Q = 32,
// C = O = 64 that a candidate fused-conv formulation needed Mosaic to
// lower.  The port ports the function, not the one-block layout: these
// arrays do not fit one block's 227 KB.  See
// se3conv3d_tpu_torch/kernels/mosaic_probes.py for the wrappers, one per
// probe, and the plain PyTorch versions.
//
// What bounds them: each probe reads and writes at most a few MB and runs
// at most 134 MFLOP (p8), so every bound is a few microseconds or less and
// the times show launch latency.  strided_product keeps a 32 x 32 output
// tile a block, each thread 4 outputs, and walks K in steps of 32 through
// shared memory; each operand tile is read so that neighbouring threads
// read neighbouring addresses along whichever of its axes has stride 1.
// Where the batch of tiles is too few to fill the card and K is long (p3
// contracts 2,048 terms into 8,192 outputs, p15 4,096 into 1,152), K is
// split across blocks, each split writes its partial tile, and
// sum_rows_ordered adds the splits in split order: no atomics, two calls
// give the same bits.  bfloat16 products are exact in float32, so p10's
// only rounding is the sum's.  strided_copy moves 16 bytes a thread where
// the source's inner stride is 1 (every probe but p12's transpose, which
// reads 4 bytes a thread and writes coalesced).

#include <cuda_bf16.h>
#include <stdint.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 4096;
constexpr int kTile = 32;  // strided_product: output tile kTile x kTile, K step kTile

inline unsigned grid_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b < kMaxGrid ? b : kMaxGrid));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct ProductDims {
  long long a_b, a_i, a_k;  // A's strides, in elements
  long long b_b, b_k, b_j;  // B's strides
  int batch, M, N, K;
  int splits, k_per_split;
};

// grid (N tiles, M tiles, batch * splits).  out [batch, M, N] contiguous
// when splits == 1, else part [splits, batch, M, N].
template <typename T>
__global__ void __launch_bounds__(kThreads)
strided_product(const T* __restrict__ A, const T* __restrict__ B, ProductDims d, float* __restrict__ out) {
  __shared__ float as[kTile][kTile + 1];  // as[k][i]
  __shared__ float bs[kTile][kTile + 1];  // bs[k][j]
  const int t = threadIdx.x, ty = t / kTile, tx = t % kTile;
  const int j0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const int b = blockIdx.z % d.batch, s = blockIdx.z / d.batch;
  const int kbeg = s * d.k_per_split;
  const int kend = min(d.K, kbeg + d.k_per_split);
  const T* a = A + b * d.a_b;
  const T* bb = B + b * d.b_b;
  const bool a_rows = d.a_k == 1, b_rows = d.b_j == 1;
  float acc[kTile / 8] = {};
  for (int k0 = kbeg; k0 < kend; k0 += kTile) {
    __syncthreads();  // the last tile is consumed
    for (int e = t; e < kTile * kTile; e += kThreads) {
      const int k = a_rows ? e % kTile : e / kTile, i = a_rows ? e / kTile : e % kTile;
      as[k][i] = (i0 + i < d.M && k0 + k < kend) ? to_f(a[(i0 + i) * d.a_i + (k0 + k) * d.a_k]) : 0.f;
      const int kb = b_rows ? e / kTile : e % kTile, j = b_rows ? e % kTile : e / kTile;
      bs[kb][j] = (j0 + j < d.N && k0 + kb < kend) ? to_f(bb[(k0 + kb) * d.b_k + (j0 + j) * d.b_j]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float y = bs[k][tx];
#pragma unroll
      for (int u = 0; u < kTile / 8; ++u) acc[u] = fmaf(as[k][ty + 8 * u], y, acc[u]);
    }
  }
  const int j = j0 + tx;
  if (j >= d.N) return;
  float* o = out + (static_cast<long long>(s) * d.batch + b) * d.M * d.N;
#pragma unroll
  for (int u = 0; u < kTile / 8; ++u) {
    const int i = i0 + ty + 8 * u;
    if (i < d.M) o[static_cast<long long>(i) * d.N + j] = acc[u];
  }
}

struct CopyDims {
  long long d[4];  // out's shape, contiguous
  long long s[4];  // the source's strides, in elements
};

// kVec: d[3] % 4 == 0, s[3] == 1, the other strides multiples of 4 and x
// 16-byte aligned: one float4 a thread.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
strided_copy(const float* __restrict__ x, CopyDims c, float* __restrict__ out, long long n) {
  const int w = kVec ? 4 : 1;
  const long long d3 = c.d[3] / w;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    long long r = i;
    const long long i3 = r % d3;
    r /= d3;
    const long long i2 = r % c.d[2];
    r /= c.d[2];
    const long long i1 = r % c.d[1];
    const long long i0 = r / c.d[1];
    const long long src = i0 * c.s[0] + i1 * c.s[1] + i2 * c.s[2] + i3 * w * c.s[3];
    if (kVec)
      reinterpret_cast<float4*>(out)[i] = __ldg(reinterpret_cast<const float4*>(x + src));
    else
      out[i] = __ldg(x + src);
  }
}

// x [2P, C, E] -> out [P, 2C, 2E], one float4 of out a thread; E % 4 == 0
__global__ void __launch_bounds__(kThreads)
blockdiag_build(const float4* __restrict__ x, int C, int E, float4* __restrict__ out, long long n4) {
  const int row4 = 2 * E / 4;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long p = i / (2LL * C * row4);
    const long long rem = i - p * 2LL * C * row4;
    const int r = static_cast<int>(rem / row4), col = 4 * static_cast<int>(rem % row4);
    const int h = r / C, c = r % C, hc = col / E, e = col % E;
    out[i] = h == hc ? __ldg(x + (((2 * p + h) * C + c) * E + e) / 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// a [M, C] -> out [M, Q, C], out[m, q, :] = a[m, :] * q; C % 4 == 0
__global__ void __launch_bounds__(kThreads)
mid_write(const float4* __restrict__ a, int Q, int C4, float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long m = i / (static_cast<long long>(Q) * C4);
    const long long rem = i - m * Q * C4;
    const float q = static_cast<float>(rem / C4);
    const float4 v = __ldg(a + m * C4 + rem % C4);
    out[i] = make_float4(v.x * q, v.y * q, v.z * q, v.w * q);
  }
}

}  // namespace

// out[b, i, j] = sum_k A[b, i, k] * B[b, k, j]: A at a + b*a_b + i*a_i +
// k*a_k, B at b + b*b_b + k*b_k + j*b_j (strides in elements), float32
// (use_bf16 = 0) or bfloat16 operands; out [batch, M, N] float32
// contiguous.  splits > 1 splits K into splits ranges of k_per_split (a
// multiple of 32) and needs part [splits, batch, M, N] scratch.
extern "C" int se3_probe_strided_product(const void* a, const void* b, int use_bf16, long long a_b, long long a_i,
                                         long long a_k, long long b_b, long long b_k, long long b_j, int batch,
                                         int M, int N, int K, int splits, int k_per_split, void* part, void* out,
                                         void* stream_ptr) {
  if (batch < 1 || M < 1 || N < 1 || K < 1 || splits < 1 || k_per_split < 1 ||
      (splits > 1 && (part == nullptr || k_per_split % kTile != 0)) ||
      static_cast<long long>(splits) * k_per_split < K || static_cast<long long>(batch) * splits > 65535 ||
      (M + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const ProductDims d{a_b, a_i, a_k, b_b, b_k, b_j, batch, M, N, K, splits, k_per_split};
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, batch * splits);
  float* dst = splits > 1 ? static_cast<float*>(part) : static_cast<float*>(out);
  if (use_bf16)
    strided_product<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), d, dst);
  else
    strided_product<float><<<grid, kThreads, 0, stream>>>(static_cast<const float*>(a),
                                                           static_cast<const float*>(b), d, dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long L = static_cast<long long>(batch) * M * N;
  if (L > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sum_rows_ordered<<<static_cast<unsigned>((L + kPartThreads - 1) / kPartThreads), kPartThreads, 0, stream>>>(
      static_cast<const float*>(part), splits, static_cast<int>(L), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out [d0, d1, d2, d3] float32 contiguous = x[i0*s0 + i1*s1 + i2*s2 + i3*s3]
extern "C" int se3_probe_strided_copy(const void* x, long long d0, long long d1, long long d2, long long d3,
                                      long long s0, long long s1, long long s2, long long s3, void* out,
                                      void* stream_ptr) {
  if (d0 < 1 || d1 < 1 || d2 < 1 || d3 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const CopyDims c{{d0, d1, d2, d3}, {s0, s1, s2, s3}};
  const long long n = d0 * d1 * d2 * d3;
  const bool vec = d3 % 4 == 0 && s3 == 1 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (vec)
    strided_copy<true><<<grid_for(n / 4), kThreads, 0, stream>>>(static_cast<const float*>(x), c,
                                                                 static_cast<float*>(out), n / 4);
  else
    strided_copy<false><<<grid_for(n), kThreads, 0, stream>>>(static_cast<const float*>(x), c,
                                                              static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// x [2P, C, E] -> out [P, 2C, 2E], float32, 16-byte aligned, E % 4 == 0
extern "C" int se3_probe_blockdiag_build(const void* x, int P, int C, int E, void* out, void* stream_ptr) {
  if (P < 1 || C < 1 || E < 4 || E % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = static_cast<long long>(P) * 2 * C * 2 * E / 4;
  blockdiag_build<<<grid_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float4*>(x), C, E, static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// a [M, C] -> out [M, Q, C], float32, 16-byte aligned, C % 4 == 0
extern "C" int se3_probe_mid_write(const void* a, int M, int Q, int C, void* out, void* stream_ptr) {
  if (M < 1 || Q < 1 || C < 4 || C % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = static_cast<long long>(M) * Q * C / 4;
  mid_write<<<grid_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float4*>(a), Q, C / 4, static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// attrs[0..3] of kernel `which`: 0 strided_product<float>, 1
// strided_product<bf16>, 2 strided_copy<vec>, 3 strided_copy<scalar>, 4
// blockdiag_build, 5 mid_write, 6 sum_rows_ordered (probe_common.cuh:
// kernel_attrs).
extern "C" int se3_probe_mosaic_attrs(int which, int* attrs) {
  switch (which) {
    case 0: return kernel_attrs(strided_product<float>, 0, attrs);
    case 1: return kernel_attrs(strided_product<__nv_bfloat16>, 0, attrs);
    case 2: return kernel_attrs(strided_copy<true>, 0, attrs);
    case 3: return kernel_attrs(strided_copy<false>, 0, attrs);
    case 4: return kernel_attrs(blockdiag_build, 0, attrs);
    case 5: return kernel_attrs(mid_write, 0, attrs);
    case 6: return kernel_attrs(sum_rows_ordered, 0, attrs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
