// The five backward building blocks of the fused-forward bisection, for
// NVIDIA Hopper (sm_90a), float32:
//
//   b1 (gelu_jvp):     out = gelu(a) + gelu'(a), tanh GELU        a [R, GQ]
//   b2 (expand_groups): out[g*Q + q, t, o] = a[g, t, o]           a [G, TM, O]
//   b3 (batched_contract): out[gq, c, o] = sum_m a[gq, m, c] * b[gq, m, o]
//   b4 (rows_partials + broadcast_colsum): out[gq, c, o] = sum_m a[m, c]
//   b5 (scale2):       out = 2 * a, [TM, E, GQ] read as [TM*E, GQ]
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
// What bounds them: bytes for b1, b2, b4 and b5 (b1 a tanh per value, the
// rest copies and adds); b3 is 2*GQ*C*O*R FLOPs (67 MFLOP at GQ = C = O =
// 64, R = 128) over 4 MiB of operands: a block per gq keeps a 4 x 4 tile of
// (c, o) per thread and walks the rows in order, its operand rows read
// from L1.  b4 runs on the TPU as a sequential grid whose output block
// every step revisits; Hopper blocks run in parallel, so each block sums
// its rows (column by column, in row order) into a partial row, and
// broadcast_colsum adds the partials in block order, as the TPU grid did,
// and writes the broadcast: no atomics, two calls give the same bits.

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 4096;

inline unsigned grid_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b < kMaxGrid ? b : kMaxGrid));
}

__global__ void __launch_bounds__(kThreads)
gelu_jvp(const float4* __restrict__ a, float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const float4 v = a[i];
    out[i] = make_float4(gelu_tanh(v.x) + gelu_tanh_grad(v.x), gelu_tanh(v.y) + gelu_tanh_grad(v.y),
                         gelu_tanh(v.z) + gelu_tanh_grad(v.z), gelu_tanh(v.w) + gelu_tanh_grad(v.w));
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

// block gq: out[gq] [C, O] = a[gq]^T [C, R] . b[gq] [R, O]; thread tile 4 x 4
__global__ void __launch_bounds__(kThreads)
batched_contract(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
                 int R, int C, int O) {
  const int gq = blockIdx.x;
  const float* ag = a + static_cast<long long>(gq) * R * C;
  const float* bg = b + static_cast<long long>(gq) * R * O;
  float* og = out + static_cast<long long>(gq) * C * O;
  const int tc = C / 4, to = O / 4;
  for (int t = threadIdx.x; t < tc * to; t += kThreads) {
    const int c0 = (t / to) * 4, o0 = (t % to) * 4;
    float acc[4][4] = {};
    for (int m = 0; m < R; ++m) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(ag + static_cast<long long>(m) * C + c0));
      const float4 y = __ldg(reinterpret_cast<const float4*>(bg + static_cast<long long>(m) * O + o0));
      const float xv[4] = {x.x, x.y, x.z, x.w}, yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(og + static_cast<long long>(c0 + i) * O + o0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// part[s, c] = sum of a[r, c] over block s's rows r in [s*rows, (s+1)*rows), in row order
__global__ void rows_partials(const float* __restrict__ a, int rows, int C, float* __restrict__ part) {
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += a[(r0 + r) * C + c];
    part[static_cast<long long>(blockIdx.x) * C + c] = s;
  }
}

// out[gq, c, o] = ((0 + part[0, c]) + part[1, c]) + ... + part[S-1, c]
__global__ void __launch_bounds__(kThreads)
broadcast_colsum(const float* __restrict__ part, int S, int C, int O, float* __restrict__ out,
                 long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int c = static_cast<int>((i / O) % C);
    float s = 0.f;
    for (int p = 0; p < S; ++p) s += part[p * C + c];
    out[i] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
scale2(const float4* __restrict__ a, float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const float4 v = a[i];
    out[i] = make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
  }
}

}  // namespace

// Every array below is float32, contiguous and 16-byte aligned; element
// counts and the inner widths are multiples of 4.

extern "C" int se3_probe_gelu_jvp(const void* a, void* out, long long n, void* stream_ptr) {
  if (n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  gelu_jvp<<<grid_for(n / 4), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float4*>(a), static_cast<float4*>(out), n / 4);
  return static_cast<int>(cudaGetLastError());
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
  if (C % 4 != 0 || O % 4 != 0 || GQ < 1) return static_cast<int>(cudaErrorInvalidValue);
  batched_contract<<<GQ, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), R, C, O);
  return static_cast<int>(cudaGetLastError());
}

// a [S*rows, C], part [S, C] scratch, out [GQ, C, O]
extern "C" int se3_probe_rank3_accum(const void* a, void* part, void* out, int S, int rows, int C,
                                     int GQ, int O, void* stream_ptr) {
  if (S < 1 || rows < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* p = static_cast<float*>(part);
  rows_partials<<<S, C < kThreads ? C : kThreads, 0, stream>>>(static_cast<const float*>(a), rows, C, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(GQ) * C * O;
  broadcast_colsum<<<grid_for(n), kThreads, 0, stream>>>(p, S, C, O, static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int se3_probe_scale2(const void* a, void* out, long long n, void* stream_ptr) {
  if (n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  scale2<<<grid_for(n / 4), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float4*>(a), static_cast<float4*>(out), n / 4);
  return static_cast<int>(cudaGetLastError());
}
