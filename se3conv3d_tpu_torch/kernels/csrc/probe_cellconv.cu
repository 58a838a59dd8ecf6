// The cell-blocked conv's building blocks, for NVIDIA Hopper (sm_90a),
// float32, ids int32:
//
//   gather_blocks (p1):      out[i] = scale * tab[ids[i]]           (blocks of P x C)
//   gather_sum_blocks (p2, p4): out[i] = ((0 + tab[ids[i, 0]]) + tab[ids[i, 1]]) + ...
//                            over r < R, in r order
//   masked_dist_product (p3): d2[q, k] = (dx^2 + dy^2) + dz^2 (qp[q] - cp[k], xyz),
//                            pne = (d2 < 0.04) * (3 d2 + 1), out = pne @ cf
//
// Replace the TPU Pallas kernels of experiments/probe_cellconv.py: p1 (:47,
// a table's [32, 128] blocks gathered by scalar-prefetched int32 ids, times
// 2), p2 (:82, R = 4 gathered blocks added into an output revisited over
// the inner grid axis, zeroed at r = 0), p3 (:120, 8 blocks of 256 queries
// against 512 candidates: pairwise squared distances, a radius mask, a
// stand-in embedding and its product with the candidates' features; the
// queries' own features qf are passed and unused) and p4 (:160, p2's
// candidate-major layout: 64 output blocks, each the sum of the R = 4
// gradient blocks of 16 that ids names).  See
// se3conv3d_tpu_torch/kernels/cellconv_probes.py for the wrappers and the
// plain PyTorch versions.
//
// What bounds them: bytes for the gathers (p1 reads and writes 256 KB, p2
// 1.3 MB, p4 2.4 MB: launch latency at these sizes); p3 is 2 * 2048 * 512 *
// 128 = 268 MFLOP of float32 FMA, 4.0 us at 67 TFLOP/s, over 1.3 MB.
// Scalar prefetch becomes "the block loads its own id": each thread reads
// the id of the block its float4 falls in.  An id outside [0, NB) is never
// clamped or read through: its output block is NaN, and the wrapper's
// caller checks the ids (cellconv_probes.bad_ids).  The sums keep the JAX
// grid's order (from zero, r = 0, 1, ...), so kernel, plain version and JAX
// kernel agree bit for bit.  p3 tiles the 2,048 queries 16 to a block (128
// blocks for 132 SMs, where the TPU ran 8): each block stages 64 candidates'
// positions and a [64, 128] tile of cf in shared memory, computes its [16,
// 64] pne tile there, then each thread keeps 2 queries x 4 channels of the
// product and adds the candidates in order with fmaf.  d2 and 3 d2 + 1 are
// rounded step by step (__fmul_rn / __fadd_rn, which nvcc never contracts
// into an FMA), as the JAX kernel computes them: a pair near d2 = 0.04 must
// fall on the same side of the mask in both, or an error of order |cf|
// appears.  Where asked, the kernel also writes its pne [NQ, NC], so a
// check can count mask disagreements.

#include <math.h>
#include <stdint.h>

#include "probe_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 4096;
// masked_dist_product's tile: queries, candidates a step, channels a block
constexpr int kTQ = 16;
constexpr int kKC = 64;
constexpr int kTC = 128;
constexpr float kRadius2 = 0.04f;

inline unsigned grid_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b < kMaxGrid ? b : kMaxGrid));
}

// out [NQ, blk4] float4 = scale * tab [NB, blk4] float4 at row ids[i]
__global__ void __launch_bounds__(kThreads)
gather_blocks(const int* __restrict__ ids, const float4* __restrict__ tab, int NB, long long blk4,
              float scale, float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long q = i / blk4;
    const int id = __ldg(ids + q);
    float4 v = make_float4(NAN, NAN, NAN, NAN);
    if (id >= 0 && id < NB) {
      const float4 x = __ldg(tab + id * blk4 + (i - q * blk4));
      v = make_float4(scale * x.x, scale * x.y, scale * x.z, scale * x.w);
    }
    out[i] = v;
  }
}

// out [NQ, blk4] float4 = sum over r < R, in order from zero, of tab's row ids[q, r]
__global__ void __launch_bounds__(kThreads)
gather_sum_blocks(const int* __restrict__ ids, int R, const float4* __restrict__ tab, int NB,
                  long long blk4, float4* __restrict__ out, long long n4) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long q = i / blk4, j = i - q * blk4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < R; ++r) {
      const int id = __ldg(ids + q * R + r);
      if (id < 0 || id >= NB) {
        s = make_float4(NAN, NAN, NAN, NAN);
        break;
      }
      const float4 x = __ldg(tab + id * blk4 + j);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    out[i] = s;
  }
}

// grid (NQ / kTQ, C / kTC): out[q, c] = sum over k < NC, in order, of pne[q, k] * cf[k, c]
__global__ void __launch_bounds__(kThreads)
masked_dist_product(const float* __restrict__ qp, int ldq, const float* __restrict__ cp, int ldc, int NC,
                    const float* __restrict__ cf, int C, float* __restrict__ out, float* __restrict__ pne_out) {
  __shared__ float qs[kTQ][3];
  __shared__ float cs[kKC][3];
  __shared__ float pne[kTQ][kKC];
  __shared__ float4 fs[kKC][kTC / 4];
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kTQ, c0 = blockIdx.y * kTC;
  const int tq = t / 32, tc = t % 32;  // queries 2 tq, 2 tq + 1; channels c0 + 4 tc .. + 3
  if (t < kTQ * 3) qs[t / 3][t % 3] = qp[static_cast<long long>(q0 + t / 3) * ldq + t % 3];
  float acc[2][4] = {};
  for (int k0 = 0; k0 < NC; k0 += kKC) {
    __syncthreads();  // the last tile is consumed
    if (t < kKC * 3) cs[t / 3][t % 3] = cp[static_cast<long long>(k0 + t / 3) * ldc + t % 3];
    for (int u = t; u < kKC * kTC / 4; u += kThreads) {
      const int k = u / (kTC / 4), c4 = u % (kTC / 4);
      fs[k][c4] = __ldg(reinterpret_cast<const float4*>(cf + static_cast<long long>(k0 + k) * C + c0) + c4);
    }
    __syncthreads();
    for (int u = t; u < kTQ * kKC; u += kThreads) {
      const int qi = u / kKC, k = u % kKC;
      const float dx = __fsub_rn(qs[qi][0], cs[k][0]);
      const float dy = __fsub_rn(qs[qi][1], cs[k][1]);
      const float dz = __fsub_rn(qs[qi][2], cs[k][2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float v = d2 < kRadius2 ? __fadd_rn(__fmul_rn(d2, 3.f), 1.f) : 0.f;
      pne[qi][k] = v;
      if (pne_out != nullptr && blockIdx.y == 0) pne_out[static_cast<long long>(q0 + qi) * NC + k0 + k] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      const float a0 = pne[2 * tq][k], a1 = pne[2 * tq + 1][k];
      const float4 b = fs[k][tc];
      acc[0][0] = fmaf(a0, b.x, acc[0][0]);
      acc[0][1] = fmaf(a0, b.y, acc[0][1]);
      acc[0][2] = fmaf(a0, b.z, acc[0][2]);
      acc[0][3] = fmaf(a0, b.w, acc[0][3]);
      acc[1][0] = fmaf(a1, b.x, acc[1][0]);
      acc[1][1] = fmaf(a1, b.y, acc[1][1]);
      acc[1][2] = fmaf(a1, b.z, acc[1][2]);
      acc[1][3] = fmaf(a1, b.w, acc[1][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float4*>(out + static_cast<long long>(q0 + 2 * tq + i) * C + c0 + 4 * tc) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

}  // namespace

// ids [NQ] int32; tab [NB, block] and out [NQ, block] float32, 16-byte
// aligned, block a multiple of 4.
extern "C" int se3_probe_gather_blocks(const void* ids, int NQ, const void* tab, int NB, long long block,
                                       float scale, void* out, void* stream_ptr) {
  if (NQ < 1 || NB < 1 || block < 4 || block % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = static_cast<long long>(NQ) * block / 4;
  gather_blocks<<<grid_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const int*>(ids), static_cast<const float4*>(tab), NB, block / 4, scale,
      static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// ids [NQ, R] int32; tab [NB, block] and out [NQ, block] as above.
extern "C" int se3_probe_gather_sum_blocks(const void* ids, int NQ, int R, const void* tab, int NB,
                                           long long block, void* out, void* stream_ptr) {
  if (NQ < 1 || R < 1 || NB < 1 || block < 4 || block % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = static_cast<long long>(NQ) * block / 4;
  gather_sum_blocks<<<grid_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const int*>(ids), R, static_cast<const float4*>(tab), NB, block / 4,
      static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// qp [NQ, ldq], cp [NC, ldc] (x, y, z in the first three columns), cf [NC,
// C], out [NQ, C], pne [NQ, NC] or null; float32, cf and out 16-byte
// aligned.  NQ a multiple of 16, NC of 64, C of 128; ldq, ldc >= 3.
extern "C" int se3_probe_masked_dist_product(const void* qp, int ldq, int NQ, const void* cp, int ldc, int NC,
                                             const void* cf, int C, void* out, void* pne, void* stream_ptr) {
  if (NQ < kTQ || NQ % kTQ != 0 || NC < kKC || NC % kKC != 0 || C < kTC || C % kTC != 0 || ldq < 3 ||
      ldc < 3 || reinterpret_cast<uintptr_t>(cf) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(NQ / kTQ, C / kTC);
  masked_dist_product<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(qp), ldq, static_cast<const float*>(cp), ldc, NC, static_cast<const float*>(cf),
      C, static_cast<float*>(out), static_cast<float*>(pne));
  return static_cast<int>(cudaGetLastError());
}

// attrs[0..3] of kernel `which`: 0 gather_blocks, 1 gather_sum_blocks,
// 2 masked_dist_product (probe_common.cuh: kernel_attrs).
extern "C" int se3_probe_cellconv_attrs(int which, int* attrs) {
  switch (which) {
    case 0: return kernel_attrs(gather_blocks, 0, attrs);
    case 1: return kernel_attrs(gather_sum_blocks, 0, attrs);
    case 2: return kernel_attrs(masked_dist_product, 0, attrs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
