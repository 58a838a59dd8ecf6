// Fused equivariant PNE-conv forward for NVIDIA Hopper (sm_90a), float32.
//
//   out[b,m,g,o] = sum_{q,c} W[c,q,o] * sum_{k,f: mask[b,m,k]}
//                  gelu(P . [rel[b,m,k,g,:], rot6[b,m,k,g,f,:]] + bias)[q]
//                  * feats[b, idx[b,m,k], f, c]
//
// Replaces the TPU Pallas kernel se3conv3d_tpu/ops/pallas/fused_equiv.py:
// _fwd_kernel.  See se3conv3d_tpu_torch/kernels/fused_equiv.py for the
// wrapper, the plain PyTorch version and the design note.
//
// One block = 256 threads = 8 warps owns a tile of 8 query points of one
// batch element, one warp per point, and one block of up to 256 output
// channels.  Per channel chunk of 32:
//   1. each warp walks its point's valid edges (k, f) 32 at a time: lane e
//      evaluates the pne row of edge e (G*Q gelus) into shared memory, then
//      the warp gathers the 32 edges' features (lane = channel);
//   2. each lane accumulates an 8x8 register tile of basis[g*Q+q][c];
//   3. the 8 points' basis tiles go to shared memory and the whole block
//      contracts them against W[c, q, o] (rows = (point, g), depth =
//      (q, c)), split over the depth when there are few output columns;
//      partial sums stay in registers across channel chunks and are
//      reduced through shared memory at the end.
// pne, basis and the gathered features never reach device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 8;                 // query points per block, one per warp
constexpr int kEB = 32;                // edges staged per round, one per lane
constexpr int kCC = 32;                // input channels per chunk
constexpr int kGQMax = 64;             // G * Q columns of a pne row
constexpr int kPneStride = kGQMax + 1; // padded: lane-major writes hit distinct banks
constexpr int kOBlk = 256;             // output channels per block
constexpr int kSlab = kEB * kPneStride;  // per-warp pne slab, reused for basis

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__global__ void __launch_bounds__(kThreads, 2)
fused_equiv_fwd_kernel(const float* __restrict__ rel,    // [B,M,K,G,3]
                       const float* __restrict__ rot6,   // [B,M,K,G,F,6]
                       const float* __restrict__ feats,  // [B,N,F,C]
                       const int64_t* __restrict__ idx,  // [B,M,K]
                       const uint8_t* __restrict__ mask, // [B,M,K]
                       const float* __restrict__ proj,   // [9,Q]
                       const float* __restrict__ bias,   // [Q]
                       const float* __restrict__ w,      // [C,Q,O]
                       float* __restrict__ out,          // [B,M,G,O]
                       int M, int N, int K, int G, int F, int Q, int C, int O) {
  extern __shared__ float smem[];
  float* projS = smem;                      // [9][Q]
  float* biasS = projS + 9 * kGQMax;        // [Q]
  float* pneS = biasS + kGQMax;             // [kTM][kSlab]
  float* featS = pneS + kTM * kSlab;        // [kTM][kEB][kCC]
  int* validK = reinterpret_cast<int*>(featS + kTM * kEB * kCC);  // [kTM][K]
  int* validN = validK + kTM * K;                                  // [kTM][K]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kTM;
  const int o0 = blockIdx.y * kOBlk;
  const int m = m0 + warp;
  const int GQ = G * Q;

  for (int i = tid; i < 9 * Q; i += kThreads) projS[i] = proj[i];
  for (int i = tid; i < Q; i += kThreads) biasS[i] = bias[i];

  // Compact this warp's valid edges (out-of-range indices count as invalid).
  int nvalid = 0;
  if (m < M) {
    const size_t row = (static_cast<size_t>(b) * M + m) * K;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      int64_t n = 0;
      bool v = false;
      if (k < K) {
        n = idx[row + k];
        v = mask[row + k] != 0 && n >= 0 && n < N;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, v);
      if (v) {
        const int pos = nvalid + __popc(bal & ((1u << lane) - 1u));
        validK[warp * K + pos] = k;
        validN[warp * K + pos] = static_cast<int>(n);
      }
      nvalid += __popc(bal);
    }
  }
  const int R = kTM * G;
  const int ob = min(kOBlk, O - o0);
  // Tiles of padding rows (no valid edge at all) only write zeros.
  if (!__syncthreads_or(nvalid > 0)) {
    for (int i = tid; i < R * ob; i += kThreads) {
      const int r = i / ob, mm = m0 + r / G;
      if (mm < M) out[((static_cast<size_t>(b) * M + mm) * G + r % G) * O + o0 + i % ob] = 0.f;
    }
    return;
  }

  // Weight-stage mapping: 4x4 output micro-tiles over (row = point*G + g,
  // output column), the depth (q, c) split over the threads left over.
  const int OG = (ob + 3) / 4;
  const int MT = ((R + 3) / 4) * OG;
  const int S = kThreads / MT;
  const int mt = tid % MT, split = tid / MT;
  const bool wactive = split < S;
  const int r0 = (mt / OG) * 4, oc0 = (mt % OG) * 4;
  float acc2[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc2[a][c] = 0.f;

  const int nE = nvalid * F;
  float* pneW = pneS + warp * kSlab;
  float* featW = featS + warp * kEB * kCC;
  const int gqb = lane >> 2, cb = lane & 3;  // basis tile: gq = gqb + 8i, c = cb + 4j

  for (int c0 = 0; c0 < C; c0 += kCC) {
    const int cw = min(kCC, C - c0);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int e0 = 0; e0 < nE; e0 += kEB) {  // warp-uniform
      const int ne = min(kEB, nE - e0);
      // (1a) pne row of edge e0 + lane.
      float* prow = pneW + lane * kPneStride;
      if (lane < ne) {
        const int e = e0 + lane;
        const int j = e / F, f = e - j * F;
        const size_t base = ((static_cast<size_t>(b) * M + m) * K + validK[warp * K + j]) * G;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          if (g < G) {
            float geo[9];
            const float* r = rel + (base + g) * 3;
            const float* t = rot6 + ((base + g) * F + f) * 6;
#pragma unroll
            for (int d = 0; d < 3; ++d) geo[d] = r[d];
#pragma unroll
            for (int d = 0; d < 6; ++d) geo[3 + d] = t[d];
            for (int q = 0; q < Q; ++q) {
              float pre = biasS[q];
#pragma unroll
              for (int d = 0; d < 9; ++d) pre = fmaf(geo[d], projS[d * Q + q], pre);
              prow[g * Q + q] = gelu_erf(pre);
            }
          }
        }
        for (int gq = GQ; gq < kGQMax; ++gq) prow[gq] = 0.f;
      }
      // (1b) gathered features, lane = channel.
#pragma unroll 4
      for (int el = 0; el < ne; ++el) {
        const int e = e0 + el;
        const int j = e / F, f = e - j * F;
        float v = 0.f;
        if (lane < cw) {
          const size_t src = (static_cast<size_t>(b) * N + validN[warp * K + j]) * F + f;
          v = __ldg(feats + src * C + c0 + lane);
        }
        featW[el * kCC + lane] = v;
      }
      __syncwarp();
      // (2) basis[gq][c] += pne[e][gq] * feat[e][c].
      for (int el = 0; el < ne; ++el) {
        float p[8], x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = pneW[el * kPneStride + gqb + 8 * i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) x[jj] = featW[el * kCC + cb + 4 * jj];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(p[i], x[jj], acc[i][jj]);
      }
      __syncwarp();
    }
    // basis tile -> this warp's slab, [gq][c] with row stride kCC
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) pneW[(gqb + 8 * i) * kCC + cb + 4 * jj] = acc[i][jj];
    __syncthreads();

    // (3) out[row][o] += sum_{q, c} basis[row][q][c] * W[c0 + c][q][o0 + o]
    if (wactive) {
      const int KT = Q * cw;
      const int kb = split * KT / S, ke = (split + 1) * KT / S;
      const float* brow[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = min(r0 + a, R - 1);
        brow[a] = pneS + (r / G) * kSlab + (r % G) * Q * kCC;
      }
      for (int kk = kb; kk < ke; ++kk) {
        const int q = kk / cw, c = kk - q * cw;
        const float* wrow = w + (static_cast<size_t>(c0 + c) * Q + q) * O + o0;
        float bv[4], wv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = brow[a][q * kCC + c];
#pragma unroll
        for (int a = 0; a < 4; ++a) wv[a] = (oc0 + a < ob) ? __ldg(wrow + oc0 + a) : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc2[a][cc] = fmaf(bv[a], wv[cc], acc2[a][cc]);
      }
    }
    __syncthreads();
  }

  // Reduce the depth splits through shared memory and store.
  float* red = pneS;  // [S][MT][16] <= 256 * 16 floats
  if (wactive) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(split * MT + mt) * 16 + a * 4 + c] = acc2[a][c];
  }
  __syncthreads();
  for (int i = tid; i < R * ob; i += kThreads) {
    const int r = i / ob, o = i - r * ob;
    const int tile = (r >> 2) * OG + (o >> 2), sub = (r & 3) * 4 + (o & 3);
    float s = 0.f;
    for (int sp = 0; sp < S; ++sp) s += red[(sp * MT + tile) * 16 + sub];
    const int mm = m0 + r / G, g = r % G;
    if (mm < M) out[((static_cast<size_t>(b) * M + mm) * G + g) * O + o0 + o] = s;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).  Requires G <= 2, G*Q <= 64.
extern "C" int se3_fused_equiv_fwd(const void* rel, const void* rot6, const void* feats,
                                   const void* idx, const void* mask, const void* proj,
                                   const void* bias, const void* w, void* out, int B, int M,
                                   int N, int K, int G, int F, int Q, int C, int O,
                                   void* stream) {
  const size_t smem = sizeof(float) * (9 * kGQMax + kGQMax + kTM * kSlab + kTM * kEB * kCC) +
                      sizeof(int) * 2 * kTM * static_cast<size_t>(K);
  cudaError_t err = cudaFuncSetAttribute(
      fused_equiv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kTM - 1) / kTM, (O + kOBlk - 1) / kOBlk, B);
  fused_equiv_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rel), static_cast<const float*>(rot6),
      static_cast<const float*>(feats), static_cast<const int64_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(proj),
      static_cast<const float*>(bias), static_cast<const float*>(w), static_cast<float*>(out), M,
      N, K, G, F, Q, C, O);
  return static_cast<int>(cudaGetLastError());
}
