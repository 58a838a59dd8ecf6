// Fused equivariant PNE-conv backward for NVIDIA Hopper (sm_90a), float32.
//
// Forward (fused_equiv_fwd.cu), per query point (b, m):
//   pre[k,g,f,q]  = P . [rel[b,m,k,g,:], rot6[b,m,k,g,f,:]] + bias[q]
//   basis[g,c,q]  = sum_{k,f: mask} gelu(pre[k,g,f,q]) * feats[b, idx[b,m,k], f, c]
//   out[b,m,g,o]  = sum_{c,q} basis[g,c,q] * W[c,q,o]
// Given gout = d loss / d out, this computes
//   d_w[c,q,o]    = sum_{b,m,g} basis[g,c,q] * gout[b,m,g,o]
//   dbasis[g,c,q] = sum_o gout[b,m,g,o] * W[c,q,o]
//   d_feats[b,idx,f,c] += sum_{g,q} pne[k,g,f,q] * dbasis[g,c,q]  (valid edges only)
//   dpre[k,g,f,q] = (sum_c feat[k,f,c] * dbasis[g,c,q]) * gelu'(pre)
//   d_proj[d,q]   = sum dpre * geo[d],  d_bias[q] = sum dpre
// with gelu'(x) = Phi(x) + x * phi(x) in closed form.
//
// Replaces the TPU Pallas kernel se3conv3d_tpu/ops/pallas/fused_equiv.py:
// _bwd_kernel (with the XLA scatter-add of the per-edge feature gradients
// that followed it, ops/pne_conv.py:_lean_equiv_bwd).  See
// se3conv3d_tpu_torch/kernels/fused_equiv.py for the wrapper, the plain
// PyTorch version and the design note.
//
// What bounds it: per query point the backward needs basis and dbasis
// ([G, C, Q], 64 KB at C=256) and, per edge, pne, gelu' and dpne
// ([G, Q]); at the slice's widths the per-edge tensors are several GB per
// conv if written out.  The TPU summed d_w and d_proj across a sequential
// grid in VMEM; Hopper blocks run in parallel and in no order, and d_w
// (C*Q*O floats, 8 MB at C=O=256) fits in no block's shared memory.  So the
// work is split into passes that each keep their own operands on chip:
//   1. basis_kernel: the forward's first half (pne in shared memory,
//      features gathered by idx/mask, basis in registers), writing basis to
//      a scratch [B*M*G, C*Q] in device memory;
//   2. gemm_kernel: d_w = basis^T . gout as a tiled SIMT product, split
//      along the B*M*G rows into per-split partials, then sum_partials
//      adds the splits in a fixed order (deterministic);
//   3. gemm_kernel: dbasis = gout . W^T, written over the same scratch;
//   4. edge_kernel: one warp per query point recomputes pne and gelu' for
//      its valid edges, contracts them with dbasis and the gathered
//      features, adds d_feats with float32 atomics straight into
//      [B, N, F, C] (masked edges are skipped) and sums d_proj / d_bias per
//      block; sum_partials adds the blocks in a fixed order.  Given the
//      sort tables of the 'sorted' reduction (slot[b, m*K + k], the edge's
//      position in source order), the edge's row d_gathered[F*C] is stored
//      plainly at row b*M*K + slot of a zeroed [B, M*K, F*C] buffer instead
//      of the atomics (64-bit offsets: the buffer passes 2^31 floats at the
//      ScanNet shapes); the reduction is then a prefix sum
//      (segsum_cumsum.cu) and prefix differences.
// Float32 FMA throughout: no tensor cores, no TMA, no wgmma yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGQMax = 64;                // G * Q columns of a pne row
constexpr int kEB = 32;                   // edges per round, one per lane
constexpr int kCC = 32;                   // input channels per chunk
constexpr int kPneStride = kGQMax + 1;    // padded rows: lane-major writes hit distinct banks
constexpr int kSlab = kEB * kPneStride;   // per-warp pne slab

// basis_kernel
constexpr int kBThreads = 256;
constexpr int kBTM = 8;                   // query points per block, one per warp

// edge_kernel
constexpr int kEThreads = 128;
constexpr int kETM = 4;                   // query points per tile, one per warp
constexpr int kRowStride = kCC + 1;       // dbasis / feature chunk rows
constexpr int kGeoStride = 19;            // 2 frames x 9 pne inputs, padded
constexpr int kEWarpFloats = kSlab + kGQMax * kRowStride + kEB * kRowStride + kEB * kGeoStride;
constexpr int kPRows = 10;                // 9 projection rows + the bias

// gemm_kernel
constexpr int kGThreads = 256;
constexpr int kGT = 64;                   // output tile kGT x kGT, 4x4 per thread
constexpr int kGK = 16;                   // depth per stage

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  return cdf + x * 0.39894228040143268f * expf(-0.5f * x * x);
}

// Warp-cooperative compaction of the valid edges of one query row
// (out-of-range indices count as invalid); returns their number.
__device__ int compact_edges(const int64_t* __restrict__ idx, const uint8_t* __restrict__ mask,
                             size_t row, int K, int N, int lane, int* validK, int* validN) {
  int nvalid = 0;
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
      validK[pos] = k;
      validN[pos] = static_cast<int>(n);
    }
    nvalid += __popc(bal);
  }
  __syncwarp();
  return nvalid;
}

// The 9 pne inputs of edge (row + k, in-frame f) for out-frame g.
__device__ __forceinline__ void edge_geo(const float* __restrict__ rel,
                                         const float* __restrict__ rot6, size_t base, int g,
                                         int F, int f, float* geo) {
  const float* r = rel + (base + g) * 3;
  const float* t = rot6 + ((base + g) * F + f) * 6;
#pragma unroll
  for (int d = 0; d < 3; ++d) geo[d] = r[d];
#pragma unroll
  for (int d = 0; d < 6; ++d) geo[3 + d] = t[d];
}

__device__ __forceinline__ float pre_act(const float* geo, const float* projS,
                                         const float* biasS, int Q, int q) {
  float pre = biasS[q];
#pragma unroll
  for (int d = 0; d < 9; ++d) pre = fmaf(geo[d], projS[d * Q + q], pre);
  return pre;
}

// --- 1. basis -> scratch [B*M*G, C*Q] ---------------------------------------
__global__ void __launch_bounds__(kBThreads, 2)
basis_kernel(const float* __restrict__ rel, const float* __restrict__ rot6,
             const float* __restrict__ feats, const int64_t* __restrict__ idx,
             const uint8_t* __restrict__ mask, const float* __restrict__ proj,
             const float* __restrict__ bias, float* __restrict__ basis,
             int M, int N, int K, int G, int F, int Q, int C) {
  extern __shared__ float smem[];
  float* projS = smem;                       // [9][Q]
  float* biasS = projS + 9 * kGQMax;         // [Q]
  float* pneS = biasS + kGQMax;              // [kBTM][kSlab]
  float* featS = pneS + kBTM * kSlab;        // [kBTM][kEB][kCC]
  int* validK = reinterpret_cast<int*>(featS + kBTM * kEB * kCC);  // [kBTM][K]
  int* validN = validK + kBTM * K;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kBTM + warp;
  const int GQ = G * Q;
  for (int i = tid; i < 9 * Q; i += kBThreads) projS[i] = proj[i];
  for (int i = tid; i < Q; i += kBThreads) biasS[i] = bias[i];
  __syncthreads();
  if (m >= M) return;  // whole warp; no block barrier follows

  const size_t row = (static_cast<size_t>(b) * M + m) * K;
  int* vK = validK + warp * K;
  int* vN = validN + warp * K;
  const int nE = compact_edges(idx, mask, row, K, N, lane, vK, vN) * F;
  float* pneW = pneS + warp * kSlab;
  float* featW = featS + warp * kEB * kCC;
  const int gqb = lane >> 2, cb = lane & 3;  // basis tile: gq = gqb + 8i, c = cb + 4j
  const size_t CQ = static_cast<size_t>(C) * Q;
  const size_t out_row = (static_cast<size_t>(b) * M + m) * G;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    const int cw = min(kCC, C - c0);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int e0 = 0; e0 < nE; e0 += kEB) {
      const int ne = min(kEB, nE - e0);
      float* prow = pneW + lane * kPneStride;
      if (lane < ne) {
        const int e = e0 + lane, j = e / F, f = e - j * F;
        const size_t base = (row + vK[j]) * G;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          if (g < G) {
            float geo[9];
            edge_geo(rel, rot6, base, g, F, f, geo);
            for (int q = 0; q < Q; ++q) prow[g * Q + q] = gelu_erf(pre_act(geo, projS, biasS, Q, q));
          }
        }
        for (int gq = GQ; gq < kGQMax; ++gq) prow[gq] = 0.f;
      }
#pragma unroll 4
      for (int el = 0; el < ne; ++el) {
        const int e = e0 + el, j = e / F, f = e - j * F;
        float v = 0.f;
        if (lane < cw) v = __ldg(feats + ((static_cast<size_t>(b) * N + vN[j]) * F + f) * C + c0 + lane);
        featW[el * kCC + lane] = v;
      }
      __syncwarp();
      for (int el = 0; el < ne; ++el) {
        float p[8], x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = pneW[el * kPneStride + gqb + 8 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = featW[el * kCC + cb + 4 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
      }
      __syncwarp();
    }
    // basis tile -> pne slab as [gq][c], then out to the scratch as [g][c][q]
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) pneW[(gqb + 8 * i) * kCC + cb + 4 * j] = acc[i][j];
    __syncwarp();
    for (int i = lane; i < G * cw * Q; i += 32) {
      const int q = i % Q, t = i / Q, c = t % cw, g = t / cw;
      basis[(out_row + g) * CQ + static_cast<size_t>(c0 + c) * Q + q] = pneW[(g * Q + q) * kCC + c];
    }
    __syncwarp();
  }
}

// --- 2./3. C[s] = A . B over the depth slice s --------------------------------
// A(i, k) = A[i*sAi + k*sAk], B(k, j) = B[k*sBk + j*sBj]; one of each pair
// of strides is 1 (it picks the coalesced load order).  Block z sums depth
// [z*kPer, min((z+1)*kPer, Kd)) into Cout + z*sCs, rows of stride ldc.
__global__ void __launch_bounds__(kGThreads)
gemm_kernel(const float* __restrict__ A, long long sAi, long long sAk,
            const float* __restrict__ Bm, long long sBk, long long sBj,
            float* __restrict__ Cout, long long sCs, long long ldc,
            int I, int J, int Kd, int kPer) {
  __shared__ __align__(16) float As[kGK][kGT + 4];
  __shared__ __align__(16) float Bs[kGK][kGT + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * kGT, j0 = blockIdx.x * kGT;
  const int kb = blockIdx.z * kPer, ke = min(Kd, kb + kPer);
  const bool aKfast = sAk == 1, bJfast = sBj == 1;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kGK) {
#pragma unroll
    for (int l = 0; l < (kGT * kGK) / kGThreads; ++l) {
      const int e = tid + kGThreads * l;
      int ii, kk;
      if (aKfast) { kk = e & (kGK - 1); ii = e / kGK; } else { ii = e & (kGT - 1); kk = e / kGT; }
      int gi = i0 + ii, gk = k0 + kk;
      As[kk][ii] = (gi < I && gk < ke) ? __ldg(A + gi * sAi + gk * sAk) : 0.f;
      int jj;
      if (bJfast) { jj = e & (kGT - 1); kk = e / kGT; } else { kk = e & (kGK - 1); jj = e / kGK; }
      const int gj = j0 + jj;
      gk = k0 + kk;
      Bs[kk][jj] = (gj < J && gk < ke) ? __ldg(Bm + gk * sBk + gj * sBj) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bw[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* out = Cout + blockIdx.z * sCs;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty * 4 + r;
    if (gi >= I) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tx * 4 + c;
      if (gj < J) out[gi * ldc + gj] = acc[r][c];
    }
  }
}

// out[i] = sum_{s < S} part[s * n + i], in order of s (deterministic).
// Block (32, 8): lanes take 32 neighbouring i, the 8 rows stride over s.
__global__ void sum_partials(const float* __restrict__ part, int S, long long n,
                             float* __restrict__ out) {
  __shared__ float red[8][33];
  const long long i = blockIdx.x * 32LL + threadIdx.x;
  float s = 0.f;
  if (i < n)
    for (int p = threadIdx.y; p < S; p += 8) s += part[p * n + i];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += red[y][threadIdx.x];
    out[i] = t;
  }
}

// --- 4. per-edge gradients ---------------------------------------------------
// Tiles of kETM query points of one batch element, walked grid-stride; one
// warp per point.  d_feats by float32 atomics (or, with slot, each edge's
// row stored at its sorted slot), d_proj / d_bias as one [10][Q] partial per
// block.
__global__ void __launch_bounds__(kEThreads)
edge_kernel(const float* __restrict__ rel, const float* __restrict__ rot6,
            const float* __restrict__ feats, const int64_t* __restrict__ idx,
            const uint8_t* __restrict__ mask, const float* __restrict__ proj,
            const float* __restrict__ bias, const float* __restrict__ dbasis,
            const int64_t* __restrict__ slot, float* __restrict__ dfeats,
            float* __restrict__ ppart,
            int M, int N, int K, int G, int F, int Q, int C, int num_tiles, int m_tiles) {
  extern __shared__ float smem[];
  float* projS = smem;                       // [9][Q]
  float* biasS = projS + 9 * kGQMax;         // [Q]
  float* warpS = biasS + kGQMax;             // [kETM][kEWarpFloats]
  int* validK = reinterpret_cast<int*>(warpS + kETM * kEWarpFloats);  // [kETM][K]
  int* validN = validK + kETM * K;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int GQ = G * Q;
  const size_t CQ = static_cast<size_t>(C) * Q;
  for (int i = tid; i < 9 * Q; i += kEThreads) projS[i] = proj[i];
  for (int i = tid; i < Q; i += kEThreads) biasS[i] = bias[i];

  float* pneW = warpS + warp * kEWarpFloats;    // [kEB][kPneStride]: pne, then dpne/dpre
  float* dbW = pneW + kSlab;                    // [kGQMax][kRowStride]: dbasis chunk [gq][c]
  float* featW = dbW + kGQMax * kRowStride;     // [kEB][kRowStride]: features [e][c]
  float* geoW = featW + kEB * kRowStride;       // [kEB][kGeoStride]
  int* vK = validK + warp * K;
  int* vN = validN + warp * K;
  // rows gq >= G*Q of the dbasis chunk stay zero
  for (int i = GQ * kRowStride + lane; i < kGQMax * kRowStride; i += 32) dbW[i] = 0.f;
  __syncthreads();

  const int eb = lane >> 3, gb = lane & 7;  // dpne tile: e = eb + 4i, gq = gb + 8j
  float accP[2][kPRows];                    // d_proj / d_bias for q = lane, lane + 32
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int d = 0; d < kPRows; ++d) accP[h][d] = 0.f;

  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int b = tile / m_tiles;
    const int m = (tile - b * m_tiles) * kETM + warp;
    if (m >= M) continue;  // warp-uniform
    const size_t row = (static_cast<size_t>(b) * M + m) * K;
    const size_t grow = (static_cast<size_t>(b) * M + m) * G;
    const int nE = compact_edges(idx, mask, row, K, N, lane, vK, vN) * F;

    for (int e0 = 0; e0 < nE; e0 += kEB) {
      const int ne = min(kEB, nE - e0);
      __syncwarp();
      // geometry and pne of edge e0 + lane
      {
        float* prow = pneW + lane * kPneStride;
        float* grow_s = geoW + lane * kGeoStride;
        if (lane < ne) {
          const int e = e0 + lane, j = e / F, f = e - j * F;
          const size_t base = (row + vK[j]) * G;
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            if (g < G) {
              float geo[9];
              edge_geo(rel, rot6, base, g, F, f, geo);
#pragma unroll
              for (int d = 0; d < 9; ++d) grow_s[g * 9 + d] = geo[d];
              for (int q = 0; q < Q; ++q) prow[g * Q + q] = gelu_erf(pre_act(geo, projS, biasS, Q, q));
            }
          }
        } else {
          for (int gq = 0; gq < GQ; ++gq) prow[gq] = 0.f;
        }
        for (int gq = GQ; gq < kGQMax; ++gq) prow[gq] = 0.f;
      }

      float dp[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dp[i][j] = 0.f;

      for (int c0 = 0; c0 < C; c0 += kCC) {
        const int cw = min(kCC, C - c0);
        __syncwarp();
        // dbasis chunk [gq][c] of this point, and the gathered features [e][c]
        for (int i = lane; i < G * cw * Q; i += 32) {
          const int q = i % Q, t = i / Q, c = t % cw, g = t / cw;
          dbW[(g * Q + q) * kRowStride + c] =
              __ldg(dbasis + (grow + g) * CQ + static_cast<size_t>(c0 + c) * Q + q);
        }
        for (int el = 0; el < kEB; ++el) {
          float v = 0.f;
          if (el < ne && lane < cw) {
            const int e = e0 + el, j = e / F, f = e - j * F;
            v = __ldg(feats + ((static_cast<size_t>(b) * N + vN[j]) * F + f) * C + c0 + lane);
          }
          featW[el * kRowStride + lane] = v;
        }
        __syncwarp();
        // dpne[e][gq] += sum_c feat[e][c] * dbasis[gq][c]
        for (int c = 0; c < cw; ++c) {
          float x[8], y[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = featW[(eb + 4 * i) * kRowStride + c];
#pragma unroll
          for (int j = 0; j < 8; ++j) y[j] = dbW[(gb + 8 * j) * kRowStride + c];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) dp[i][j] = fmaf(x[i], y[j], dp[i][j]);
        }
        // d_feats[e][c] += sum_gq pne[e][gq] * dbasis[gq][c]; tile e = eb + 4i, c = gb + 8j
        float df[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) df[i][j] = 0.f;
        for (int gq = 0; gq < GQ; ++gq) {
          float p[8], y[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) p[i] = pneW[(eb + 4 * i) * kPneStride + gq];
#pragma unroll
          for (int j = 0; j < 4; ++j) y[j] = dbW[gq * kRowStride + gb + 8 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) df[i][j] = fmaf(p[i], y[j], df[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int el = eb + 4 * i;
          if (el >= ne) continue;
          const int e = e0 + el, j = e / F, f = e - j * F;
          if (slot != nullptr) {
            const size_t srow = static_cast<size_t>(b) * M * K + slot[row + vK[j]];
            float* dst = dfeats + (srow * F + f) * C + c0;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int c = gb + 8 * jj;
              if (c < cw) dst[c] = df[i][jj];
            }
          } else {
            float* dst = dfeats + ((static_cast<size_t>(b) * N + vN[j]) * F + f) * C + c0;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int c = gb + 8 * jj;
              if (c < cw) atomicAdd(dst + c, df[i][jj]);
            }
          }
        }
      }
      __syncwarp();
      // dpne -> slab, then dpre = dpne * gelu'(pre) on each lane's own edge
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) pneW[(eb + 4 * i) * kPneStride + gb + 8 * j] = dp[i][j];
      __syncwarp();
      if (lane < ne) {
        float* prow = pneW + lane * kPneStride;
        const float* grow_s = geoW + lane * kGeoStride;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          if (g < G) {
            float geo[9];
#pragma unroll
            for (int d = 0; d < 9; ++d) geo[d] = grow_s[g * 9 + d];
            for (int q = 0; q < Q; ++q)
              prow[g * Q + q] *= gelu_grad(pre_act(geo, projS, biasS, Q, q));
          }
        }
      }
      __syncwarp();
      // d_proj[d][q] += sum_{e,g} dpre[e][g,q] * geo[e][g,d]; d_bias[q] += sum dpre
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = lane + 32 * h;
        if (q >= Q) continue;
        for (int el = 0; el < ne; ++el) {
          for (int g = 0; g < G; ++g) {
            const float v = pneW[el * kPneStride + g * Q + q];
            const float* geo = geoW + el * kGeoStride + g * 9;
#pragma unroll
            for (int d = 0; d < 9; ++d) accP[h][d] = fmaf(v, geo[d], accP[h][d]);
            accP[h][9] += v;
          }
        }
      }
    }
  }

  // block partial: the warps' sums in a fixed order
  __syncthreads();
  float* red = warpS;  // [kETM][kPRows][kGQMax]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = lane + 32 * h;
    if (q < Q)
#pragma unroll
      for (int d = 0; d < kPRows; ++d) red[(warp * kPRows + d) * kGQMax + q] = accP[h][d];
  }
  __syncthreads();
  for (int i = tid; i < kPRows * Q; i += kEThreads) {
    const int d = i / Q, q = i - d * Q;
    float s = 0.f;
    for (int w = 0; w < kETM; ++w) s += red[(w * kPRows + d) * kGQMax + q];
    ppart[static_cast<size_t>(blockIdx.x) * kPRows * Q + i] = s;
  }
}

}  // namespace

// Scratch sizes the caller allocates for se3_fused_equiv_bwd (float32
// elements): basis/dbasis scratch, d_w partials, d_proj partials.
extern "C" void se3_fused_equiv_bwd_plan(int B, int M, int G, int Q, int C, int O,
                                         long long* scratch, int* w_splits, int* p_blocks) {
  const long long rows = static_cast<long long>(B) * M * G;
  const long long cq = static_cast<long long>(C) * Q;
  *scratch = rows * cq;
  const long long tiles = ((cq + kGT - 1) / kGT) * ((O + kGT - 1) / kGT);
  long long s = (4 * 132 + tiles - 1) / tiles;                 // ~4 blocks per SM
  s = s < 1 ? 1 : s;
  const long long max_s = (rows + 4 * kGK - 1) / (4 * kGK);    // >= 64 rows per split
  *w_splits = static_cast<int>(s < max_s ? s : (max_s < 1 ? 1 : max_s));
  const long long num_tiles = static_cast<long long>(B) * ((M + kETM - 1) / kETM);
  *p_blocks = static_cast<int>(num_tiles < 1024 ? (num_tiles < 1 ? 1 : num_tiles) : 1024);
}

// Plain C entry point for ctypes.  Launches on `stream` and returns the
// first CUDA error (0 = launched).  d_feats must be zeroed by the caller: it
// is [B, N, F, C] when slot is null, else the [B, M*K, F*C] sorted buffer;
// d_params is [10, Q]: rows 0-8 d_proj, row 9 d_bias.  Requires G <= 2,
// G*Q <= 64 and the workspace sizes of se3_fused_equiv_bwd_plan.
extern "C" int se3_fused_equiv_bwd(const void* rel, const void* rot6, const void* feats,
                                   const void* idx, const void* mask, const void* proj,
                                   const void* bias, const void* w, const void* gout,
                                   const void* slot, void* dfeats, void* dparams, void* dw,
                                   void* scratch, void* wpart, void* ppart, int B, int M, int N,
                                   int K, int G,
                                   int F, int Q, int C, int O, int w_splits, int p_blocks,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* relf = static_cast<const float*>(rel);
  const float* rot6f = static_cast<const float*>(rot6);
  const float* featsf = static_cast<const float*>(feats);
  const int64_t* idxp = static_cast<const int64_t*>(idx);
  const uint8_t* maskp = static_cast<const uint8_t*>(mask);
  const float* projf = static_cast<const float*>(proj);
  const float* biasf = static_cast<const float*>(bias);
  const float* goutf = static_cast<const float*>(gout);
  float* scr = static_cast<float*>(scratch);
  const long long rows = static_cast<long long>(B) * M * G;
  const int CQ = C * Q;
  cudaError_t err;

  // 1. basis
  const size_t smem_b = sizeof(float) * (9 * kGQMax + kGQMax + kBTM * kSlab + kBTM * kEB * kCC) +
                        sizeof(int) * 2 * kBTM * static_cast<size_t>(K);
  err = cudaFuncSetAttribute(basis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  basis_kernel<<<dim3((M + kBTM - 1) / kBTM, B), kBThreads, smem_b, stream>>>(
      relf, rot6f, featsf, idxp, maskp, projf, biasf, scr, M, N, K, G, F, Q, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // 2. d_w[(c,q), o] = sum_rows basis[row, (c,q)] * gout[row, o], split along the rows
  const int rows_i = static_cast<int>(rows);
  int k_per = static_cast<int>((rows + w_splits - 1) / w_splits);
  k_per = ((k_per + kGK - 1) / kGK) * kGK;
  gemm_kernel<<<dim3((O + kGT - 1) / kGT, (CQ + kGT - 1) / kGT, w_splits), kGThreads, 0, stream>>>(
      scr, 1, CQ, goutf, O, 1, static_cast<float*>(wpart), static_cast<long long>(CQ) * O, O, CQ,
      O, rows_i, k_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long nw = static_cast<long long>(CQ) * O;
  sum_partials<<<static_cast<unsigned>((nw + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(wpart), w_splits, nw, static_cast<float*>(dw));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // 3. dbasis[row, (c,q)] = sum_o gout[row, o] * W[(c,q), o], over the basis scratch
  gemm_kernel<<<dim3((CQ + kGT - 1) / kGT, static_cast<unsigned>((rows + kGT - 1) / kGT), 1),
                kGThreads, 0, stream>>>(goutf, O, 1, static_cast<const float*>(w), 1, O, scr, 0,
                                        CQ, rows_i, CQ, O, O);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // 4. per-edge gradients
  const int m_tiles = (M + kETM - 1) / kETM;
  const size_t smem_e = sizeof(float) * (9 * kGQMax + kGQMax + kETM * kEWarpFloats) +
                        sizeof(int) * 2 * kETM * static_cast<size_t>(K);
  err = cudaFuncSetAttribute(edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_e));
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_kernel<<<p_blocks, kEThreads, smem_e, stream>>>(
      relf, rot6f, featsf, idxp, maskp, projf, biasf, scr, static_cast<const int64_t*>(slot),
      static_cast<float*>(dfeats),
      static_cast<float*>(ppart), M, N, K, G, F, Q, C, B * m_tiles, m_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long np = static_cast<long long>(kPRows) * Q;
  sum_partials<<<static_cast<unsigned>((np + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(ppart), p_blocks, np, static_cast<float*>(dparams));
  return static_cast<int>(cudaGetLastError());
}
