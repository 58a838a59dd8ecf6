// Fused PNE-conv backward for NVIDIA Hopper (sm_90a), with float32 or
// bfloat16 operands and float32 accumulation.
//
// Forward (fused_equiv_fwd.cu), per query point (b, m), x the edge's pne
// inputs (fused_equiv_common.cuh: kD = 9 equivariant, 3 standard, kKP the
// kernel-point weights) and act gelu, relu, sin or the identity:
//   pre[k,g,f,q]  = P . x[k,g,f,:] + bias[q]
//   basis[g,c,q]  = sum_{k,f: mask} act(pre[k,g,f,q]) * feats[b, idx[b,m,k], f, c]
//   out[b,m,g,o]  = sum_{c,q} basis[g,c,q] * W[c,q,o]
// Given gout = d loss / d out, this computes
//   d_w[c,q,o]    = sum_{b,m,g} basis[g,c,q] * gout[b,m,g,o]
//   dbasis[g,c,q] = sum_o gout[b,m,g,o] * W[c,q,o]
//   d_feats[b,idx,f,c] += sum_{g,q} pne[k,g,f,q] * dbasis[g,c,q]  (valid edges only)
//   dpre[k,g,f,q] = (sum_c feat[k,f,c] * dbasis[g,c,q]) * act'(pre)
//   d_proj[d,q]   = sum dpre * x[d],  d_bias[q] = sum dpre
// with act' in closed form (gelu' = Phi(x) + x * phi(x), relu' a step with
// 0 at 0, sin' = cos, linear' = 1).  The standard (non-equivariant) conv is
// the same at G = F = 1 with the kD = 3 pne inputs, the raw offsets and no
// rot6 (se3_fused_std_bwd; d_proj [3, Q]); the kernel-point conv at G = F =
// 1 with the P weights of each edge recomputed from its float32 raw offset
// (se3_fused_kp_bwd; d_proj [P, Q]); the weights, like all geometry, get no
// gradient.
//
// Replaces the TPU Pallas kernel se3conv3d_tpu/ops/pallas/fused_equiv.py:
// _bwd_kernel (with the XLA scatter-add of the per-edge feature gradients
// that followed it, ops/pne_conv.py:_lean_equiv_bwd).  See
// se3conv3d_tpu_torch/kernels/fused_equiv.py for the wrapper, the plain
// PyTorch version and the design note.
//
// What bounds it: per query point the backward needs basis and dbasis
// ([G, C, Q], 64 KB at C=256) and, per edge, pne, act' and dpne ([G, Q];
// at kD = kKP also the P weights); at the slice's widths the per-edge tensors are several GB per
// conv if written out.  The TPU summed d_w and d_proj across a sequential
// grid in VMEM; Hopper blocks run in parallel and in no order, and d_w
// (C*Q*O floats, 8 MB at C=O=256) fits in no block's shared memory.  So the
// work is split into passes that each keep their own operands on chip.
//
// Live rows only.  A query row (b, m) with no valid edge has a zero basis
// row, and its dbasis row is read by no edge, so it adds nothing to any
// output whatever gout holds there.  The padded point clouds leave most
// capacity rows without an edge (83-89% of the ScanNet level 0), so every
// pass walks a table live[L] of the rows that have one (flat b*M + m,
// ascending; built once per neighborhood by the caller), and live row r owns
// scratch rows r*G .. r*G+G-1:
//   1. basis_kernel (fused_equiv_common.cuh, the forward's own first pass):
//      pne once per edge in shared memory, features gathered by idx/mask,
//      basis in registers, written to a scratch [L*G, C*Q]; it also copies
//      the live rows of gout to a compact [L*G, O] beside it;
//   2. wg_product (wg_product.cuh, the forward's product): d_w = basis^T .
//      gout over the L*G rows, split along them into per-split partials,
//      then sum_partials adds the splits in a fixed order (deterministic:
//      the splits depend only on L);
//   3. wg_product: dbasis = gout . W^T, written over the basis scratch, W^T
//      from an image made once a call (product_image);
//   4. edge_kernel: one warp per live row recomputes pne and act' for its
//      valid edges, contracts them with dbasis and the gathered features,
//      adds d_feats with float32 atomics straight into [B, N, F, C]
//      (masked edges are skipped) and sums d_proj / d_bias per block;
//      sum_partials adds the blocks in a fixed order (at kD = kKP the
//      [P + 1, Q] sums of a warp live in shared memory, rows of 32 columns
//      for Q <= 32 and of 64 for Q <= 64: a lane owns columns q = lane and
//      lane + 32 and adds one round of 32 edges per row at a time, where
//      P + 1 = 56 register accumulators a lane would spill).  Given the sort tables
//      of the 'sorted' reduction (slot[b, m*K + k], the edge's position in
//      source order), the edge's row d_gathered[F*C] is stored plainly at
//      row b*M*K + slot of a zeroed [B, M*K, F*C] buffer instead of the
//      atomics (64-bit offsets: the buffer passes 2^31 floats at the ScanNet
//      shapes); the reduction is then a prefix sum (segsum_cumsum.cu) and
//      prefix differences.
//
// The two products run on tensor cores: wgmma in TF32, in the 3xTF32 form
// (each operand split into hi = tf32(x) and lo = tf32(x - hi), summing
// lo*hi + hi*lo + hi*hi in float32), which keeps float32 accuracy where
// plain TF32 keeps about three decimal digits; each 16-deep slice is
// summed apart and added to the running sum by a rounded float32 add.
// Operand stages reach shared memory by cp.async.bulk through a ring of
// mbarriers (wg_product.cuh).  Passes 1 and 4 are float32 FMA.
//
// With bfloat16 operands (the TPU kernel's bf16 path, `cdt`) rel, rot6 and
// feats arrive in bfloat16 and the kernels round where the TPU kernel
// casts: the projection and bias as read, each pne, the basis and the
// compact gout rows (stored in bfloat16), dbasis (written over the basis
// scratch in bfloat16), each edge's d_gathered row (before its float32
// atomics, or stored in bfloat16 at its sorted slot) and each dpre (before
// the d_proj / d_bias sums); the products run on bfloat16 wgmma, dbasis
// over an image of W rounded to bfloat16.  Every sum is float32, as are
// d_proj, d_bias and d_w.

#include "wg_product.cuh"

namespace {

// edge_kernel
constexpr int kEThreads = 128;
constexpr int kETM = 4;                   // query points per tile, one per warp
constexpr int kRowStride = kCC + 1;       // dbasis / feature chunk rows

// edge_kernel's shared-memory layout for pne rows of GQC columns and kD pne
// inputs (kD = 3 or 9; kD = kKP sizes its geometry rows at run time).
template <int GQC, int kD>
struct EdgeCols : Cols<GQC> {
  using Base = Cols<GQC>;
  static constexpr int kPRows = kD + 1;                  // kD projection rows + the bias
  static constexpr int kGeoStride = kD * Base::kGMax + 1;  // kGMax frames x kD pne inputs, padded
  static constexpr int kWarpFloats = Base::kSlab + GQC * kRowStride + kEB * kRowStride + kEB * kGeoStride;
  static constexpr int kQLanes = GQC / 32;              // q = lane + 32h of the d_proj sums
};

// kD = kKP: an edge's geometry row holds its P weights, an odd stride
__host__ __device__ inline int kp_geo_stride(int P) { return P | 1; }
template <int GQC>
__host__ __device__ int kp_warp_floats(int P) {
  return Cols<GQC>::kSlab + GQC * kRowStride + kEB * kRowStride + kEB * kp_geo_stride(P);
}

// kD = kKP: the columns of a row of the d_proj sums in shared memory, 32
// for Q <= 32 (one q a lane), else 64 (two)
__host__ __device__ inline int kp_acc_stride(int Q) { return Q <= kEB ? kEB : 2 * kEB; }

// the projection [D][GQC] and bias [GQC] (D = P at kD = kKP, then the
// kernel points [P][3]), kETM warp slabs (at kD = kKP then the d_proj sums
// [kETM][P + 1][kp_acc_stride(Q)]), and the edge lists.  At P = 55, K = 32
// the kernel-point instantiation takes 156.8 KB at Q <= 32 and 185.5 KB at
// Q = 64, within the 227 KB of one block.
template <int GQC, int kD>
size_t edge_smem(int K, int P, int Q) {
  if (kD == kKP)
    return sizeof(float) * ((P + 1) * static_cast<size_t>(GQC) + 3 * P +
                            kETM * static_cast<size_t>(kp_warp_floats<GQC>(P)) +
                            kETM * (P + 1) * static_cast<size_t>(kp_acc_stride(Q))) +
           sizeof(int) * 2 * kETM * static_cast<size_t>(K);
  return sizeof(float) * ((kD + 1) * GQC + kETM * EdgeCols<GQC, kD>::kWarpFloats) +
         sizeof(int) * 2 * kETM * static_cast<size_t>(K);
}

// --- 4. per-edge gradients ---------------------------------------------------
// Tiles of kETM live rows, walked grid-stride; one warp per row.  d_feats
// by float32 atomics into dfeats (or, with slot, each edge's row stored at
// its sorted slot of dsorted), d_proj / d_bias as one [D + 1][Q] partial
// per block.  With T = bf16 the rows are rounded to bfloat16 first, and so is
// each dpre.  The dpne register tile covers 64 (g, q) columns: a row of 128
// (GQC = 128, G*Q > 64) takes two passes over the channel chunks, the
// second reloading the features and its dbasis columns, and adds d_feats in
// the first only.  kAnyAct: the activation switch (act); without it the
// kernel is gelu's alone, the code of the gelu convs on every recipe's path,
// which a switch in this kernel slowed by 5-10% on an H100 (timed in turns
// with a build without the switch).  The kernel-point instantiation always
// switches.
template <typename T, int GQC, int kD, bool kAnyAct>
__global__ void __launch_bounds__(kEThreads)
edge_kernel(const T* __restrict__ rel, const T* __restrict__ rot6,
            const T* __restrict__ feats, const int64_t* __restrict__ idx,
            const uint8_t* __restrict__ mask, const float* __restrict__ proj,
            const float* __restrict__ bias, const T* __restrict__ dbasis,
            const int* __restrict__ live, const int64_t* __restrict__ slot,
            float* __restrict__ dfeats, T* __restrict__ dsorted, float* __restrict__ ppart,
            int M, int N, int K, int G, int F, int Q, int C, int L, int BM, int act, KpGeo kp) {
  using Lay = EdgeCols<GQC, kD>;
  constexpr bool kKp = kD == kKP;
  static_assert(kAnyAct || !kKp, "the kernel-point instantiation switches its activation");
  constexpr int kStride = Lay::kStride, kPRows = Lay::kPRows;
  const int D = kKp ? kp.P : kD;
  const int kGeoStride = kKp ? kp_geo_stride(kp.P) : Lay::kGeoStride;
  const int warpFloats = kKp ? kp_warp_floats<GQC>(kp.P) : Lay::kWarpFloats;
  extern __shared__ float smem[];
  float* projS = smem;                       // [D][Q]
  float* biasS = projS + D * GQC;            // [Q]
  float* kpS = biasS + GQC;                  // [P][3] (kD = kKP)
  float* warpS = kpS + (kKp ? 3 * kp.P : 0);  // [kETM][warpFloats]
  const int accStride = kKp ? kp_acc_stride(Q) : 0;
  float* accS = warpS + kETM * warpFloats;   // [kETM][P + 1][accStride] (kD = kKP)
  int* validK = reinterpret_cast<int*>(accS + kETM * (kp.P + 1) * accStride);  // [kETM][K]
  int* validN = validK + kETM * K;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int GQ = G * Q;
  const size_t CQ = static_cast<size_t>(C) * Q;
  for (int i = tid; i < D * Q; i += kEThreads) projS[i] = rnd<T>(proj[i]);
  for (int i = tid; i < Q; i += kEThreads) biasS[i] = rnd<T>(bias[i]);
  if constexpr (kKp)
    for (int i = tid; i < 3 * kp.P; i += kEThreads) kpS[i] = kp.points[i];

  float* pneW = warpS + warp * warpFloats;        // [kEB][kStride]: pne, then dpne/dpre
  float* dbW = pneW + Lay::kSlab;                 // [GQC][kRowStride]: dbasis chunk [gq][c]
  float* featW = dbW + GQC * kRowStride;        // [kEB][kRowStride]: features [e][c]
  float* geoW = featW + kEB * kRowStride;       // [kEB][kGeoStride]
  float* accW = accS + warp * (kp.P + 1) * accStride;  // [P + 1][accStride] (kD = kKP)
  int* vK = validK + warp * K;
  int* vN = validN + warp * K;
  // rows gq >= G*Q of the dbasis chunk stay zero
  for (int i = GQ * kRowStride + lane; i < GQC * kRowStride; i += 32) dbW[i] = 0.f;
  if constexpr (kKp)
    for (int i = lane; i < (kp.P + 1) * accStride; i += 32) accW[i] = 0.f;
  const float nd = kKp ? __ldg(kp.norm_dist) : 0.f;
  __syncthreads();

  const int eb = lane >> 3, gb = lane & 7;  // dpne tile: e = eb + 4i, gq = h0 + gb + 8j
  float accP[Lay::kQLanes][kPRows];           // d_proj / d_bias for q = lane + 32h (kD = 3, 9)
#pragma unroll
  for (int h = 0; h < Lay::kQLanes; ++h)
#pragma unroll
    for (int d = 0; d < kPRows; ++d) accP[h][d] = 0.f;

  const int num_tiles = (L + kETM - 1) / kETM;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int r = tile * kETM + warp;
    if (r >= L) continue;  // warp-uniform
    // b * M + m; a table entry outside [0, BM) walks no edge (row 0 stands in)
    const int entry = live[r];
    const bool listed = entry >= 0 && entry < BM;
    const int flat = listed ? entry : 0;
    const int b = flat / M;
    const size_t row = static_cast<size_t>(flat) * K;  // the original row: slot and idx
    const size_t grow = static_cast<size_t>(r) * G;    // the live row: dbasis
    const int nE = listed ? compact_edges(idx, mask, row, K, N, lane, vK, vN) * F : 0;

    for (int e0 = 0; e0 < nE; e0 += kEB) {
      const int ne = min(kEB, nE - e0);
      __syncwarp();
      // geometry and pne of edge e0 + lane
      {
        float* prow = pneW + lane * kStride;
        float* grow_s = geoW + lane * kGeoStride;
        if (lane < ne) {
          const int e = e0 + lane, j = e / F, f = e - j * F;
          if constexpr (kKp) {  // G = F = 1
            kp_weights<T>(kp.rel + (row + vK[j]) * 3, nd, kpS, kp.inv_s2, kp.P, kp.corr, grow_s, 1);
            fill_pne<T>(act, Q, prow, [&](int q) { return pre_kp(grow_s, 1, projS, biasS, kp.P, Q, q); },
                        [&](int q) { return pre_kp<true>(grow_s, 1, projS, biasS, kp.P, Q, q); });
          } else {
            const size_t base = (row + vK[j]) * G;
#pragma unroll
            for (int g = 0; g < Lay::kGMax; ++g) {
              if (g < G) {
                float geo[kD];
                edge_geo<kD>(rel, rot6, base, g, F, f, geo);
#pragma unroll
                for (int d = 0; d < kD; ++d) grow_s[g * kD + d] = geo[d];
                if constexpr (kAnyAct) {
                  fill_pne<T>(act, Q, prow + g * Q,
                              [&](int q) { return pre_act<kD>(geo, projS, biasS, Q, q); },
                              [&](int q) { return pre_act<kD, true>(geo, projS, biasS, Q, q); });
                } else {
                  for (int q = 0; q < Q; ++q)
                    prow[g * Q + q] = rnd<T>(gelu_erf(pre_act<kD>(geo, projS, biasS, Q, q)));
                }
              }
            }
          }
        } else {
          for (int gq = 0; gq < GQ; ++gq) prow[gq] = 0.f;
        }
        for (int gq = GQ; gq < GQC; ++gq) prow[gq] = 0.f;
      }
      // dpne columns h0 .. h0 + 63 over every channel chunk, into the slab
      // (the pne it overwrites was read for the last time); the first
      // pass also adds the edges' feature gradients.  One pass where
      // G*Q <= 64 (a constant bound: the loop unrolls away), two at 128
      // columns (the second reloads the chunks)
      const int h_end = Lay::kPasses == 1 ? 64 : GQ;
      for (int h0 = 0; h0 < h_end; h0 += 64) {
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
                to_f(__ldg(dbasis + (grow + g) * CQ + static_cast<size_t>(c0 + c) * Q + q));
          }
          for (int el = 0; el < kEB; ++el) {
            float v = 0.f;
            if (el < ne && lane < cw) {
              const int e = e0 + el, j = e / F, f = e - j * F;
              v = to_f(__ldg(feats + ((static_cast<size_t>(b) * N + vN[j]) * F + f) * C + c0 + lane));
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
            for (int j = 0; j < 8; ++j) y[j] = dbW[(h0 + gb + 8 * j) * kRowStride + c];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) dp[i][j] = fmaf(x[i], y[j], dp[i][j]);
          }
          if (h0 > 0) continue;  // d_feats once, in the first pass
          // d_feats[e][c] += sum_gq pne[e][gq] * dbasis[gq][c]; tile e = eb + 4i, c = gb + 8j
          float df[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) df[i][j] = 0.f;
          for (int gq = 0; gq < GQ; ++gq) {
            float p[8], y[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) p[i] = pneW[(eb + 4 * i) * kStride + gq];
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
              T* dst = dsorted + (srow * F + f) * C + c0;
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int c = gb + 8 * jj;
                if (c < cw) dst[c] = from_f<T>(df[i][jj]);
              }
            } else {
              float* dst = dfeats + ((static_cast<size_t>(b) * N + vN[j]) * F + f) * C + c0;
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int c = gb + 8 * jj;
                if (c < cw) atomicAdd(dst + c, rnd<T>(df[i][jj]));
              }
            }
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) pneW[(eb + 4 * i) * kStride + h0 + gb + 8 * j] = dp[i][j];
      }
      __syncwarp();
      // dpre = dpne * act'(pre) on each lane's own edge
      if (lane < ne) {
        float* prow = pneW + lane * kStride;
        const float* grow_s = geoW + lane * kGeoStride;
        if constexpr (kKp) {
          scale_by_act_grad<T>(act, Q, prow,
                               [&](int q) { return pre_kp(grow_s, 1, projS, biasS, kp.P, Q, q); },
                               [&](int q) { return pre_kp<true>(grow_s, 1, projS, biasS, kp.P, Q, q); });
        } else {
#pragma unroll
          for (int g = 0; g < Lay::kGMax; ++g) {
            if (g < G) {
              float geo[kD];
#pragma unroll
              for (int d = 0; d < kD; ++d) geo[d] = grow_s[g * kD + d];
              if constexpr (kAnyAct) {
                scale_by_act_grad<T>(act, Q, prow + g * Q,
                                     [&](int q) { return pre_act<kD>(geo, projS, biasS, Q, q); },
                                     [&](int q) { return pre_act<kD, true>(geo, projS, biasS, Q, q); });
              } else {
                for (int q = 0; q < Q; ++q)
                  prow[g * Q + q] = rnd<T>(prow[g * Q + q] * gelu_grad(pre_act<kD>(geo, projS, biasS, Q, q)));
              }
            }
          }
        }
      }
      __syncwarp();
      // d_proj[d][q] += sum_{e,g} dpre[e][g,q] * geo[e][g,d]; d_bias[q] += sum dpre
      if constexpr (kKp) {  // G = 1: lanes q = lane, lane + 32 add each row's sum over this round
        for (int q = lane; q < Q; q += kEB) {
          for (int d = 0; d < kp.P; ++d) {
            float sum = 0.f;
            for (int el = 0; el < ne; ++el)
              sum = fmaf(pneW[el * kStride + q], geoW[el * kGeoStride + d], sum);
            accW[d * accStride + q] += sum;
          }
          float sum = 0.f;
          for (int el = 0; el < ne; ++el) sum += pneW[el * kStride + q];
          accW[kp.P * accStride + q] += sum;
        }
      } else {
#pragma unroll
        for (int h = 0; h < Lay::kQLanes; ++h) {
          const int q = lane + 32 * h;
          if (q >= Q) continue;
          for (int el = 0; el < ne; ++el) {
            for (int g = 0; g < G; ++g) {
              const float v = pneW[el * kStride + g * Q + q];
              const float* geo = geoW + el * kGeoStride + g * kD;
#pragma unroll
              for (int d = 0; d < kD; ++d) accP[h][d] = fmaf(v, geo[d], accP[h][d]);
              accP[h][kD] += v;
            }
          }
        }
      }
    }
  }

  // block partial: the warps' sums in a fixed order
  __syncthreads();
  if constexpr (kKp) {
    const int rows = kp.P + 1;
    for (int i = tid; i < rows * Q; i += kEThreads) {
      const int d = i / Q, q = i - d * Q;
      float s = 0.f;
      for (int w = 0; w < kETM; ++w) s += accS[(w * rows + d) * accStride + q];
      ppart[static_cast<size_t>(blockIdx.x) * rows * Q + i] = s;
    }
  } else {
    float* red = warpS;  // [kETM][kPRows][GQC]
#pragma unroll
    for (int h = 0; h < Lay::kQLanes; ++h) {
      const int q = lane + 32 * h;
      if (q < Q)
#pragma unroll
        for (int d = 0; d < kPRows; ++d) red[(warp * kPRows + d) * GQC + q] = accP[h][d];
    }
    __syncthreads();
    for (int i = tid; i < kPRows * Q; i += kEThreads) {
      const int d = i / Q, q = i - d * Q;
      float s = 0.f;
      for (int w = 0; w < kETM; ++w) s += red[(w * kPRows + d) * GQC + q];
      ppart[static_cast<size_t>(blockIdx.x) * kPRows * Q + i] = s;
    }
  }
}

// The passes of one backward call with operand type T in the geometry kD
// (kp: the kernel-point geometry's arguments at kD = kKP).  The scratch holds
// the basis / dbasis rows [L*G, C*Q] and the compact gout rows [L*G, O], in
// T, then the image of W^T for the dbasis product.
template <int kD, typename T>
cudaError_t backward(const T* rel, const T* rot6, const T* feats, const int64_t* idx,
                     const uint8_t* mask, const float* proj, const float* bias, const float* w,
                     const float* gout, const int* live, const int64_t* slot, void* dfeats,
                     float* dparams, float* dw, char* scratch, float* wpart, float* ppart, int B,
                     int M, int N, int K, int G, int F, int Q, int C, int O, int L, int w_splits,
                     int p_blocks, int act, const KpGeo& kp, cudaStream_t stream) {
  const int D = kD == kKP ? kp.P : kD;
  const long long rows = static_cast<long long>(L) * G;
  const int CQ = C * Q, BM = B * M;
  T* scr = reinterpret_cast<T*>(scratch);
  T* gl = reinterpret_cast<T*>(scratch + round16(rows * CQ * sizeof(T)));
  auto* img = reinterpret_cast<uint8_t*>(scratch + round16(rows * CQ * sizeof(T)) + round16(rows * O * sizeof(T)));
  cudaError_t err;

  // 1. basis and the compact gout rows
  err = launch_basis<T, kD>(true, rel, rot6, feats, idx, mask, proj, bias, gout, live, scr, gl, M, N,
                            K, G, F, Q, C, O, L, BM, act, kp, stream);
  if (err != cudaSuccess) return err;

  // 2. d_w[(c,q), o] = sum_rows basis[row, (c,q)] * gout[row, o], split along the rows
  err = product_dw<T>(scr, CQ, gl, O, dw, wpart, CQ, O, static_cast<int>(rows), w_splits, stream);
  if (err != cudaSuccess) return err;

  // 3. dbasis[row, (c,q)] = sum_o gout[row, o] * W[(c,q), o], over the basis scratch
  err = launch_product_image<T>(w, O, true, CQ, O, img, stream);
  if (err == cudaSuccess)
    err = product_dbasis<T>(gl, O, img, scr, CQ, static_cast<int>(rows), CQ, O, stream);
  if (err != cudaSuccess) return err;

  // 4. per-edge gradients, in the column capacity of G and G*Q (kD = 3 and
  // kD = kKP: 64), gelu's own instantiation for gelu (not kD = kKP)
  const bool wide = column_capacity(G, Q) == 128;
  if (wide && kD != 9) return cudaErrorInvalidValue;
  auto kernel = edge_kernel<T, 64, kD, true>;
  size_t smem_e = edge_smem<64, kD>(K, kp.P, Q);
  if constexpr (kD != kKP) {
    const bool gelu = act == kActGelu;
    if (gelu) kernel = edge_kernel<T, 64, kD, false>;
    if constexpr (kD == 9) {
      if (wide) {
        kernel = gelu ? edge_kernel<T, 128, kD, false> : edge_kernel<T, 128, kD, true>;
        smem_e = edge_smem<128, kD>(K, kp.P, Q);
      }
    }
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_e));
  if (err != cudaSuccess) return err;
  kernel<<<p_blocks, kEThreads, smem_e, stream>>>(
      rel, rot6, feats, idx, mask, proj, bias, scr, live, slot,
      slot == nullptr ? static_cast<float*>(dfeats) : nullptr,
      slot == nullptr ? nullptr : static_cast<T*>(dfeats), ppart, M, N, K, G, F, Q, C, L, BM, act,
      kp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sum_partials(ppart, p_blocks, static_cast<long long>(D + 1) * Q, dparams, stream);
}

}  // namespace

// Scratch sizes the caller allocates for se3_fused_equiv_bwd, given L live
// rows and operands of elem_bytes (4: float32, 2: bfloat16): the bytes of
// the basis/dbasis scratch with the compact gout rows and the image of W^T,
// the d_w splits (product_splits: w_splits partials of C*Q*O float32 when
// more than one) and the d_proj partials (p_blocks of (D + 1)*Q for D pne
// inputs); at least one split and one block.
extern "C" void se3_fused_equiv_bwd_plan(int L, int G, int Q, int C, int O, int elem_bytes,
                                         long long* scratch, int* w_splits, int* p_blocks) {
  const long long rows = static_cast<long long>(L) * G;
  const long long cq = static_cast<long long>(C) * Q;
  *scratch = round16(rows * cq * elem_bytes) + round16(rows * O * elem_bytes) +
             round16(product_image_bytes(static_cast<int>(cq), O, elem_bytes));
  *w_splits = product_splits(product_tiles(cq, O), rows, O, kPMaxSplits);
  const long long num_tiles = (static_cast<long long>(L) + kETM - 1) / kETM;
  *p_blocks = static_cast<int>(num_tiles < 1024 ? (num_tiles < 1 ? 1 : num_tiles) : 1024);
}

namespace {

// One backward call in the geometry kD (rot6 unread at kD = 3, rel and
// rot6 unread at kD = kKP, which reads kp).
template <int kD>
int backward_call(const void* rel, const void* rot6, const void* feats, const void* idx,
                  const void* mask, const void* proj, const void* bias, const void* w,
                  const void* gout, const void* live, const void* slot, void* dfeats,
                  void* dparams, void* dw, void* scratch, void* wpart, void* ppart, int B, int M,
                  int N, int K, int G, int F, int Q, int C, int O, int L, int w_splits,
                  int p_blocks, int use_bf16, int act, const KpGeo& kp, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* idxp = static_cast<const int64_t*>(idx);
  const auto* maskp = static_cast<const uint8_t*>(mask);
  const auto* projf = static_cast<const float*>(proj);
  const auto* biasf = static_cast<const float*>(bias);
  const auto* wf = static_cast<const float*>(w);
  const auto* goutf = static_cast<const float*>(gout);
  const auto* livep = static_cast<const int*>(live);
  const auto* slotp = static_cast<const int64_t*>(slot);
  auto* dpf = static_cast<float*>(dparams);
  auto* dwf = static_cast<float*>(dw);
  auto* scr = static_cast<char*>(scratch);
  auto* wpf = static_cast<float*>(wpart);
  auto* ppf = static_cast<float*>(ppart);
  cudaError_t err;
  if (use_bf16)
    err = backward<kD>(static_cast<const bf16*>(rel), static_cast<const bf16*>(rot6),
                       static_cast<const bf16*>(feats), idxp, maskp, projf, biasf, wf, goutf, livep,
                       slotp, dfeats, dpf, dwf, scr, wpf, ppf, B, M, N, K, G, F, Q, C, O, L,
                       w_splits, p_blocks, act, kp, stream);
  else
    err = backward<kD>(static_cast<const float*>(rel), static_cast<const float*>(rot6),
                       static_cast<const float*>(feats), idxp, maskp, projf, biasf, wf, goutf,
                       livep, slotp, dfeats, dpf, dwf, scr, wpf, ppf, B, M, N, K, G, F, Q, C, O, L,
                       w_splits, p_blocks, act, kp, stream);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` and returns
// the first CUDA error (0 = launched).  live is the int32 table of the
// L >= 1 query rows b*M + m that have a valid edge, ascending (a row
// without one may be listed too; an entry outside [0, B*M) is skipped).
// d_feats must be zeroed by the caller: it is [B, N, F, C] float32 when
// slot is null, else the [B, M*K, F*C] sorted buffer in the operand type;
// d_params is [D + 1, Q]: rows 0 .. D-1 d_proj, row D d_bias.  use_bf16 !=
// 0: rel, rot6 and feats are bfloat16, else float32; the parameters, gout,
// d_params and d_w are float32 either way.  act is the activation (Act: 0
// gelu, 1 relu, 2 sin, 3 linear).  Each requires the workspace sizes of
// se3_fused_equiv_bwd_plan for the same L, G and operand size.
//
// The equivariant conv: proj [9, Q]; G <= 4, G*Q <= 128 (column_capacity).
extern "C" int se3_fused_equiv_bwd(const void* rel, const void* rot6, const void* feats,
                                   const void* idx, const void* mask, const void* proj,
                                   const void* bias, const void* w, const void* gout,
                                   const void* live, const void* slot, void* dfeats,
                                   void* dparams, void* dw, void* scratch, void* wpart,
                                   void* ppart, int B, int M, int N, int K, int G, int F, int Q,
                                   int C, int O, int L, int w_splits, int p_blocks, int use_bf16,
                                   int act, void* stream_ptr) {
  if (column_capacity(G, Q) == 0) return static_cast<int>(cudaErrorInvalidValue);
  return backward_call<9>(rel, rot6, feats, idx, mask, proj, bias, w, gout, live, slot, dfeats,
                          dparams, dw, scratch, wpart, ppart, B, M, N, K, G, F, Q, C, O, L,
                          w_splits, p_blocks, use_bf16, act, KpGeo{}, stream_ptr);
}

// The standard conv: rel [B, M, K, 1, 3], feats [B, N, 1, C], proj [3, Q],
// gout [B, M, 1, O]; G = F = 1 and Q <= 64.
extern "C" int se3_fused_std_bwd(const void* rel, const void* feats, const void* idx,
                                 const void* mask, const void* proj, const void* bias,
                                 const void* w, const void* gout, const void* live,
                                 const void* slot, void* dfeats, void* dparams, void* dw,
                                 void* scratch, void* wpart, void* ppart, int B, int M, int N,
                                 int K, int Q, int C, int O, int L, int w_splits, int p_blocks,
                                 int use_bf16, int act, void* stream_ptr) {
  if (Q > 64) return static_cast<int>(cudaErrorInvalidValue);
  return backward_call<3>(rel, nullptr, feats, idx, mask, proj, bias, w, gout, live, slot, dfeats,
                          dparams, dw, scratch, wpart, ppart, B, M, N, K, 1, 1, Q, C, O, L,
                          w_splits, p_blocks, use_bf16, act, KpGeo{}, stream_ptr);
}

// The kernel-point conv: rel [B, M, K, 1, 3] float32 raw offsets whatever
// use_bf16, points [P, 3] float32, norm_dist one float32, proj [P, Q],
// feats [B, N, 1, C], gout [B, M, 1, O], d_params [P + 1, Q]; G = F = 1,
// Q <= 64, P <= kMaxKP; inv_s2 = 1 / sigma^2, corr the correlation (Corr:
// 0 gauss, 1 linear, 2 box).
extern "C" int se3_fused_kp_bwd(const void* rel, const void* points, const void* norm_dist,
                                const void* feats, const void* idx, const void* mask,
                                const void* proj, const void* bias, const void* w,
                                const void* gout, const void* live, const void* slot,
                                void* dfeats, void* dparams, void* dw, void* scratch, void* wpart,
                                void* ppart, int B, int M, int N, int K, int P, int Q, int C, int O,
                                int L, int w_splits, int p_blocks, int use_bf16, int act,
                                float inv_s2, int corr, void* stream_ptr) {
  if (Q > 64 || P < 1 || P > kMaxKP || corr < kCorrGauss || corr > kCorrBox)
    return static_cast<int>(cudaErrorInvalidValue);
  const KpGeo kp{static_cast<const float*>(rel), static_cast<const float*>(points),
                 static_cast<const float*>(norm_dist), inv_s2, P, corr};
  return backward_call<kKP>(nullptr, nullptr, feats, idx, mask, proj, bias, w, gout, live, slot,
                            dfeats, dparams, dw, scratch, wpart, ppart, B, M, N, K, 1, 1, Q, C, O,
                            L, w_splits, p_blocks, use_bf16, act, kp, stream_ptr);
}
