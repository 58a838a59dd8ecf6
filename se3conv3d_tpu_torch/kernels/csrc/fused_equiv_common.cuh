// Pieces shared by the fused PNE-conv forward (fused_equiv_fwd.cu) and
// backward (fused_equiv_bwd.cu), sm_90a, with float32 or bfloat16 operands
// (T) and float32 accumulation.
//
//   pre[k,g,f,q]  = P . x[b,m,k,g,f,:] + bias[q]
//   basis[g,c,q]  = sum_{k,f: mask} act(pre[k,g,f,q]) * feats[b, idx[b,m,k], f, c]
//
// x, the edge's pne inputs, come in three geometries, each a value of the
// template parameter kD:
//   kD = 9: the equivariant one, [rel[b,m,k,g,:], rot6[b,m,k,g,f,:]] (3
//           offsets in the receiver frame + the 6D relative rotation);
//   kD = 3: the standard one, the raw offsets rel[b,m,k,0,:] (G = F = 1);
//   kD = kKP: the kernel-point one (G = F = 1): the P correlation weights
//           of the edge against P kernel points, computed here from its
//           float32 raw offset (kp_weights; P <= kMaxKP at run time).
// The standard and kernel-point geometries take the 64-column capacity
// (G = F = 1, Q <= 64).  The activation act is gelu (exact, erf), relu, sin or
// the identity ("linear"), a run-time argument the same for every lane
// (the Act codes), switched outside the per-edge loops; the kernel-point
// convs of the JAX package run with the identity.
//
// - the operand types: T = float, or __nv_bfloat16, where the kernels round
//   to bfloat16 where the TPU kernel's bf16 path casts (rnd<T>: the
//   projection and bias as read, each kernel-point weight, each pne, each
//   basis entry; the geometry and features arrive rounded), and accumulate
//   in float32;
// - the per-edge helpers (edge compaction, the pne inputs, pre, each
//   activation; the backward computes its derivative beside it);
// - basis_kernel: the basis of every live query row (a row with a valid
//   edge; live[r] = b*M + m) into a scratch [L*G, C*Q] of T, live row r
//   owning scratch rows r*G .. r*G+G-1 (depth index c*Q + q, the layout of
//   W [C, Q, O]);
// - the two column capacities of a pne row (Cols<GQC>): 64 columns for
//   G <= 2 and G*Q <= 64, 128 for G <= 4 and G*Q <= 128 (the mixed frame
//   counts' F = 4); each kernel that keeps pne rows in shared memory is
//   built for both, so a G <= 2 conv keeps its footprint and occupancy;
// - tensor-core helpers (the 3xTF32 split, mma.sync tiles, the row map and
//   the paired stores); the product itself, on wgmma, is wg_product.cuh.
// Everything here sits in an anonymous namespace: each source that includes
// it builds into its own library with its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEB = 32;                   // edges per round, one per lane
constexpr int kCC = 32;                   // input channels per chunk
constexpr int kSmemMax = 232448;          // shared memory one block may use on an H100

// A pne row of GQC (g, q) columns: GQC = 64 takes G <= 2 and G*Q <= 64,
// GQC = 128 takes G <= 4 and G*Q <= 128.
template <int GQC>
struct Cols {
  static_assert(GQC == 64 || GQC == 128, "a pne row holds 64 or 128 columns");
  static constexpr int kGMax = GQC == 64 ? 2 : 4;  // out-frames
  static constexpr int kStride = GQC + 1;          // padded rows: lane-major writes hit distinct banks
  static constexpr int kSlab = kEB * kStride;      // a warp's pne rows for one round of edges
  static constexpr int kPasses = GQC / 64;         // 64-column passes of the register tiles
};

// The column capacity a conv with G out-frames and Q basis functions takes,
// or 0 past G = 4 or G*Q = 128.
inline int column_capacity(int G, int Q) {
  if (G <= 2 && G * Q <= 64) return 64;
  if (G <= 4 && G * Q <= 128) return 128;
  return 0;
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
// x rounded to the operand type T, as a float (the identity for T = float)
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// The activations of the pne (the TPU kernel's _ACTS), by run-time code.
enum Act : int { kActGelu = 0, kActRelu = 1, kActSin = 2, kActLinear = 3 };

// dst[q] = act(pre(q)) rounded to T, q < Q: one loop per activation, the
// switch outside it (act is the same for every lane).  relu takes pre from
// pre_rn, whose products and sums are each rounded on their own in order of
// d: relu's derivative steps at 0, so the kernels and their plain version
// must round pre alike for the step to fall the same way on every edge.
template <typename T, typename Pre, typename PreRn>
__device__ __forceinline__ void fill_pne(int act, int Q, float* dst, Pre pre, PreRn pre_rn) {
  switch (act) {
    case kActRelu:
      for (int q = 0; q < Q; ++q) dst[q] = rnd<T>(fmaxf(pre_rn(q), 0.f));
      break;
    case kActSin:
      for (int q = 0; q < Q; ++q) dst[q] = rnd<T>(sinf(pre(q)));
      break;
    case kActLinear:
      for (int q = 0; q < Q; ++q) dst[q] = rnd<T>(pre(q));
      break;
    default:
      for (int q = 0; q < Q; ++q) dst[q] = rnd<T>(gelu_erf(pre(q)));
  }
}

// --- the kernel-point geometry ------------------------------------------------
// kD = kKP: an edge's pne inputs are its P correlation weights against the
// kernel points kp[P][3] (se3conv3d_tpu/ops/pne_conv.py:_kp_geo_chunk, which
// the TPU kernel read as its geometry rows, with the identity activation):
//   rel_c = off_c * norm_dist       (off: the float32 raw offset p_src - p_ctr)
//   d2_p  = ((rel_0 - kp_p0)^2 + (rel_1 - kp_p1)^2 + (rel_2 - kp_p2)^2) * inv_s2
//   w_p   = exp(-d2_p / 2) (gauss), max(1 - sqrt(d2_p), 0) (linear), or the
//           one-hot of the first argmin of d2 (box),
// each w_p rounded to T.  Every operation is rounded on its own (the _rn
// intrinsics are never contracted into an FMA), in this order, so the plain
// PyTorch version computes the same weights bit for bit and the box one-hot
// picks the same point.  norm_dist is read from device memory: it is a
// calibration buffer, and reading it on the host would cost a
// synchronisation per conv.  The weights get no gradient.
constexpr int kKP = 0;       // the value of kD that selects this geometry
constexpr int kMaxKP = 64;   // kernel points a conv may have
enum Corr : int { kCorrGauss = 0, kCorrLinear = 1, kCorrBox = 2 };

struct KpGeo {
  const float* rel;        // [B, M, K, 1, 3] float32 raw offsets
  const float* points;     // [P, 3] float32 kernel points
  const float* norm_dist;  // the layer's norm_neigh_dist, one float32 on the device
  float inv_s2;            // 1 / sigma^2, rounded to float32
  int P;
  int corr;                // Corr
};

// w[p * stride] = the P weights of the edge whose raw offset is off
// (kpS: the kernel points in shared memory, [P][3]).
template <typename T>
__device__ __forceinline__ void kp_weights(const float* __restrict__ off, float nd, const float* kpS,
                                           float inv_s2, int P, int corr, float* w, int stride) {
  const float r0 = __fmul_rn(off[0], nd), r1 = __fmul_rn(off[1], nd), r2 = __fmul_rn(off[2], nd);
  float best = __int_as_float(0x7f800000);  // +inf
  int arg = 0;
  for (int p = 0; p < P; ++p) {
    const float t0 = __fsub_rn(r0, kpS[3 * p]), t1 = __fsub_rn(r1, kpS[3 * p + 1]),
                t2 = __fsub_rn(r2, kpS[3 * p + 2]);
    const float d2 = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(t0, t0), __fmul_rn(t1, t1)), __fmul_rn(t2, t2)), inv_s2);
    float v = 0.f;
    if (corr == kCorrGauss) {
      v = expf(__fmul_rn(d2, -0.5f));
    } else if (corr == kCorrLinear) {
      v = fmaxf(__fsub_rn(1.f, __fsqrt_rn(d2)), 0.f);
    } else if (d2 < best) {
      best = d2;
      arg = p;
    }
    w[p * stride] = rnd<T>(v);
  }
  if (corr == kCorrBox) w[arg * stride] = 1.f;
}

// pre = bias[q] + sum_p w[p * stride] * proj[p][q], in order of p (kRn:
// each product and sum rounded on its own, for relu).
template <bool kRn = false>
__device__ __forceinline__ float pre_kp(const float* w, int stride, const float* projS,
                                        const float* biasS, int P, int Q, int q) {
  float pre = biasS[q];
  for (int p = 0; p < P; ++p)
    pre = kRn ? __fadd_rn(pre, __fmul_rn(w[p * stride], projS[p * Q + q]))
              : fmaf(w[p * stride], projS[p * Q + q], pre);
  return pre;
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

// The kD pne inputs of edge (row + k, in-frame f) for out-frame g: the 3
// offsets and, at kD = 9, the 6D relative rotation (rot6 is not read at
// kD = 3).
template <int kD, typename T>
__device__ __forceinline__ void edge_geo(const T* __restrict__ rel, const T* __restrict__ rot6,
                                         size_t base, int g, int F, int f, float* geo) {
  static_assert(kD == 9 || kD == 3, "the pne inputs are 9 (equivariant) or 3 (standard)");
  const T* r = rel + (base + g) * 3;
#pragma unroll
  for (int d = 0; d < 3; ++d) geo[d] = to_f(r[d]);
  if constexpr (kD == 9) {
    const T* t = rot6 + ((base + g) * F + f) * 6;
#pragma unroll
    for (int d = 0; d < 6; ++d) geo[3 + d] = to_f(t[d]);
  }
}

// pre = bias[q] + sum_d geo[d] * proj[d][q], in order of d (kRn: each
// product and sum rounded on its own, for relu).
template <int kD, bool kRn = false>
__device__ __forceinline__ float pre_act(const float* geo, const float* projS,
                                         const float* biasS, int Q, int q) {
  float pre = biasS[q];
#pragma unroll
  for (int d = 0; d < kD; ++d)
    pre = kRn ? __fadd_rn(pre, __fmul_rn(geo[d], projS[d * Q + q])) : fmaf(geo[d], projS[d * Q + q], pre);
  return pre;
}

// --- basis -> scratch [L*G, C*Q] ---------------------------------------------
// One warp per live row r = blockIdx.x * warps + warp.  The warp compacts the
// row's valid edges, evaluates each edge's pne row (G*Q activations; lane e
// takes edges e, e + 32, ...) once into shared memory, then walks the input
// channels 32 at a time: per edge, lane c loads feature channel c0 + c
// (one coalesced 128-byte row), and lane (gqb, cb) adds pne[e][gqb + 8i] *
// feat[e][cb + 4j] into its NI x 8 register tile (NI = 4 covers G*Q <= 32,
// 8 covers 64), the features passed by shuffles.  A row of 128 columns
// (GQC = 128, G*Q > 64) is walked in two passes of 64 columns over the
// same pne rows: only the feature loads repeat, where one tile of 128
// columns would hold 128 accumulators a lane.  The tile goes straight
// from registers to the scratch: for one (i, j) the warp writes 4 runs of 8
// consecutive q, each a whole 32-byte sector.  The columns of a pne row past
// G*Q are never written; they only feed tile rows that are not stored.
// With kGout the warp also copies gout's row to a compact [L*G, O] of T
// (the backward).  A table entry outside [0, BM) (BM = B*M) reads nothing:
// its scratch rows are zeros, which add nothing to any product.  With T =
// bf16 the projection and bias are rounded as they are read, each pne is
// rounded before the basis sum, and the basis and gout rows are stored
// rounded (float32 sums in between).  At kD = kKP a lane first writes its
// edge's P weights to the warp's [P][32] slab (lane-major: no bank
// conflict), then its pne row from them.  kAnyAct: the activation switch
// (act); without it the kernel is gelu's alone, the code of the gelu convs
// on every recipe's path (a switch here cost the DFaust forward 2-5% on an
// H100, timed in turns with a build without it); the kernel-point
// instantiation always switches.
constexpr int kBWarps = 4;      // warps per block, fewer when K*F is large
constexpr int kBEdges = 8;      // feature loads in flight per lane

inline size_t basis_warp_bytes(int K, int F, int gqc, int kp_p) {
  return sizeof(float) * (static_cast<size_t>(K) * F * (gqc + 1) + static_cast<size_t>(kEB) * kp_p) +
         sizeof(int) * 2 * static_cast<size_t>(K);
}
// the projection [D][gqc] and bias [gqc] (and at kD = kKP the kernel points
// [P][3]), then each warp's pne rows (and weight slab) and edges; D = P at
// kD = kKP, whose kp_p is P (0 otherwise)
inline size_t basis_fixed_bytes(int gqc, int D, int kp_p) {
  return sizeof(float) * ((D + 1) * static_cast<size_t>(gqc) + 3 * static_cast<size_t>(kp_p));
}
inline size_t basis_smem(int K, int F, int gqc, int D, int warps, int kp_p) {
  return basis_fixed_bytes(gqc, D, kp_p) + warps * basis_warp_bytes(K, F, gqc, kp_p);
}
// Warps per block of basis_kernel at K neighbors x F in-frames, gqc
// columns and D pne inputs; 0 if one warp's pne rows do not fit.
inline int basis_warps(int K, int F, int gqc, int D, int kp_p) {
  const size_t room = kSmemMax - basis_fixed_bytes(gqc, D, kp_p);
  const size_t w = room / basis_warp_bytes(K, F, gqc, kp_p);
  return static_cast<int>(w < kBWarps ? w : kBWarps);
}

template <int NI, bool kGout, typename T, int GQC, int kD, bool kAnyAct>
__global__ void __launch_bounds__(32 * kBWarps, 4)
basis_kernel(const T* __restrict__ rel, const T* __restrict__ rot6,
             const T* __restrict__ feats, const int64_t* __restrict__ idx,
             const uint8_t* __restrict__ mask, const float* __restrict__ proj,
             const float* __restrict__ bias, const float* __restrict__ gout,
             const int* __restrict__ live, T* __restrict__ basis,
             T* __restrict__ gout_live,
             int M, int N, int K, int G, int F, int Q, int C, int O, int L, int BM,
             int act, KpGeo kp) {
  using Lay = Cols<GQC>;
  constexpr bool kKp = kD == kKP;
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const size_t pne_rows = static_cast<size_t>(K) * F;
  const int D = kKp ? kp.P : kD;             // pne inputs
  float* projS = smem;                       // [D][Q]
  float* biasS = projS + D * GQC;            // [Q]
  float* kpS = biasS + GQC;                  // [P][3] (kD = kKP)
  float* pneS = kpS + (kKp ? 3 * kp.P : 0);  // [warps][K*F][Lay::kStride]
  float* kpW = pneS + warps * pne_rows * Lay::kStride;  // [warps][P][32] (kD = kKP)
  int* validK = reinterpret_cast<int*>(kpW + (kKp ? warps * kEB * kp.P : 0));  // [warps][K]
  int* validN = validK + warps * K;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = blockIdx.x * warps + warp;
  const int GQ = G * Q;
  for (int i = tid; i < D * Q; i += blockDim.x) projS[i] = rnd<T>(proj[i]);
  for (int i = tid; i < Q; i += blockDim.x) biasS[i] = rnd<T>(bias[i]);
  if constexpr (kKp)
    for (int i = tid; i < 3 * kp.P; i += blockDim.x) kpS[i] = kp.points[i];
  __syncthreads();
  if (r >= L) return;  // whole warp; no block barrier follows

  const int flat = live[r];  // b * M + m
  const size_t out_row = static_cast<size_t>(r) * G;
  if (flat < 0 || flat >= BM) {
    const size_t rows_cq = static_cast<size_t>(G) * C * Q;
    for (size_t i = lane; i < rows_cq; i += 32) basis[out_row * C * Q + i] = from_f<T>(0.f);
    if (kGout)
      for (size_t i = lane; i < static_cast<size_t>(G) * O; i += 32)
        gout_live[out_row * O + i] = from_f<T>(0.f);
    return;
  }
  const int b = flat / M;
  const size_t row = static_cast<size_t>(flat) * K;
  if (kGout) {
    const size_t GO = static_cast<size_t>(G) * O;
    for (size_t i = lane; i < GO; i += 32) gout_live[out_row * O + i] = from_f<T>(gout[flat * GO + i]);
  }

  int* vK = validK + warp * K;
  int* vN = validN + warp * K;
  const int nE = compact_edges(idx, mask, row, K, N, lane, vK, vN) * F;
  float* pneW = pneS + warp * pne_rows * Lay::kStride;
  if constexpr (kKp) {  // G = F = 1
    const float nd = __ldg(kp.norm_dist);
    float* wl = kpW + warp * kEB * kp.P + lane;  // this lane's weights, stride 32
    for (int e = lane; e < nE; e += 32) {
      kp_weights<T>(kp.rel + (row + vK[e]) * 3, nd, kpS, kp.inv_s2, kp.P, kp.corr, wl, kEB);
      fill_pne<T>(act, Q, pneW + e * Lay::kStride,
                  [&](int q) { return pre_kp(wl, kEB, projS, biasS, kp.P, Q, q); },
                  [&](int q) { return pre_kp<true>(wl, kEB, projS, biasS, kp.P, Q, q); });
    }
  } else {
    for (int e = lane; e < nE; e += 32) {
      const int j = e / F, f = e - j * F;
      const size_t base = (row + vK[j]) * G;
      float* prow = pneW + e * Lay::kStride;
#pragma unroll
      for (int g = 0; g < Lay::kGMax; ++g) {
        if (g < G) {
          float geo[kD];
          edge_geo<kD>(rel, rot6, base, g, F, f, geo);
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
  }
  __syncwarp();

  const int gqb = lane >> 2, cb = lane & 3;  // tile: gq = h0 + gqb + 8i, c = cb + 4j
  const int CQ = C * Q;
  T* dst = basis + out_row * CQ;
  // the columns h0 .. h0 + 8*NI - 1 of the row's G*Q: one pass where G*Q
  // <= 64 (a constant bound: the loop unrolls away), two at 128 columns
  // (only the feature loads repeat)
  const int h_end = Lay::kPasses == 1 ? 8 * NI : GQ;
  for (int h0 = 0; h0 < h_end; h0 += 8 * NI) {
    int off[NI];  // offset of (g, q) = gq in the row's G scratch rows, or -1 past G*Q
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int gq = h0 + gqb + 8 * i, g = gq / Q;
      off[i] = gq < GQ ? g * CQ + (gq - g * Q) : -1;
    }

    for (int c0 = 0; c0 < C; c0 += kCC) {
      const int cw = min(kCC, C - c0);
      float acc[NI][8];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int e0 = 0; e0 < nE; e0 += kBEdges) {  // warp-uniform
        float v[kBEdges];
#pragma unroll
        for (int u = 0; u < kBEdges; ++u) {
          const int e = e0 + u, j = e / F, f = e - j * F;
          v[u] = 0.f;
          if (e < nE && lane < cw)
            v[u] = to_f(__ldg(feats + ((static_cast<size_t>(b) * N + vN[j]) * F + f) * C + c0 + lane));
        }
#pragma unroll
        for (int u = 0; u < kBEdges; ++u) {
          if (e0 + u >= nE) break;  // warp-uniform
          const float* prow = pneW + (e0 + u) * Lay::kStride + h0;
          float p[NI], x[8];
#pragma unroll
          for (int i = 0; i < NI; ++i) p[i] = prow[gqb + 8 * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) x[j] = __shfl_sync(0xffffffffu, v[u], cb + 4 * j);
#pragma unroll
          for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (off[i] < 0) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cb + 4 * j;
          if (c < cw) dst[off[i] + static_cast<size_t>(c0 + c) * Q] = from_f<T>(acc[i][j]);
        }
      }
    }
  }
}

// basis_kernel's instantiation for the activation switch or gelu's alone
// (any: act is not gelu; kD = kKP always switches).
template <int NI, bool kGout, typename T, int GQC, int kD>
auto basis_instance(bool any) -> decltype(&basis_kernel<NI, kGout, T, GQC, kD, true>) {
  if constexpr (kD == kKP)
    return basis_kernel<NI, kGout, T, GQC, kD, true>;
  else
    return any ? basis_kernel<NI, kGout, T, GQC, kD, true> : basis_kernel<NI, kGout, T, GQC, kD, false>;
}

// Launches basis_kernel over L live rows (the column capacity and the tile
// height from G and G*Q: the narrow tile, NI = 4, for G*Q <= 32, the wide
// one, NI = 8, for 64 columns; kD = 3 and kD = kKP, at G = 1, take Q <= 64).
template <typename T, int GQC, int kD>
cudaError_t launch_basis_cols(bool with_gout, const T* rel, const T* rot6, const T* feats,
                              const int64_t* idx, const uint8_t* mask, const float* proj,
                              const float* bias, const float* gout, const int* live, T* basis,
                              T* gout_live, int M, int N, int K, int G, int F, int Q, int C, int O,
                              int L, int BM, int act, const KpGeo& kp, cudaStream_t stream) {
  const int kp_p = kD == kKP ? kp.P : 0;
  const int D = kD == kKP ? kp.P : kD;
  const int warps = basis_warps(K, F, GQC, D, kp_p);
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = basis_smem(K, F, GQC, D, warps, kp_p);
  const bool narrow = G * Q <= 32, any = act != kActGelu;
  const auto kernel = with_gout ? (narrow ? basis_instance<4, true, T, GQC, kD>(any)
                                          : basis_instance<8, true, T, GQC, kD>(any))
                                : (narrow ? basis_instance<4, false, T, GQC, kD>(any)
                                          : basis_instance<8, false, T, GQC, kD>(any));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(L + warps - 1) / warps, 32 * warps, smem, stream>>>(
      rel, rot6, feats, idx, mask, proj, bias, gout, live, basis, gout_live, M, N, K, G, F, Q, C,
      O, L, BM, act, kp);
  return cudaGetLastError();
}

// (kD = 3 and kD = kKP: the 64-column capacity only)
template <typename T, int kD>
cudaError_t launch_basis(bool with_gout, const T* rel, const T* rot6, const T* feats,
                         const int64_t* idx, const uint8_t* mask, const float* proj,
                         const float* bias, const float* gout, const int* live, T* basis,
                         T* gout_live, int M, int N, int K, int G, int F, int Q, int C, int O,
                         int L, int BM, int act, const KpGeo& kp, cudaStream_t stream) {
  switch (column_capacity(G, Q)) {
    case 64:
      return launch_basis_cols<T, 64, kD>(with_gout, rel, rot6, feats, idx, mask, proj, bias, gout,
                                          live, basis, gout_live, M, N, K, G, F, Q, C, O, L, BM, act,
                                          kp, stream);
    case 128:
      if constexpr (kD == 9)
        return launch_basis_cols<T, 128, kD>(with_gout, rel, rot6, feats, idx, mask, proj, bias, gout,
                                             live, basis, gout_live, M, N, K, G, F, Q, C, O, L, BM,
                                             act, kp, stream);
      else
        return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// --- tensor-core helpers -----------------------------------------------------
// (the conv's product is wg_product.cuh; the probes' kernels use these)

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// cvt.rna.tf32.f32 for finite x, as an integer add and mask.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: the 3xTF32 split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a . b on one m16n8k8 TF32 tile, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copy of `bytes` (< size: the rest is zero-filled) to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// Output row of product row i: i itself, or with a live-row map (rowmap =
// live rows of this call, G rows each) rowmap[i / G] * G + i % G; -1 (not
// stored) where the map's entry lies outside [0, map_rows).
__device__ __forceinline__ long long mapped_row(const int* __restrict__ rowmap, int G,
                                                int map_rows, int i) {
  if (rowmap == nullptr) return i;
  const int r = rowmap[i / G];
  return r < 0 || r >= map_rows ? -1 : static_cast<long long>(r) * G + i % G;
}

// d += a . b on one m16n8k16 bf16 tile, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bfloat16 values in one register, x in the low half (the lower depth index).
__device__ __forceinline__ uint32_t pack_bf16(bf16 x, bf16 y) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(y)) << 16);
}

// Two neighbouring outputs of row `orow` at column j (j + 1 < J, 4-byte
// aligned when `pairs`), rounded to TO.
__device__ __forceinline__ void store_pair(float* orow, int j, int J, bool pairs, float x, float y) {
  if (pairs && j + 1 < J) {
    *reinterpret_cast<float2*>(orow + j) = make_float2(x, y);
  } else {
    if (j < J) orow[j] = x;
    if (j + 1 < J) orow[j + 1] = y;
  }
}
__device__ __forceinline__ void store_pair(bf16* orow, int j, int J, bool pairs, float x, float y) {
  if (pairs && j + 1 < J) {
    *reinterpret_cast<__nv_bfloat162*>(orow + j) = __floats2bfloat162_rn(x, y);
  } else {
    if (j < J) orow[j] = __float2bfloat16_rn(x);
    if (j + 1 < J) orow[j + 1] = __float2bfloat16_rn(y);
  }
}

}  // namespace
