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
// work is split into passes that each keep their own operands on chip.
//
// Live rows only.  A query row (b, m) with no valid edge has a zero basis
// row, and its dbasis row is read by no edge, so it adds nothing to any
// output whatever gout holds there.  The padded point clouds leave most
// capacity rows without an edge (83-89% of the ScanNet level 0), so every
// pass walks a table live[L] of the rows that have one (flat b*M + m,
// ascending; built once per neighborhood by the caller), and live row r owns
// scratch rows r*G .. r*G+G-1:
//   1. basis_kernel: the forward's first half (pne in shared memory,
//      features gathered by idx/mask, basis in registers), writing basis to
//      a scratch [L*G, C*Q], and copying the live rows of gout to a compact
//      [L*G, O] beside it;
//   2. tf32x3_gemm: d_w = basis^T . gout over the L*G rows, split along
//      them into per-split partials, then sum_partials adds the splits in a
//      fixed order (deterministic: the splits depend only on L);
//   3. tf32x3_gemm: dbasis = gout . W^T, written over the basis scratch;
//   4. edge_kernel: one warp per live row recomputes pne and gelu' for its
//      valid edges, contracts them with dbasis and the gathered features,
//      adds d_feats with float32 atomics straight into [B, N, F, C]
//      (masked edges are skipped) and sums d_proj / d_bias per block;
//      sum_partials adds the blocks in a fixed order.  Given the sort tables
//      of the 'sorted' reduction (slot[b, m*K + k], the edge's position in
//      source order), the edge's row d_gathered[F*C] is stored plainly at
//      row b*M*K + slot of a zeroed [B, M*K, F*C] buffer instead of the
//      atomics (64-bit offsets: the buffer passes 2^31 floats at the ScanNet
//      shapes); the reduction is then a prefix sum (segsum_cumsum.cu) and
//      prefix differences.
//
// The two products run on tensor cores: mma.sync.m16n8k8 in TF32, in the
// 3xTF32 form (each operand split into hi = tf32(x) and lo = tf32(x - hi),
// summing lo*hi + hi*lo + hi*hi in float32), which keeps float32 accuracy
// where plain TF32 keeps about three decimal digits; each 16-deep slice is
// summed apart and added to the running sum by a rounded float32 add.
// Operand tiles are staged through shared memory by cp.async,
// double-buffered.  Passes 1 and 4 are float32 FMA.

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

// tf32x3_gemm: block tile kTI x kTJ, 8 warps of 32 x 32 (2 x 4 mma tiles)
constexpr int kGThreads = 256;
constexpr int kTI = 128;
constexpr int kTJ = 64;
constexpr int kTK = 16;                   // depth per stage, two k8 steps
constexpr int kMinSplitRows = 64;         // d_w: least rows per split

// the d_w partials aim at this many blocks in flight (4 per SM of an H100)
constexpr int kWantBlocks = 4 * 132;

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

// --- 1. basis -> scratch [L*G, C*Q], gout -> compact [L*G, O] --------------
// One warp per live row r = blockIdx.x * kBTM + warp.
__global__ void __launch_bounds__(kBThreads, 2)
basis_kernel(const float* __restrict__ rel, const float* __restrict__ rot6,
             const float* __restrict__ feats, const int64_t* __restrict__ idx,
             const uint8_t* __restrict__ mask, const float* __restrict__ proj,
             const float* __restrict__ bias, const float* __restrict__ gout,
             const int* __restrict__ live, float* __restrict__ basis,
             float* __restrict__ gout_live,
             int M, int N, int K, int G, int F, int Q, int C, int O, int L) {
  extern __shared__ float smem[];
  float* projS = smem;                       // [9][Q]
  float* biasS = projS + 9 * kGQMax;         // [Q]
  float* pneS = biasS + kGQMax;              // [kBTM][kSlab]
  float* featS = pneS + kBTM * kSlab;        // [kBTM][kEB][kCC]
  int* validK = reinterpret_cast<int*>(featS + kBTM * kEB * kCC);  // [kBTM][K]
  int* validN = validK + kBTM * K;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = blockIdx.x * kBTM + warp;
  const int GQ = G * Q;
  for (int i = tid; i < 9 * Q; i += kBThreads) projS[i] = proj[i];
  for (int i = tid; i < Q; i += kBThreads) biasS[i] = bias[i];
  __syncthreads();
  if (r >= L) return;  // whole warp; no block barrier follows

  const int flat = live[r];  // b * M + m
  const int b = flat / M;
  const size_t row = static_cast<size_t>(flat) * K;
  const size_t out_row = static_cast<size_t>(r) * G;
  const size_t GO = static_cast<size_t>(G) * O;
  for (size_t i = lane; i < GO; i += 32) gout_live[out_row * O + i] = gout[flat * GO + i];

  int* vK = validK + warp * K;
  int* vN = validN + warp * K;
  const int nE = compact_edges(idx, mask, row, K, N, lane, vK, vN) * F;
  float* pneW = pneS + warp * kSlab;
  float* featW = featS + warp * kEB * kCC;
  const int gqb = lane >> 2, cb = lane & 3;  // basis tile: gq = gqb + 8i, c = cb + 4j
  const size_t CQ = static_cast<size_t>(C) * Q;

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

// --- 2./3. C[z] = A . B over the depth slice z, on tensor cores --------------
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
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
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// One operand's kTK-deep slice of a tile into shared memory.  The operand
// X(r, k) has `R` rows (the tile's own index, r in [r0, r0 + ROWS)) and is
// summed over k in [k0, ke).  KC (depth contiguous): X(r, k) = X[r*ld + k],
// kept as [ROWS][kTK + 4]; else X(r, k) = X[k*ld + r], kept as
// [kTK][ROWS + 8].  Both pads put the mma fragment reads of one warp on 32
// distinct banks.  VEC: 16-byte copies (ld, the base and the contiguous
// extent are multiples of 4 floats); else 4-byte copies.
template <bool KC, int ROWS, bool VEC>
__device__ __forceinline__ void load_slice(float* s, const float* __restrict__ X, long long ld,
                                           int r0, int R, int k0, int ke, int tid) {
  constexpr int kStride = KC ? kTK + 4 : ROWS + 8;
  if (VEC) {
    constexpr int kChunks = ROWS * kTK / 4;
#pragma unroll
    for (int c = tid; c < kChunks; c += kGThreads) {
      int r, k;
      if (KC) { r = c / (kTK / 4); k = (c % (kTK / 4)) * 4; } else { k = c / (ROWS / 4); r = (c % (ROWS / 4)) * 4; }
      const int gr = r0 + r, gk = k0 + k;
      int bytes = 0;
      if (gr < R && gk < ke) bytes = 4 * min(4, KC ? ke - gk : R - gr);
      const float* src = bytes ? X + (KC ? gr * ld + gk : gk * ld + gr) : X;
      cp_async16(s + (KC ? r * kStride + k : k * kStride + r), src, bytes);
    }
  } else {
    constexpr int kElems = ROWS * kTK;
#pragma unroll 4
    for (int e = tid; e < kElems; e += kGThreads) {
      int r, k;
      if (KC) { r = e / kTK; k = e % kTK; } else { k = e / ROWS; r = e % ROWS; }
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < R && gk < ke;
      const float* src = ok ? X + (KC ? gr * ld + gk : gk * ld + gr) : X;
      cp_async4(s + (KC ? r * kStride + k : k * kStride + r), src, ok ? 4 : 0);
    }
  }
}

// Cout[z] (I x J, row stride ldc; z = blockIdx.z at Cout + z*sCs) =
// sum over depth k in [z*kPer, min((z+1)*kPer, Kd)) of A(i, k) * B(k, j).
// A_KC: A(i, k) = A[i*lda + k], else A[k*lda + i]; B_KC: B(k, j) =
// B[j*ldb + k], else B[k*ldb + j].  A block of 8 warps owns a kTI x kTJ
// tile; each warp a 32 x 32 piece, 2 x 4 m16n8 tiles, three mma per tile
// and k8 step (3xTF32).  The tensor cores' float32 adds do not round to
// nearest, and over thousands of rows (the d_w depth) that bias grows with
// the depth; so each kTK-deep slice is summed by the mma into a zeroed
// register tile and added to the running sum by a rounded float32 add.
// Two shared-memory stages: the next slice's cp.async copies run while
// this one's products do.  A block whose depth slice is empty writes
// zeros.  The sum order within a block is fixed, so the result depends
// only on (I, J, Kd, kPer).
template <bool A_KC, bool B_KC, bool VEC>
__global__ void __launch_bounds__(kGThreads)
tf32x3_gemm(const float* __restrict__ A, long long lda, const float* __restrict__ Bm,
            long long ldb, float* __restrict__ Cout, long long sCs, long long ldc,
            int I, int J, int Kd, int kPer) {
  constexpr int kSA = A_KC ? kTK + 4 : kTI + 8;
  constexpr int kSB = B_KC ? kTK + 4 : kTJ + 8;
  constexpr int kASize = A_KC ? kTI * kSA : kTK * kSA;
  constexpr int kBSize = B_KC ? kTJ * kSB : kTK * kSB;
  __shared__ __align__(16) float As[2][kASize];
  __shared__ __align__(16) float Bs[2][kBSize];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int wi = (warp & 3) * 32, wj = (warp >> 2) * 32;
  const int i0 = blockIdx.y * kTI, j0 = blockIdx.x * kTJ;
  const int kb = blockIdx.z * kPer, ke = min(Kd, kb + kPer);
  const int nk = ke > kb ? (ke - kb + kTK - 1) / kTK : 0;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;

  auto load = [&](int stage, int k0) {
    load_slice<A_KC, kTI, VEC>(As[stage], A, lda, i0, I, k0, ke, tid);
    load_slice<B_KC, kTJ, VEC>(Bs[stage], Bm, ldb, j0, J, k0, ke, tid);
  };
  if (nk > 0) load(0, kb);
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, kb + (kt + 1) * kTK);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // all but the newest group: slice kt is in
    __syncthreads();
    const float* as = As[kt & 1];
    const float* bs = Bs[kt & 1];
    float part[2][4][4];  // this slice's products: the mma's own adds stay short
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[mt][nt][v] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTK; ks += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = wi + mt * 16 + gid + 8 * (v & 1);
          const int k = ks + tig + 4 * (v >> 1);
          split_tf32(A_KC ? as[i * kSA + k] : as[k * kSA + i], ah[mt][v], al[mt][v]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int j = wj + nt * 8 + gid;
          const int k = ks + tig + 4 * v;
          split_tf32(B_KC ? bs[j * kSB + k] : bs[k * kSB + j], bh[nt][v], bl[nt][v]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(part[mt][nt], al[mt], bh[nt]);
          mma_tf32(part[mt][nt], ah[mt], bl[nt]);
          mma_tf32(part[mt][nt], ah[mt], bh[nt]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] += part[mt][nt][v];
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

  // accumulator v of tile (mt, nt): row gid + 8*(v >> 1), column 2*tig + (v & 1)
  float* out = Cout + blockIdx.z * sCs;
  const bool pairs = (ldc % 2 == 0) && (sCs % 2 == 0);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wi + mt * 16 + gid + 8 * h;
      if (i >= I) continue;
      float* orow = out + i * ldc;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = j0 + wj + nt * 8 + 2 * tig;
        const float x = acc[mt][nt][2 * h], y = acc[mt][nt][2 * h + 1];
        if (pairs && j + 1 < J) {
          *reinterpret_cast<float2*>(orow + j) = make_float2(x, y);
        } else {
          if (j < J) orow[j] = x;
          if (j + 1 < J) orow[j + 1] = y;
        }
      }
    }
}

template <bool A_KC, bool B_KC>
cudaError_t launch_gemm(const float* A, long long lda, const float* Bm, long long ldb, float* Cout,
                        long long sCs, long long ldc, int I, int J, int Kd, int kPer, int splits,
                        bool vec, cudaStream_t stream) {
  const dim3 grid((J + kTJ - 1) / kTJ, (I + kTI - 1) / kTI, splits);
  if (vec)
    tf32x3_gemm<A_KC, B_KC, true><<<grid, kGThreads, 0, stream>>>(A, lda, Bm, ldb, Cout, sCs, ldc,
                                                                  I, J, Kd, kPer);
  else
    tf32x3_gemm<A_KC, B_KC, false><<<grid, kGThreads, 0, stream>>>(A, lda, Bm, ldb, Cout, sCs, ldc,
                                                                   I, J, Kd, kPer);
  return cudaGetLastError();
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
// Tiles of kETM live rows, walked grid-stride; one warp per row.  d_feats
// by float32 atomics (or, with slot, each edge's row stored at its sorted
// slot), d_proj / d_bias as one [10][Q] partial per block.
__global__ void __launch_bounds__(kEThreads)
edge_kernel(const float* __restrict__ rel, const float* __restrict__ rot6,
            const float* __restrict__ feats, const int64_t* __restrict__ idx,
            const uint8_t* __restrict__ mask, const float* __restrict__ proj,
            const float* __restrict__ bias, const float* __restrict__ dbasis,
            const int* __restrict__ live, const int64_t* __restrict__ slot,
            float* __restrict__ dfeats, float* __restrict__ ppart,
            int M, int N, int K, int G, int F, int Q, int C, int L) {
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

  const int num_tiles = (L + kETM - 1) / kETM;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int r = tile * kETM + warp;
    if (r >= L) continue;  // warp-uniform
    const int flat = live[r];  // b * M + m
    const int b = flat / M;
    const size_t row = static_cast<size_t>(flat) * K;  // the original row: slot and idx
    const size_t grow = static_cast<size_t>(r) * G;    // the live row: dbasis
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

// Float offset of the compact gout rows in the scratch (16-byte aligned).
long long gout_offset(long long rows, long long cq) { return (rows * cq + 3) / 4 * 4; }

}  // namespace

// Scratch sizes the caller allocates for se3_fused_equiv_bwd, given L live
// rows (float32 elements): the basis/dbasis scratch with the compact gout
// rows, the d_w partials (w_splits of C*Q*O) and the d_proj partials
// (p_blocks of 10*Q).  The d_w splits aim at kWantBlocks blocks in flight
// with at least kMinSplitRows rows each; at least one split and one block.
extern "C" void se3_fused_equiv_bwd_plan(int L, int G, int Q, int C, int O, long long* scratch,
                                         int* w_splits, int* p_blocks) {
  const long long rows = static_cast<long long>(L) * G;
  const long long cq = static_cast<long long>(C) * Q;
  *scratch = gout_offset(rows, cq) + rows * O;
  const long long tiles = ((cq + kTI - 1) / kTI) * ((O + kTJ - 1) / kTJ);
  long long s = (kWantBlocks + tiles - 1) / tiles;
  const long long max_s = (rows + kMinSplitRows - 1) / kMinSplitRows;
  s = s < max_s ? s : max_s;
  *w_splits = static_cast<int>(s < 1 ? 1 : s);
  const long long num_tiles = (static_cast<long long>(L) + kETM - 1) / kETM;
  *p_blocks = static_cast<int>(num_tiles < 1024 ? (num_tiles < 1 ? 1 : num_tiles) : 1024);
}

// Plain C entry point for ctypes.  Launches on `stream` and returns the
// first CUDA error (0 = launched).  live is the int32 table of the L >= 1
// query rows b*M + m that have a valid edge, ascending (a row without one
// may be listed too).  d_feats must be zeroed by the caller: it is
// [B, N, F, C] when slot is null, else the [B, M*K, F*C] sorted buffer;
// d_params is [10, Q]: rows 0-8 d_proj, row 9 d_bias.  Requires G <= 2,
// G*Q <= 64 and the workspace sizes of se3_fused_equiv_bwd_plan.
extern "C" int se3_fused_equiv_bwd(const void* rel, const void* rot6, const void* feats,
                                   const void* idx, const void* mask, const void* proj,
                                   const void* bias, const void* w, const void* gout,
                                   const void* live, const void* slot, void* dfeats,
                                   void* dparams, void* dw, void* scratch, void* wpart,
                                   void* ppart, int M, int N, int K, int G, int F, int Q, int C,
                                   int O, int L, int w_splits, int p_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* relf = static_cast<const float*>(rel);
  const float* rot6f = static_cast<const float*>(rot6);
  const float* featsf = static_cast<const float*>(feats);
  const int64_t* idxp = static_cast<const int64_t*>(idx);
  const uint8_t* maskp = static_cast<const uint8_t*>(mask);
  const float* projf = static_cast<const float*>(proj);
  const float* biasf = static_cast<const float*>(bias);
  const int* livep = static_cast<const int*>(live);
  float* scr = static_cast<float*>(scratch);
  const long long rows = static_cast<long long>(L) * G;
  const int CQ = C * Q;
  float* gl = scr + gout_offset(rows, CQ);
  cudaError_t err;

  // 1. basis and the compact gout rows
  const size_t smem_b = sizeof(float) * (9 * kGQMax + kGQMax + kBTM * kSlab + kBTM * kEB * kCC) +
                        sizeof(int) * 2 * kBTM * static_cast<size_t>(K);
  err = cudaFuncSetAttribute(basis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  basis_kernel<<<(L + kBTM - 1) / kBTM, kBThreads, smem_b, stream>>>(
      relf, rot6f, featsf, idxp, maskp, projf, biasf, static_cast<const float*>(gout), livep, scr,
      gl, M, N, K, G, F, Q, C, O, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // 2. d_w[(c,q), o] = sum_rows basis[row, (c,q)] * gout[row, o], split along the rows
  int k_per = static_cast<int>((rows + w_splits - 1) / w_splits);
  k_per = ((k_per + kTK - 1) / kTK) * kTK;
  const long long nw = static_cast<long long>(CQ) * O;
  err = launch_gemm<false, false>(scr, CQ, gl, O, static_cast<float*>(wpart), nw, O, CQ, O,
                                  static_cast<int>(rows), k_per, w_splits,
                                  CQ % 4 == 0 && O % 4 == 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<static_cast<unsigned>((nw + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(wpart), w_splits, nw, static_cast<float*>(dw));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  // 3. dbasis[row, (c,q)] = sum_o gout[row, o] * W[(c,q), o], over the basis scratch
  err = launch_gemm<true, true>(gl, O, static_cast<const float*>(w), O, scr, 0, CQ,
                                static_cast<int>(rows), CQ, O, O, 1, O % 4 == 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  // 4. per-edge gradients
  const size_t smem_e = sizeof(float) * (9 * kGQMax + kGQMax + kETM * kEWarpFloats) +
                        sizeof(int) * 2 * kETM * static_cast<size_t>(K);
  err = cudaFuncSetAttribute(edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_e));
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_kernel<<<p_blocks, kEThreads, smem_e, stream>>>(
      relf, rot6f, featsf, idxp, maskp, projf, biasf, scr, livep,
      static_cast<const int64_t*>(slot), static_cast<float*>(dfeats), static_cast<float*>(ppart),
      M, N, K, G, F, Q, C, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long np = static_cast<long long>(kPRows) * Q;
  sum_partials<<<static_cast<unsigned>((np + 31) / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(ppart), p_blocks, np, static_cast<float*>(dparams));
  return static_cast<int>(cudaGetLastError());
}
