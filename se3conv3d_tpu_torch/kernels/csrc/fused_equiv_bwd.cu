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
//   4. edge_kernel: a block of 4 warps walks the live rows one at a time,
//      recomputes pne and act' of their valid edges (from one pre),
//      contracts them with dbasis and the gathered features on tensor
//      cores, adds d_feats with float32 vector atomics straight into [B,
//      N, F, C] (masked edges are skipped) and sums d_proj / d_bias in
//      registers per block (a product dpre^T . [geo, 1]); sum_partials
//      adds the blocks in a fixed order.  Given the sort tables of the
//      'sorted' reduction (slot[b, m*K + k], the edge's position in source
//      order), the edge's row d_gathered[F*C] is stored plainly at row
//      b*M*K + slot of a zeroed [B, M*K, F*C] buffer instead of the atomics
//      (64-bit offsets: the buffer passes 2^31 floats at the ScanNet
//      shapes); the reduction is then a prefix sum (segsum_cumsum.cu) and
//      prefix differences.
//
// The two products run on tensor cores: wgmma in TF32, in the 3xTF32 form
// (each operand split into hi = tf32(x) and lo = tf32(x - hi), summing
// lo*hi + hi*lo + hi*hi in float32), which keeps float32 accuracy where
// plain TF32 keeps about three decimal digits; each 16-deep slice is
// summed apart and added to the running sum by a rounded float32 add.
// Operand stages reach shared memory by cp.async.bulk through a ring of
// mbarriers (wg_product.cuh).  Pass 1 is float32 FMA.
//
// What bounds pass 4: at the ScanNet level 0 (3.15M edges, C = 64, G*Q =
// 32) its dpne and d_feats products take 12.9 GFLOP each, pne and d_proj
// about 2 each, and it reads the dbasis scratch (1.07 GB in float32, 0.54
// in bf16), the geometry (~0.14 GB) and ~34 MB of gathered features: bytes
// bound it, at ~0.38 ms (float32) and ~0.20 ms (bf16) on an H100.  The
// design keeps every per-edge tensor on chip, runs the products on
// mma.sync (a row has 24-64 edges and its own dbasis, too few rows for a
// 64-row wgmma tile), brings each unit's dbasis and features in by
// cp.async while the unit before multiplies, and fits 4 blocks an SM at
// the recipes' shapes (EdgeLayout); its block barriers (three to five a
// unit) and the per-round pne step run in series with the products.
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

// --- 4. per-edge gradients: edge_kernel --------------------------------------
// A block of 4 warps takes one live row at a time (rows blockIdx.x,
// blockIdx.x + gridDim.x, ...: a fixed walk, so the d_proj partials are the
// same bits from call to call).  A row's valid edges (E = valid k x F) go in
// rounds of kEB = 32 edges, two m-tiles of 16, and each round over chunks of
// kCC = 32 channels; a unit (row, round, chunk) stages the chunk's dbasis
// [c][gq] and the round's gathered features [e][c] by 16-byte cp.async
// into one of kEStages ring stages while the block multiplies the unit
// before.  At a round's first chunk each thread computes pne = act(pre) and
// act'(pre) from one pre at the (edge, gq) places of its own dpne
// accumulators: pne into shared memory, act' kept in registers.  Per unit:
//   dpne[e][gq]    += feat[e][c] . dbasis[c][gq]   (warp w: the n-tiles w, w + 4, ...)
//   d_gathered[e][c] = pne[e][gq] . dbasis[c][gq]^T (warp w: channels 8w .. 8w + 7)
// the latter rounded to T and added with float4 atomics into d_feats (or
// stored at its sorted slot, 16 bytes a lane).  At a round's last chunk
//   dpre = rnd(dpne * act')  (into shared memory, over the pne)
//   [d_proj; d_bias][d][q] += [geo; 1]^T[d][e] . dpre[e][g*Q + q]  over e, g
// in accumulators each thread keeps across the whole walk; at the end each
// (d, q) is stored by the one thread that holds it as the block's partial.
// Every product is mma.sync: float32 in 3xTF32 (m16n8k8, lo.hi + hi.lo +
// hi.hi), bfloat16 on m16n8k16; each 16-deep slice goes into a zeroed
// accumulator, then is added to the running sum in float32.
//
// Shared-memory rows are padded so that every fragment load is free of bank
// conflicts: dbasis and pne / dpre rows take gqs values (edge_gq_stride: 4
// mod 32 words in float32, an odd number of 16-byte units in bfloat16), the
// feature and transposed-geometry rows 40.  In float32 the dpne and d_proj
// products read their A fragments as float2 pairs: their k slots t and t +
// 4 of each 8-deep step hold the depth indices 2t and 2t + 1 (a permutation
// of the contracted index, the same in A and B).  bfloat16 reads dpne's B
// fragments with ldmatrix.trans.
constexpr int kEThreads = 128;                     // 4 warps
constexpr int kEStages = 2;                        // the ring's stages
constexpr int kEFStride = kCC + 8;                 // a staged feature row: 40 values of T
constexpr int kEGStride = kEB + 8;                 // a row [e] of the transposed geometry: 40 floats
constexpr int kEBlocksPerSM = 4;
constexpr int kEGrid = kPSlots * kEBlocksPerSM;    // the walk's blocks: 4 an SM of an H100

// The row stride (values of T) of the staged dbasis [c][gq] and of the pne
// / dpre rows [e][gq]: G*Q rounded up to 32, plus 4 (float32) or 8 (bf16).
__host__ __device__ inline int edge_gq_stride(int elem_bytes, int GQ) {
  return (GQ + 31) / 32 * 32 + (elem_bytes == 4 ? 4 : 8);
}
// Rows of one frame's transposed geometry: the D pne inputs and a ones row
// (the bias), padded to whole m-tiles of 16.
__host__ __device__ inline int edge_geo_rows(int D) { return (D + 16) / 16 * 16; }
__host__ __device__ inline int align16(int x) { return (x + 15) / 16 * 16; }

// edge_kernel's dynamic shared memory, byte offsets: kEStages ring stages
// (the dbasis chunk [kCC][gqs], then the features [kEB][kEFStride], in T),
// pne / dpre [kEB][gqs] in T, three buffers (by round: the next row's
// first round is staged while the current one's is read) of the transposed
// geometry [G][geo_rows][kEGStride] in float32, the projection [D][Q] and
// bias [Q] rounded to T, the kernel points [P][3] (kD = kKP), the g and q of
// each column gq, three buffers (by row) of the valid edges' k and source
// index [2][K], and the next row's table entry and edge count.
struct EdgeLayout {
  int gqs, geo_rows, feat, stage_bytes, pne, geo, geo_bytes, proj, bias, kpts, gqmap, vbuf, ctl, total;
};
__host__ __device__ inline EdgeLayout edge_layout(int elem_bytes, int D, int G, int Q, int K, int kp_p) {
  EdgeLayout l;
  l.gqs = edge_gq_stride(elem_bytes, G * Q);
  l.geo_rows = edge_geo_rows(D);
  l.feat = align16(elem_bytes * kCC * l.gqs);
  l.stage_bytes = l.feat + align16(elem_bytes * kEB * kEFStride);
  l.pne = kEStages * l.stage_bytes;
  l.geo = l.pne + align16(elem_bytes * kEB * l.gqs);
  l.geo_bytes = align16(4 * G * l.geo_rows * kEGStride);
  l.proj = l.geo + 3 * l.geo_bytes;
  l.bias = l.proj + align16(4 * D * Q);
  l.kpts = l.bias + align16(4 * Q);
  l.gqmap = l.kpts + align16(4 * 3 * kp_p);
  l.vbuf = l.gqmap + align16(4 * G * Q);
  l.ctl = l.vbuf + align16(4 * 3 * 2 * K);
  l.total = l.ctl + 16;
  return l;
}

// Blocks of edge_kernel an SM may hold: 4 where the pne rows hold 64
// columns (launch bounds of 128 registers a thread), 2 at 128 and at the
// kernel points (their accumulators take more registers); fewer where
// shared memory runs out (228 KB an SM, 1 KB of it reserved a block).
constexpr int edge_min_blocks(int gqc, int kd) { return gqc == 64 && kd != kKP ? 4 : 2; }
__host__ __device__ inline int edge_blocks_per_sm(int total, int gqc, int kd) {
  const int fit = 233472 / (total + 1024);
  const int want = edge_min_blocks(gqc, kd);
  return fit < want ? fit : want;
}

// n / d for 0 <= n < 2^31 by a multiply-high (d >= 1, fixed for a launch).
struct DivU {
  unsigned mul, shr, d;
  __device__ void init(int den) {
    d = den, mul = 0, shr = 0;
    if (den > 1) {
      int l = 0;
      while ((1u << l) < static_cast<unsigned>(den)) ++l;  // ceil(log2 den)
      mul = static_cast<unsigned>(((1ull << (31 + l)) + den - 1) / den);
      shr = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), mul) >> shr);
  }
};

// pne = act(pre) rounded to T and act'(pre) in float32, in the closed forms
// of the TPU kernel's _act_and_grad, from one pre: gelu takes one erff and
// one expf for both (gelu_erf's expression, and Phi + x phi); relu takes pre
// from pre_rn (fill_pne), its derivative a step with 0 at 0.
template <typename T, bool kAnyAct, typename Pre, typename PreRn>
__device__ __forceinline__ void pne_and_grad(int act, Pre pre, PreRn pre_rn, float& pne, float& grad) {
  const int a = kAnyAct ? act : static_cast<int>(kActGelu);
  if (a == kActRelu) {
    const float x = pre_rn();
    pne = rnd<T>(fmaxf(x, 0.f));
    grad = x > 0.f ? 1.f : 0.f;
    return;
  }
  const float x = pre();
  if (a == kActSin) {
    pne = rnd<T>(sinf(x));
    grad = cosf(x);
  } else if (a == kActLinear) {
    pne = rnd<T>(x);
    grad = 1.f;
  } else {
    const float e = erff(x * 0.70710678118654752f);
    pne = rnd<T>(0.5f * x * (1.0f + e));
    grad = 0.5f * (1.0f + e) + x * 0.39894228040143268f * expf(-0.5f * x * x);
  }
}

// d += a . b in 3xTF32 (lo.hi + hi.lo + hi.hi) on one m16n8k8 tile
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah, const uint32_t* al,
                                           const uint32_t* bh, const uint32_t* bl) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// the 3xTF32 split (split_tf32) of N values
template <int N>
__device__ __forceinline__ void split_n(const float* x, uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// b0, b1 of an m16n8k16 B fragment from a [k][n] bf16 tile in shared memory
// (rows k0 .. k0 + 15 at p + (lane & 15) * stride)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* b, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(b[0]), "=r"(b[1]) : "r"(a));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory"); }

__device__ __forceinline__ void store2(float* p, float x, float y) { *reinterpret_cast<float2*>(p) = make_float2(x, y); }
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Tiles of a warp: the dpne n-tiles w, w + 4, ... of the pne columns (and
// the d_proj n-tiles of q), kNT of them; the d_proj m-tiles of [D + 1]: one
// (D <= 15) or, at the kernel points, five (P + 1 <= 65).
template <int GQC, int kD>
struct EdgeTiles {
  static constexpr int kNT = GQC / 32;
  static constexpr int kPM = kD == kKP ? 5 : 1;
  static constexpr int kMinBlocks = edge_min_blocks(GQC, kD);
};

// The kernel.  d_feats by float32 atomics into dfeats (or, with slot, each
// edge's row stored at its sorted slot of dsorted), d_proj / d_bias as one
// [D + 1][Q] partial per block.  With T = bf16 the rows are rounded to
// bfloat16 first, and so is each dpre.  kAnyAct: the activation switch
// (act); without it the kernel is gelu's alone.  The kernel-point
// instantiation always switches.
template <typename T, int GQC, int kD, bool kAnyAct>
__global__ void __launch_bounds__(kEThreads, EdgeTiles<GQC, kD>::kMinBlocks)
edge_kernel(const T* __restrict__ rel, const T* __restrict__ rot6,
            const T* __restrict__ feats, const int64_t* __restrict__ idx,
            const uint8_t* __restrict__ mask, const float* __restrict__ proj,
            const float* __restrict__ bias, const T* __restrict__ dbasis,
            const int* __restrict__ live, const int64_t* __restrict__ slot,
            float* __restrict__ dfeats, T* __restrict__ dsorted, float* __restrict__ ppart,
            int M, int N, int K, int G, int F, int Q, int C, int L, int BM, int act, KpGeo kp) {
  using Tiles = EdgeTiles<GQC, kD>;
  constexpr bool kKp = kD == kKP, kF32 = sizeof(T) == 4;
  static_assert(kAnyAct || !kKp, "the kernel-point instantiation switches its activation");
  constexpr int kNT = Tiles::kNT, kPM = Tiles::kPM;
  constexpr int kVec = 16 / sizeof(T);          // values of T in 16 bytes
  const int D = kKp ? kp.P : kD;
  const int GQ = G * Q;
  const size_t CQ = static_cast<size_t>(C) * Q;
  const EdgeLayout lay = edge_layout(sizeof(T), D, G, Q, K, kKp ? kp.P : 0);
  const int gqs = lay.gqs, DR = lay.geo_rows;
  extern __shared__ __align__(16) unsigned char edge_smem[];
  unsigned char* smem = edge_smem;
  T* pS = reinterpret_cast<T*>(smem + lay.pne);
  float* projS = reinterpret_cast<float*>(smem + lay.proj);
  float* biasS = reinterpret_cast<float*>(smem + lay.bias);
  float* kpS = reinterpret_cast<float*>(smem + lay.kpts);
  int* gqS = reinterpret_cast<int*>(smem + lay.gqmap);   // g << 16 | q of column gq
  int* vbuf = reinterpret_cast<int*>(smem + lay.vbuf);   // [3][2][K]: valid k, source index
  int* ctl = reinterpret_cast<int*>(smem + lay.ctl);     // the next row: index, edges, entry, geometry staged

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, r4 = lane >> 2, t4 = lane & 3;
  // the ring stages, pne and geometry start zero: their padding stays so
  for (int i = tid; i < lay.proj / 16; i += kEThreads) reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < D * Q; i += kEThreads) projS[i] = rnd<T>(proj[i]);
  for (int i = tid; i < Q; i += kEThreads) biasS[i] = rnd<T>(bias[i]);
  if constexpr (kKp)
    for (int i = tid; i < 3 * kp.P; i += kEThreads) kpS[i] = kp.points[i];
  for (int i = tid; i < GQ; i += kEThreads) gqS[i] = (i / Q) << 16 | (i % Q);
  const float nd = kKp ? __ldg(kp.norm_dist) : 0.f;
  DivU divF;
  divF.init(F);
  // the staging of dbasis: lane (cs, p) copies the 16-byte piece p of the
  // G*Q columns of rows c = cs + rpi * (warp + 4i) of a chunk
  const bool vec_db = (Q * static_cast<int>(sizeof(T))) % 16 == 0;
  const bool vec_f = (C * static_cast<int>(sizeof(T))) % 16 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const int npc = vec_db ? GQ / kVec : 1, rpi = 32 / npc;
  const int dcs = lane / npc, dp = lane - dcs * npc;
  const int dg = vec_db ? dp / (Q / kVec) : 0;
  const size_t dsrc = vec_db ? dg * CQ + static_cast<size_t>(dp - dg * (Q / kVec)) * kVec : 0;
  const bool quad4 = C % 4 == 0;  // 4 channels of an output row in one vector
  // one frame, one in-frame, at most 32 neighbors: a row's edges and their
  // geometry come in one pass over its neighbors (find)
  const bool quick = G == 1 && F == 1 && K <= 32;

  float dacc[kPM][kNT][4];
#pragma unroll
  for (int pm = 0; pm < kPM; ++pm)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) dacc[pm][j][i] = 0.f;
  float acc[2][kNT][4], ag[2][kNT][4];

  // warp 0: the first live row from `from` on (step gridDim.x) with a valid
  // edge, compacted into vbuf[buf]; ctl = (its index or L, its edges, its
  // table entry, 1 where its first round's transposed geometry is in geo).
  // With `quick` each lane loads one neighbor's index, mask and geometry
  // together, and the valid ones write their geometry at their place.
  auto find = [&](int from, int buf, float* geo) {
    int* vK = vbuf + buf * 2 * K;
    int r = from, n = 0, entry = 0;
    for (; r < L; r += gridDim.x) {
      entry = live[r];
      if (entry < 0 || entry >= BM) continue;  // an entry outside [0, BM) walks no edge
      const size_t row = static_cast<size_t>(entry) * K;
      if (quick) {
        int64_t nn = 0;
        bool v = false;
        float gv[kKp ? 1 : kD];
        if (lane < K) {
          nn = idx[row + lane];
          v = mask[row + lane] != 0 && nn >= 0 && nn < N;
          if constexpr (!kKp) edge_geo<kD>(rel, rot6, row + lane, 0, 1, 0, gv);
        }
        const unsigned bal = __ballot_sync(0xffffffffu, v);
        n = __popc(bal);
        if (v) {
          const int pos = __popc(bal & ((1u << lane) - 1u));
          vK[pos] = lane;
          vK[K + pos] = static_cast<int>(nn);
          float* gw = geo + pos;
          if constexpr (kKp) {
            kp_weights<T>(kp.rel + (row + lane) * 3, nd, kpS, kp.inv_s2, kp.P, kp.corr, gw, kEGStride);
          } else {
#pragma unroll
            for (int d = 0; d < kD; ++d) gw[d * kEGStride] = gv[d];
          }
          gw[D * kEGStride] = 1.f;
        }
        if (lane >= n)
          for (int d = 0; d <= D; ++d) geo[d * kEGStride + lane] = 0.f;
        __syncwarp();
      } else {
        n = compact_edges(idx, mask, row, K, N, lane, vK, vK + K);
      }
      if (n > 0) break;
    }
    if (lane == 0) {
      ctl[0] = r < L ? r : L;
      ctl[1] = r < L ? n * F : 0;
      ctl[2] = entry;
      ctl[3] = quick;
    }
  };

  // the loads of unit (row r of table entry `entry`, round rd, chunk ch) into ring stage st
  auto issue = [&](int r, int entry, int buf, int rd, int nE, int ch, int st) {
    T* dbS = reinterpret_cast<T*>(smem + st * lay.stage_bytes);
    T* fS = reinterpret_cast<T*>(smem + st * lay.stage_bytes + lay.feat);
    const int c0 = ch * kCC, cw = min(kCC, C - c0);
    const T* src = dbasis + static_cast<size_t>(r) * G * CQ + static_cast<size_t>(c0) * Q;
    if (vec_db) {
      if (dcs < rpi)
        for (int c = dcs + rpi * warp; c < kCC; c += 4 * rpi)
          cp_async16(dbS + c * gqs + dp * kVec, c < cw ? src + dsrc + static_cast<size_t>(c) * Q : dbasis,
                     c < cw ? 16 : 0);
    } else {
      for (int i = tid; i < kCC * GQ; i += kEThreads) {
        const int c = i / GQ, gq = i - c * GQ, g = gqS[gq] >> 16, q = gqS[gq] & 0xffff;
        dbS[c * gqs + gq] = c < cw ? src[g * CQ + static_cast<size_t>(c) * Q + q] : from_f<T>(0.f);
      }
    }
    const int b = entry / M;
    const int* vN = vbuf + buf * 2 * K + K;
    const int ne = min(kEB, nE - rd * kEB);
    constexpr int ppr = kCC / kVec;  // 16-byte pieces of a feature row
    for (int i = tid; i < kEB * ppr; i += kEThreads) {
      const int e = i / ppr, cc = (i % ppr) * kVec;
      const T* fsrc = feats;
      int bytes = 0;
      if (e < ne) {
        const int ea = rd * kEB + e, j = divF.div(ea), f = ea - j * F;
        fsrc = feats + ((static_cast<size_t>(b) * N + vN[j]) * F + f) * C + c0 + cc;
        bytes = max(0, min(kVec, cw - cc)) * static_cast<int>(sizeof(T));
      }
      if (vec_f) {
        cp_async16(fS + e * kEFStride + cc, bytes ? fsrc : feats, bytes);
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          fS[e * kEFStride + cc + x] = x * static_cast<int>(sizeof(T)) < bytes ? fsrc[x] : from_f<T>(0.f);
      }
    }
  };

  // the walk's state: row rr (table entry flat, nE edges, edges in vbuf[seq
  // % 3], first round's geometry staged by find), round rd (geometry in
  // buffer rs % 3), chunk ch, ring stage st
  if (warp == 0) find(blockIdx.x, 0, reinterpret_cast<float*>(smem + lay.geo));
  __syncthreads();
  int rr = ctl[0], nE = ctl[1], flat = ctl[2], staged = ctl[3];
  int seq = 0, rs = 0, rd = 0, ch = 0, st = 0;
  const int nch = (C + kCC - 1) / kCC;
  if (rr < L) issue(rr, flat, 0, 0, nE, 0, 0);
  cp_commit();

  while (rr < L) {
    const int buf = seq % 3;
    const int* vK = vbuf + buf * 2 * K;
    const int* vN = vK + K;
    const int b = flat / M;
    const size_t row = static_cast<size_t>(flat) * K;
    const int ne = min(kEB, nE - rd * kEB);
    const bool last_chunk = ch + 1 == nch, last_round = (rd + 1) * kEB >= nE;
    const int mts = ne > 16 ? 2 : 1;  // live m-tiles of the round
    float* geoS = reinterpret_cast<float*>(smem + lay.geo + (rs % 3) * lay.geo_bytes);
    if (last_chunk && last_round && warp == 0)
      find(rr + gridDim.x, (seq + 1) % 3, reinterpret_cast<float*>(smem + lay.geo + ((rs + 1) % 3) * lay.geo_bytes));
    if (ch == 0 && !(rd == 0 && staged)) {  // the round's transposed geometry [g][d][e]: D inputs, then 1 (0 past ne)
      if constexpr (kKp) {
        if (warp == 0) {
          if (lane < ne) {
            kp_weights<T>(kp.rel + (row + vK[rd * kEB + lane]) * 3, nd, kpS, kp.inv_s2, kp.P, kp.corr,
                          geoS + lane, kEGStride);
            geoS[kp.P * kEGStride + lane] = 1.f;
          } else {
            for (int d = 0; d <= kp.P; ++d) geoS[d * kEGStride + lane] = 0.f;
          }
        }
      } else if (warp < G) {
        float* gw = geoS + warp * DR * kEGStride + lane;
        if (lane < ne) {
          const int ea = rd * kEB + lane, j = divF.div(ea), f = ea - j * F;
          float geo[kD];
          edge_geo<kD>(rel, rot6, (row + vK[j]) * G, warp, F, f, geo);
#pragma unroll
          for (int d = 0; d < kD; ++d) gw[d * kEGStride] = geo[d];
          gw[kD * kEGStride] = 1.f;
        } else {
#pragma unroll
          for (int d = 0; d <= kD; ++d) gw[d * kEGStride] = 0.f;
        }
      }
    }
    __syncthreads();
    // the next unit, whose loads go out now
    int nr = rr, nnE = nE, nflat = flat, nstaged = staged, nseq = seq, nrd = rd, nch2 = ch + 1;
    if (last_chunk) {
      nch2 = 0;
      if (last_round) {
        nr = ctl[0], nnE = ctl[1], nflat = ctl[2], nstaged = ctl[3], nseq = seq + 1, nrd = 0;
      } else {
        nrd = rd + 1;
      }
    }
    if (nr < L) issue(nr, nflat, nseq % 3, nrd, nnE, nch2, st ^ 1);
    cp_commit();

    if (ch == 0) {  // pne and act' at this thread's dpne places; pne into shared memory
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn) {
        const int n0 = (warp + 4 * jn) * 8;
        if (n0 >= GQ) break;
        float pv[2][2][2];  // [mt][h][c]: every value of the column pair before its stores
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // one column at a time: its projection read once
          const int gq = n0 + 2 * t4 + c;
          const int g = gq < GQ ? gqS[gq] >> 16 : 0, q = gq < GQ ? gqS[gq] & 0xffff : 0;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = mt * 16 + r4 + 8 * h;
              float p = 0.f, a = 0.f;
              if (mt < mts && e < ne && gq < GQ) {
                if constexpr (kKp) {
                  const float* w = geoS + e;
                  pne_and_grad<T, true>(act, [&] { return pre_kp(w, kEGStride, projS, biasS, kp.P, Q, q); },
                                        [&] { return pre_kp<true>(w, kEGStride, projS, biasS, kp.P, Q, q); }, p, a);
                } else {
                  float geo[kD];
#pragma unroll
                  for (int d = 0; d < kD; ++d) geo[d] = geoS[(g * DR + d) * kEGStride + e];
                  pne_and_grad<T, kAnyAct>(act, [&] { return pre_act<kD>(geo, projS, biasS, Q, q); },
                                           [&] { return pre_act<kD, true>(geo, projS, biasS, Q, q); }, p, a);
                }
              }
              pv[mt][h][c] = p;
              ag[mt][jn][2 * h + c] = a;
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= mts) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) store2(pS + (mt * 16 + r4 + 8 * h) * gqs + n0 + 2 * t4, pv[mt][h][0], pv[mt][h][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][jn][i] = 0.f;
        }
      }
    }
    cp_wait<1>();
    __syncthreads();

    const T* dbS = reinterpret_cast<const T*>(smem + st * lay.stage_bytes);
    const T* fS = reinterpret_cast<const T*>(smem + st * lay.stage_bytes + lay.feat);
    const int c0 = ch * kCC, cw = min(kCC, C - c0);
    // dpne[e][gq] += sum_c feat[e][c] dbasis[c][gq], slices of 16 channels;
    // each B fragment split once for both m-tiles
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn) {
      const int n0 = (warp + 4 * jn) * 8;
      if (n0 >= GQ) break;
      for (int k16 = 0; k16 < cw; k16 += 16) {
        float s[2][4] = {};
        if constexpr (kF32) {
#pragma unroll
          for (int k0 = k16; k0 < k16 + 16; k0 += 8) {
            const float bv[2] = {dbS[(k0 + 2 * t4) * gqs + n0 + r4], dbS[(k0 + 2 * t4 + 1) * gqs + n0 + r4]};
            uint32_t bh[2], bl[2];
            split_n<2>(bv, bh, bl);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (mt >= mts) break;
              const float* fa = fS + (mt * 16 + r4) * kEFStride + k0 + 2 * t4;
              const float2 x = *reinterpret_cast<const float2*>(fa);
              const float2 y = *reinterpret_cast<const float2*>(fa + 8 * kEFStride);
              const float av[4] = {x.x, y.x, x.y, y.y};
              uint32_t ah[4], al[4];
              split_n<4>(av, ah, al);
              mma_3xtf32(s[mt], ah, al, bh, bl);
            }
          }
        } else {
          uint32_t bb[2];
          ldsm_x2_trans(bb, dbS + (k16 + (lane & 15)) * gqs + n0);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= mts) break;
            const T* fa = fS + (mt * 16 + r4) * kEFStride + k16 + 2 * t4;
            const uint32_t a[4] = {ld_u32(fa), ld_u32(fa + 8 * kEFStride), ld_u32(fa + 8), ld_u32(fa + 8 * kEFStride + 8)};
            mma_bf16(s[mt], a, bb);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][jn][i] += s[mt][i];
      }
    }

    // d_gathered[e][c] = sum_gq pne[e][gq] dbasis[c][gq], channels 8 * warp ..;
    // each B fragment split once for both m-tiles
    if (warp * 8 < cw) {
      const int cc0 = warp * 8;
      const T* bq = dbS + (cc0 + r4) * gqs;
      float dfs[2][4] = {};
      for (int k16 = 0; k16 < GQ; k16 += 16) {
        float s[2][4] = {};
        if constexpr (kF32) {
#pragma unroll
          for (int k0 = k16; k0 < k16 + 16; k0 += 8) {
            if (k0 >= GQ) break;
            const float bv[2] = {bq[k0 + t4], bq[k0 + t4 + 4]};
            uint32_t bh[2], bl[2];
            split_n<2>(bv, bh, bl);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (mt >= mts) break;
              const T* pa = pS + (mt * 16 + r4) * gqs + k0 + t4;
              const float av[4] = {pa[0], pa[8 * gqs], pa[4], pa[8 * gqs + 4]};
              uint32_t ah[4], al[4];
              split_n<4>(av, ah, al);
              mma_3xtf32(s[mt], ah, al, bh, bl);
            }
          }
        } else {
          const uint32_t bb[2] = {ld_u32(bq + k16 + 2 * t4), ld_u32(bq + k16 + 8 + 2 * t4)};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= mts) break;
            const T* pa = pS + (mt * 16 + r4) * gqs + k16 + 2 * t4;
            const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * gqs), ld_u32(pa + 8), ld_u32(pa + 8 * gqs + 8)};
            mma_bf16(s[mt], a, bb);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) dfs[mt][i] += s[mt][i];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= mts) break;
        const float* df = dfs[mt];
        // rounded to T; lane pairs trade so that each lane holds 4
        // neighbouring channels of one edge row (even t4: row r4, odd: r4 + 8)
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = rnd<T>(df[i]);
        const bool odd = t4 & 1;
        const float s0 = odd ? v[0] : v[2], s1 = odd ? v[1] : v[3];
        const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1), g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float o[4] = {odd ? g0 : v[0], odd ? g1 : v[1], odd ? v[2] : g0, odd ? v[3] : g1};
        const int e = mt * 16 + r4 + (odd ? 8 : 0), cc = cc0 + 4 * (t4 >> 1);
        const int ea = rd * kEB + e, j = divF.div(ea), f = ea - j * F;
        if (slot != nullptr) {
          T* dst = nullptr;
          if (e < ne) {
            const size_t srow = static_cast<size_t>(b) * M * K + slot[row + vK[j]];
            dst = dsorted + (srow * F + f) * C + c0 + cc;
          }
          if constexpr (kF32) {
            if (e < ne && cc < cw) {
              if (quad4) {
                *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
              } else {
                for (int x = 0; x < 4 && cc + x < cw; ++x) dst[x] = o[x];
              }
            }
          } else {
            // lanes t4 = 0, 1 take their partner's (t4 ^ 2) 4 channels: 8 a lane, 16 bytes
            const uint32_t lo = pack2(o[0], o[1]), hi = pack2(o[2], o[3]);
            const uint32_t plo = __shfl_xor_sync(0xffffffffu, lo, 2), phi = __shfl_xor_sync(0xffffffffu, hi, 2);
            if (C % 8 == 0) {
              if (t4 < 2 && e < ne && cc < cw)
                *reinterpret_cast<uint4*>(dst) = make_uint4(lo, hi, plo, phi);
            } else if (e < ne && cc < cw) {
              if (quad4) {
                *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
              } else {
                for (int x = 0; x < 4 && cc + x < cw; ++x) dst[x] = from_f<T>(o[x]);
              }
            }
          }
        } else if (e < ne && cc < cw) {
          float* dst = dfeats + ((static_cast<size_t>(b) * N + vN[j]) * F + f) * C + c0 + cc;
          if (quad4) {
            atomicAdd(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
          } else {
            for (int x = 0; x < 4 && cc + x < cw; ++x) atomicAdd(dst + x, o[x]);
          }
        }
      }
    }

    if (last_chunk) {  // dpre into shared memory over the pne, then d_proj
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= mts) break;
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) {
          const int n0 = (warp + 4 * jn) * 8;
          if (n0 >= GQ) break;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store2(pS + (mt * 16 + r4 + 8 * h) * gqs + n0 + 2 * t4,
                   rnd<T>(acc[mt][jn][2 * h] * ag[mt][jn][2 * h]),
                   rnd<T>(acc[mt][jn][2 * h + 1] * ag[mt][jn][2 * h + 1]));
        }
      }
      __syncthreads();
      // [d_proj; d_bias][d][q] += sum_{e, g} geo^T[g][d][e] dpre[e][g*Q + q]
      for (int g = 0; g < G; ++g) {
        const float* ga = geoS + (g * DR + r4) * kEGStride;
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) {
          const int q0 = (warp + 4 * jn) * 8;
          if (q0 >= Q) break;
          const T* pb = pS + g * Q + q0 + r4;
#pragma unroll
          for (int pm = 0; pm < kPM; ++pm) {
            if (pm * 16 > D) break;
            const float* gm = ga + pm * 16 * kEGStride;
            for (int k16 = 0; k16 < 16 * mts; k16 += 16) {
              float s[4] = {0.f, 0.f, 0.f, 0.f};
              if constexpr (kF32) {
#pragma unroll
                for (int k0 = k16; k0 < k16 + 16; k0 += 8) {
                  const float2 x = *reinterpret_cast<const float2*>(gm + k0 + 2 * t4);
                  const float2 y = *reinterpret_cast<const float2*>(gm + 8 * kEGStride + k0 + 2 * t4);
                  const float av[4] = {x.x, y.x, x.y, y.y};
                  const float bv[2] = {pb[(k0 + 2 * t4) * gqs], pb[(k0 + 2 * t4 + 1) * gqs]};
                  uint32_t ah[4], al[4], bh[2], bl[2];
                  split_n<4>(av, ah, al);
                  split_n<2>(bv, bh, bl);
                  mma_3xtf32(s, ah, al, bh, bl);
                }
              } else {
                const float2 x0 = *reinterpret_cast<const float2*>(gm + k16 + 2 * t4);
                const float2 y0 = *reinterpret_cast<const float2*>(gm + 8 * kEGStride + k16 + 2 * t4);
                const float2 x1 = *reinterpret_cast<const float2*>(gm + k16 + 8 + 2 * t4);
                const float2 y1 = *reinterpret_cast<const float2*>(gm + 8 * kEGStride + k16 + 8 + 2 * t4);
                const uint32_t a[4] = {pack2(x0.x, x0.y), pack2(y0.x, y0.y), pack2(x1.x, x1.y), pack2(y1.x, y1.y)};
                const uint32_t bb[2] = {pack_bf16(pb[(k16 + 2 * t4) * gqs], pb[(k16 + 2 * t4 + 1) * gqs]),
                                        pack_bf16(pb[(k16 + 8 + 2 * t4) * gqs], pb[(k16 + 9 + 2 * t4) * gqs])};
                mma_bf16(s, a, bb);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) dacc[pm][jn][i] += s[i];
            }
          }
        }
      }
      ++rs;
    }
    rr = nr, nE = nnE, flat = nflat, staged = nstaged, seq = nseq, rd = nrd, ch = nch2, st ^= 1;
  }
  cp_wait<0>();

  // the block's partial: each (d, q) from the one thread that holds it
  float* out = ppart + static_cast<size_t>(blockIdx.x) * (D + 1) * Q;
#pragma unroll
  for (int pm = 0; pm < kPM; ++pm)
#pragma unroll
    for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = pm * 16 + r4 + 8 * (i >> 1), q = (warp + 4 * jn) * 8 + 2 * t4 + (i & 1);
        if (d <= D && q < Q) out[d * Q + q] = dacc[pm][jn][i];
      }
}

// edge_kernel's instantiation for the column capacity of G and G*Q, and for
// the activation switch or gelu's alone (kD = kKP always switches).
template <typename T, int kD>
auto edge_instance(int G, int Q, int act) -> decltype(&edge_kernel<T, 64, kD, true>) {
  const bool gelu = act == kActGelu;
  if constexpr (kD == 9)
    if (column_capacity(G, Q) == 128) return gelu ? edge_kernel<T, 128, kD, false> : edge_kernel<T, 128, kD, true>;
  if constexpr (kD != kKP)
    if (gelu) return edge_kernel<T, 64, kD, false>;
  return edge_kernel<T, 64, kD, true>;
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
  if (column_capacity(G, Q) == 128 && kD != 9) return cudaErrorInvalidValue;
  const auto kernel = edge_instance<T, kD>(G, Q, act);
  const int smem_e = edge_layout(sizeof(T), D, G, Q, K, kD == kKP ? kp.P : 0).total;
  if (smem_e > kSmemMax) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_e);
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
// inputs: one a block of edge_kernel's walk, L blocks up to kEGrid); at
// least one split and one block.
extern "C" void se3_fused_equiv_bwd_plan(int L, int G, int Q, int C, int O, int elem_bytes,
                                         long long* scratch, int* w_splits, int* p_blocks) {
  const long long rows = static_cast<long long>(L) * G;
  const long long cq = static_cast<long long>(C) * Q;
  *scratch = round16(rows * cq * elem_bytes) + round16(rows * O * elem_bytes) +
             round16(product_image_bytes(static_cast<int>(cq), O, elem_bytes));
  *w_splits = product_splits(product_tiles(cq, O), rows, O, kPMaxSplits);
  *p_blocks = L < 1 ? 1 : (L < kEGrid ? L : kEGrid);
}

// edge_kernel's launch plan for operands of elem_bytes, G out-frames, Q
// basis functions, K neighbors and the geometry kd (9, 3, or 0: the kernel
// points, P of them): out[0..7] = warps a block, dynamic shared-memory
// bytes, ring stages, blocks an SM (edge_blocks_per_sm), the row stride of
// the pne rows and dbasis chunks, the geometry rows of a frame, edges a
// round, channels a chunk.  Returns cudaErrorInvalidValue where no
// instantiation takes the shape (kernels/fused_equiv.py:edge_plan mirrors it).
extern "C" int se3_fused_edge_plan(int elem_bytes, int G, int Q, int K, int kd, int P, int* out) {
  const int gqc = column_capacity(G, Q);
  if (gqc == 0 || (kd != 9 && gqc != 64) || (kd == kKP && (P < 1 || P > kMaxKP)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = kd == kKP ? P : kd;
  const EdgeLayout l = edge_layout(elem_bytes, D, G, Q, K, kd == kKP ? P : 0);
  const int v[8] = {kEThreads / 32, l.total, kEStages, edge_blocks_per_sm(l.total, gqc, kd), l.gqs,
                    l.geo_rows, kEB, kCC};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return l.total > kSmemMax ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

namespace {

template <typename T, int kD>
int edge_attrs(int G, int Q, int K, int P, int act, int* out) {
  const auto kernel = edge_instance<T, kD>(G, Q, act);
  const int smem = edge_layout(sizeof(T), kD == kKP ? P : kD, G, Q, K, kD == kKP ? P : 0).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kEThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = smem;
  out[3] = blocks;
  return 0;
}

}  // namespace

// The edge_kernel instantiation that se3_fused_edge_plan's arguments and
// the activation act pick, on the current device: out[0..3] = registers a
// thread, local (spill) bytes, dynamic shared-memory bytes, and the blocks
// an SM holds at that shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int se3_fused_edge_attrs(int elem_bytes, int G, int Q, int K, int kd, int P, int act, int* out) {
  int plan[8];
  const int err = se3_fused_edge_plan(elem_bytes, G, Q, K, kd, P, plan);
  if (err != 0) return err;
  if (kd == 9) return elem_bytes == 2 ? edge_attrs<bf16, 9>(G, Q, K, P, act, out) : edge_attrs<float, 9>(G, Q, K, P, act, out);
  if (kd == 3) return elem_bytes == 2 ? edge_attrs<bf16, 3>(G, Q, K, P, act, out) : edge_attrs<float, 3>(G, Q, K, P, act, out);
  return elem_bytes == 2 ? edge_attrs<bf16, kKP>(G, Q, K, P, act, out) : edge_attrs<float, kKP>(G, Q, K, P, act, out);
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
