// The Mosaic pattern probes' sixteen one-block kernels, for NVIDIA Hopper
// (sm_90a), as four kernels over a grid of tiles:
//
//   strided_product:  out[b, i, j] = sum over k of A[b, i, k] * B[b, k, j], A and
//                     B read through given strides, float32 or bfloat16
//                     operands, float32 sums on tensor cores (p1-p4, p8,
//                     p10, p13, p15)
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
// probe, the plain PyTorch versions and product_plan, which picks each
// product's tile, layouts, copy widths, depth split and stages.
//
// What bounds them: each probe reads and writes at most a few MB and runs
// at most 134 MFLOP (p8), so every bound is a few microseconds or less
// (bytes, or the 3xTF32 ceiling) and the times show launch latency and
// how fast one SM works through its slices.  strided_product:
//
// - tensor cores: float32 on mma.sync m16n8k8 TF32 in the 3xTF32 form (x =
//   hi + lo, each TF32; lo.hi + hi.lo + hi.hi, each of the three into a
//   register tile of its own, so the mma of one k8 step do not wait on each
//   other), bfloat16 on mma.sync m16n8k16 with float32 accumulation (its
//   products are exact in float32).  Each 32-deep slice is summed by the
//   mma into zeroed register tiles and added to the running sum by rounded
//   float32 adds, as fused_equiv_common.cuh's tf32x3_gemm does.  wgmma is
//   not used: every product here is bound by bytes or launch latency, and
//   p15's 18 rows would fill a quarter of its 64-row tile;
// - a group of 4 warps owns a 64 x 64, 64 x 32, 32 x 64, 32 x 32 or (float32
//   only) 32 x 16 output tile (product_plan: p8 reads each operand tile
//   twice from L2, not four times as 32 x 32 tiles would);
// - staging by cp.async along whichever axis of an operand has stride 1, 16
//   bytes a copy where the strides, extent and base allow (else 8 or 4:
//   p1's K = 9, p15's 18-wide rows), each thread's copies a fixed unrolled
//   list, in a ring of 2 or 3 slices of 32 deep, so slice t + 1 loads while
//   slice t multiplies; copies past an edge (p1's K tail, p15's 18 rows in
//   a 32-row tile) are zero-filled by the copy itself.  A slice keeps the
//   operand's own layout: depth contiguous as [rows][32 + 16 bytes], else
//   [32][rows + 8]; either pad puts the 32 fragment words of a TF32 load,
//   and the 8 rows of each ldmatrix phase (bfloat16; .trans for a layout
//   with the rows contiguous), on distinct banks;
// - a long depth with few output tiles (p3: 2,048 terms into 8 tiles of 32
//   x 32, p15: 4,096 into 4 of 32 x 16) is split over a thread-block
//   cluster of at most 8 blocks, one depth range each, and each block's
//   range over 4 groups of 4 warps, each group with a ring of its own and
//   its own named barrier: one group works through a slice in about a
//   microsecond (its copies and its products each about half, measured),
//   so one SM needs several groups in flight.  After the products each
//   group keeps its partial tile in shared memory, the block adds its
//   groups' tiles in group order, and block r of the cluster adds the
//   cluster's tiles for its share of the elements through distributed
//   shared memory in rank order from zero.  One launch, no scratch in
//   device memory, no atomics: two calls give the same bits.
//
// strided_copy moves 16 bytes a thread where the source's inner stride is 1
// (every probe but p12's transpose, which reads 4 bytes a thread and writes
// coalesced).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fused_equiv_common.cuh"
#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 4096;

inline unsigned grid_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 1 ? 1 : (b < kMaxGrid ? b : kMaxGrid));
}

// --- strided_product ------------------------------------------------------------

constexpr int kPK = 32;          // depth of one staged slice
constexpr int kPThreads = 128;   // 4 warps a group, 1-4 groups a block
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kTiles = 5;
// block tile (rows, columns) and warp grid (along rows, along columns) by
// tile id; tile 4 (16 columns, one n8 tile a warp) is float32 only
constexpr int kTileM[kTiles] = {64, 32, 64, 32, 32};
constexpr int kTileN[kTiles] = {64, 64, 32, 32, 16};
constexpr int kWarpsM[kTiles] = {2, 2, 4, 2, 2};
// groups of 4 warps a block at most, each over its own share of the depth
constexpr int kTileGroups[kTiles] = {1, 4, 1, 4, 4};

struct ProductArgs {
  const void* A;
  const void* B;
  float* out;                    // [batch, M, N] contiguous
  long long a_b, a_i, a_k;       // A's strides, in elements
  long long b_b, b_k, b_j;       // B's strides
  int M, N, K, k_per_split, n_tiles;
  int a_vs, b_vs;                // log2 of the values one copy moves
  int stages;
};

// An operand's staged slice: X(r, k) for r < ROWS and k < kPK, with the
// row contiguous (KC: [ROWS][kPK + 16 bytes]) or the depth
// ([kPK][ROWS + 8]).
template <typename T, bool KC, int ROWS>
struct Slice {
  static constexpr int kStride = KC ? kPK + 16 / static_cast<int>(sizeof(T)) : ROWS + 8;
  static constexpr int kElems = KC ? ROWS * kStride : kPK * kStride;
  __device__ static __forceinline__ int at(int r, int k) { return KC ? r * kStride + k : k * kStride + r; }
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// One copy of BYTES bytes, zero-filled where `in` is false; under 4 bytes
// (one bfloat16) a plain load and store.
template <int BYTES, typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, bool in) {
  if constexpr (BYTES == 16)
    cp_async16(dst, src, in ? 16 : 0);
  else if constexpr (BYTES == 8)
    cp_async8(dst, src, in ? 8 : 0);
  else if constexpr (BYTES == 4)
    cp_async4(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), in ? 4 : 0);
  else
    *dst = in ? *src : __float2bfloat16_rn(0.f);
}

// One kPK-deep slice of an operand tile into shared memory: X(r, k) =
// X[r*s_r + k*s_k] for r in [r0, r0 + ROWS) below R and k in [k0, k0 + kPK)
// below ke; zeros past either edge.  Each copy moves 2^VS values along the
// contiguous axis (k where KC, else r); the plan makes that extent, the
// other strides and the base multiples of 2^VS, so a copy lies wholly
// inside or wholly past an edge.  Each thread's copies are a fixed,
// unrolled list: only the slice's base moves from one slice to the next.
template <typename T, bool KC, int ROWS, int VS>
__device__ __forceinline__ void stage_slice_v(T* s, const T* __restrict__ X, long long s_r, long long s_k, int r0,
                                              int R, int k0, int ke, int tid) {
  using L = Slice<T, KC, ROWS>;
  constexpr int kW = 1 << VS, kPerLine = (KC ? kPK : ROWS) / kW, kCopies = ROWS * kPK / kW;
  static_assert(kCopies % kPThreads == 0, "every thread makes the same number of copies");
  const T* base = X + r0 * s_r + k0 * s_k;
  const int rows = R - r0, depth = ke - k0;
#pragma unroll 4
  for (int j = 0; j < kCopies / kPThreads; ++j) {
    const int c = tid + j * kPThreads;
    const int line = c / kPerLine, off = (c % kPerLine) * kW;
    const int r = KC ? line : off, k = KC ? off : line;
    const bool in = r < rows && k < depth;
    copy_in<kW * static_cast<int>(sizeof(T))>(s + L::at(r, k), in ? base + r * s_r + k * s_k : X, in);
  }
}

template <typename T, bool KC, int ROWS>
__device__ __forceinline__ void stage_slice(T* s, const T* __restrict__ X, long long s_r, long long s_k, int r0,
                                            int R, int k0, int ke, int vs, int tid) {
  switch (vs) {
    case 0: stage_slice_v<T, KC, ROWS, 0>(s, X, s_r, s_k, r0, R, k0, ke, tid); break;
    case 1: stage_slice_v<T, KC, ROWS, 1>(s, X, s_r, s_k, r0, R, k0, ke, tid); break;
    case 2: stage_slice_v<T, KC, ROWS, 2>(s, X, s_r, s_k, r0, R, k0, ke, tid); break;
    default:
      if constexpr (sizeof(T) == 2) stage_slice_v<T, KC, ROWS, 3>(s, X, s_r, s_k, r0, R, k0, ke, tid);
      break;
  }
}

// Four 8 x 8 matrices of 16-bit values from shared memory: lane l names
// row l % 8 of matrix l / 8; TRANS hands each lane a column pair instead
// of a row pair.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t* d, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(a));
}

// part = the products of one staged slice for this warp's MT x NT mma
// tiles at (wm, wn): 3xTF32 on four k8 steps, each of the three products
// into a register tile of its own, so the mma of one k8 step do not wait
// on each other (in order, one tile's three would each wait out the last
// one's latency), then part = (lo.hi + hi.lo) + hi.hi.
template <int MT, int NT, bool A_KC, bool B_KC, int BM, int BN>
__device__ __forceinline__ void slice_products(float (&part)[MT][NT][4], const float* as, const float* bs, int wm,
                                               int wn, int gid, int tig, int) {
  using LA = Slice<float, A_KC, BM>;
  using LB = Slice<float, B_KC, BN>;
  float lh[MT][NT][4], hl[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) lh[mt][nt][v] = hl[mt][nt][v] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kPK; ks += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        split_tf32(as[LA::at(wm + mt * 16 + gid + 8 * (v & 1), ks + tig + 4 * (v >> 1))], ah[mt][v], al[mt][v]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 2; ++v) split_tf32(bs[LB::at(wn + nt * 8 + gid, ks + tig + 4 * v)], bh[nt][v], bl[nt][v]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(lh[mt][nt], al[mt], bh[nt]);
        mma_tf32(hl[mt][nt], ah[mt], bl[nt]);
        mma_tf32(part[mt][nt], ah[mt], bh[nt]);
      }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) part[mt][nt][v] = (lh[mt][nt][v] + hl[mt][nt][v]) + part[mt][nt][v];
}

// The same from bfloat16 slices: m16n8k16 on two k16 steps, fragments by
// ldmatrix (.trans where the slice keeps the rows contiguous).
template <int MT, int NT, bool A_KC, bool B_KC, int BM, int BN>
__device__ __forceinline__ void slice_products(float (&part)[MT][NT][4], const bf16* as, const bf16* bs, int wm,
                                               int wn, int, int, int lane) {
  using LA = Slice<bf16, A_KC, BM>;
  using LB = Slice<bf16, B_KC, BN>;
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < kPK; ks += 16) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // matrices: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
      const int i = wm + mt * 16 + (q & 1) * 8, k = ks + (q >> 1) * 8;
      ldsm_x4<!A_KC>(a[mt], as + (A_KC ? LA::at(i + r, k) : LA::at(i, k + r)));
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      // matrices: (k 0-7, tile nt), (k 8-15, tile nt), (k 0-7, tile nt + 1), (k 8-15, tile nt + 1)
      const int j = wn + (nt + (q >> 1)) * 8, k = ks + (q & 1) * 8;
      uint32_t d[4];
      ldsm_x4<!B_KC>(d, bs + (B_KC ? LB::at(j + r, k) : LB::at(j, k + r)));
      b[nt][0] = d[0];
      b[nt][1] = d[1];
      b[nt + 1][0] = d[2];
      b[nt + 1][1] = d[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(part[mt][nt], a[mt], b[nt]);
  }
}

__device__ __forceinline__ void group_sync(int group, int groups) {
  if (groups == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(kPThreads) : "memory");
}

// grid (splits, M tiles * N tiles, batch), cluster (splits, 1, 1); a block
// of `groups` groups of 4 warps (kTileGroups[TILE] at most) owns one TILE's
// output tile over one depth range, group g over the g-th share of its
// slices, with a ring of its own.  Dynamic shared memory:
// product_smem(sizeof(T), TILE, A_KC, B_KC, stages, splits, groups).
template <typename T, int TILE, bool A_KC, bool B_KC>
__global__ void __launch_bounds__(kPThreads * kTileGroups[TILE])
strided_product(ProductArgs p) {
  constexpr int BM = kTileM[TILE], BN = kTileN[TILE], WM = kWarpsM[TILE], WN = 4 / WM;
  constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  using LA = Slice<T, A_KC, BM>;
  using LB = Slice<T, B_KC, BN>;
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int groups = blockDim.x / kPThreads, group = threadIdx.x / kPThreads;
  T* as = reinterpret_cast<T*>(dsmem) + group * p.stages * (LA::kElems + LB::kElems);
  T* bs = as + p.stages * LA::kElems;

  const int tid = threadIdx.x % kPThreads, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int wm = (warp % WM) * MT * 16, wn = (warp / WM) * NT * 8;
  const int i0 = (blockIdx.y / p.n_tiles) * BM, j0 = (blockIdx.y % p.n_tiles) * BN;
  // this block's depth range, then this group's share of its slices
  const int kb_block = blockIdx.x * p.k_per_split, ke = min(p.K, kb_block + p.k_per_split);
  const int slices = (ke - kb_block + kPK - 1) / kPK, per_group = (slices + groups - 1) / groups;
  const int kb = kb_block + group * per_group * kPK;
  const int nk = max(0, min(slices - group * per_group, per_group));
  const T* A = static_cast<const T*>(p.A) + blockIdx.z * p.a_b;
  const T* B = static_cast<const T*>(p.B) + blockIdx.z * p.b_b;

  auto load = [&](int kt) {
    const int slot = kt % p.stages, k0 = kb + kt * kPK;
    stage_slice<T, A_KC, BM>(as + slot * LA::kElems, A, p.a_i, p.a_k, i0, p.M, k0, ke, p.a_vs, tid);
    stage_slice<T, B_KC, BN>(bs + slot * LB::kElems, B, p.b_j, p.b_k, j0, p.N, k0, ke, p.b_vs, tid);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // every copy group but the newest stages - 2 has landed: slice kt is in
    if (p.stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    group_sync(group, groups);      // and every warp is done with slice kt - 1, whose slot the next copy takes
    if (kt + p.stages - 1 < nk) load(kt + p.stages - 1);
    cp_commit();
    const int slot = kt % p.stages;
    float part[MT][NT][4];  // this slice's products: the mma's own adds stay short
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[mt][nt][v] = 0.f;
    slice_products<MT, NT, A_KC, B_KC, BM, BN>(part, as + slot * LA::kElems, bs + slot * LB::kElems, wm, wn, gid,
                                               tig, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] += part[mt][nt][v];
  }
  cp_wait<0>();

  // accumulator v of tile (mt, nt): row gid + 8*(v >> 1), column 2*tig + (v & 1)
  float* out = p.out + static_cast<long long>(blockIdx.z) * p.M * p.N;
  if (gridDim.x == 1 && groups == 1) {
    const bool pairs = p.N % 2 == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wm + mt * 16 + gid + 8 * h;
        if (i >= p.M) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          store_pair(out + static_cast<long long>(i) * p.N, j0 + wn + nt * 8 + 2 * tig, p.N, pairs,
                     acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    return;
  }

  // split depth: each group's partial tile into shared memory (every ring
  // is spent), the groups' tiles added in group order into the first, then
  // block r of the cluster adds every block's tile for the elements e =
  // r*bt + t + cs*bt*n (bt threads a block) in rank order
  float* tile = reinterpret_cast<float*>(dsmem);
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        tile[group * BM * BN + (wm + mt * 16 + gid + 8 * (v >> 1)) * BN + wn + nt * 8 + 2 * tig + (v & 1)] =
            acc[mt][nt][v];
  __syncthreads();
  const int bt = blockDim.x;
  if (groups > 1) {
    for (int e = threadIdx.x; e < BM * BN; e += bt) {
      float s = tile[e];
      for (int g = 1; g < groups; ++g) s += tile[g * BM * BN + e];
      tile[e] = s;
    }
    __syncthreads();
  }
  const bool clustered = gridDim.x > 1;
  cg::cluster_group cluster = cg::this_cluster();
  if (clustered) cluster.sync();
  const int cs = clustered ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = clustered ? static_cast<int>(cluster.block_rank()) : 0;
  for (int e = rank * bt + threadIdx.x; e < BM * BN; e += cs * bt) {
    float v[kMaxCluster];  // every rank's value in flight at once, then added in rank order
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < cs) v[q] = clustered ? cluster.map_shared_rank(tile, q)[e] : tile[e];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < cs) s += v[q];
    const int i = i0 + e / BN, j = j0 + e % BN;
    if (i < p.M && j < p.N) out[static_cast<long long>(i) * p.N + j] = s;
  }
  if (clustered) cluster.sync();  // no block leaves while another still reads its partial
}

// Dynamic shared memory of one strided_product launch: each group's ring
// of `stages` slices of both operands, or the groups' partial tiles where
// the depth is split, if larger.
int product_smem(int esize, int tile, bool a_kc, bool b_kc, int stages, int splits, int groups) {
  const int bm = kTileM[tile], bn = kTileN[tile], padk = 16 / esize;
  const int a = a_kc ? bm * (kPK + padk) : kPK * (bm + 8);
  const int b = b_kc ? bn * (kPK + padk) : kPK * (bn + 8);
  const int staged = groups * stages * (a + b) * esize, tiles = groups * bm * bn * 4;
  return (splits > 1 || groups > 1) && tiles > staged ? tiles : staged;
}

using ProductKernel = void (*)(ProductArgs);

template <typename T, int TILE>
ProductKernel product_kernel(bool a_kc, bool b_kc) {
  if (a_kc) return b_kc ? strided_product<T, TILE, true, true> : strided_product<T, TILE, true, false>;
  return b_kc ? strided_product<T, TILE, false, true> : strided_product<T, TILE, false, false>;
}

template <typename T>
ProductKernel product_kernel(int tile, bool a_kc, bool b_kc) {
  switch (tile) {
    case 0: return product_kernel<T, 0>(a_kc, b_kc);
    case 1: return product_kernel<T, 1>(a_kc, b_kc);
    case 2: return product_kernel<T, 2>(a_kc, b_kc);
    case 3: return product_kernel<T, 3>(a_kc, b_kc);
    default:
      if constexpr (sizeof(T) == 4) return product_kernel<T, 4>(a_kc, b_kc);
      return nullptr;
  }
}

// Whether copies of 2^vs values fit an operand X(r, k) (R rows, K deep):
// along k (kc) or r, stride 1 there, the extent and the other strides
// multiples of 2^vs, the base aligned, and at most 16 bytes a copy.
bool copies_fit(const void* x, int esize, bool kc, long long s_b, long long s_r, long long s_k, int R, int K,
                int batch, int vs) {
  if (vs < 0 || (esize << vs) > 16) return false;
  if (vs == 0) return true;
  const long long w = 1LL << vs;
  const long long inner = kc ? s_k : s_r, other = kc ? s_r : s_k, extent = kc ? K : R;
  return inner == 1 && other % w == 0 && (batch == 1 || s_b % w == 0) && extent % w == 0 &&
         reinterpret_cast<uintptr_t>(x) % (esize * w) == 0;
}

// The dynamic shared memory each instantiation may take, as last raised
// (cudaFuncSetAttribute, past the default 48 KB)
int g_smem_max[2][kTiles][2][2];

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
// contiguous.  The plan (mosaic_probes.product_plan): tile id, each
// operand's slice layout (a_kc: A kept depth-contiguous; b_kc likewise)
// and log2 of its copy width, the depth split over a cluster of `splits`
// blocks of k_per_split terms (a multiple of 32), the ring's stages (2 or
// 3), the groups of 4 warps a block and the dynamic shared memory, which
// must be product_smem's.
extern "C" int se3_probe_strided_product(const void* a, const void* b, int use_bf16, long long a_b, long long a_i,
                                         long long a_k, long long b_b, long long b_k, long long b_j, int batch,
                                         int M, int N, int K, int tile, int a_kc, int b_kc, int a_vs, int b_vs,
                                         int splits, int k_per_split, int stages, int groups, int smem,
                                         void* out, void* stream_ptr) {
  const int esize = use_bf16 ? 2 : 4;
  if (batch < 1 || M < 1 || N < 1 || K < 1 || tile < 0 || tile >= kTiles || splits < 1 || splits > kMaxCluster ||
      k_per_split < 1 || k_per_split % kPK != 0 || static_cast<long long>(splits) * k_per_split < K ||
      static_cast<long long>(splits - 1) * k_per_split >= K || (stages != 2 && stages != 3) || batch > 65535 ||
      groups < 1 || groups > kTileGroups[tile] ||
      smem != product_smem(esize, tile, a_kc != 0, b_kc != 0, stages, splits, groups) ||
      !copies_fit(a, esize, a_kc != 0, a_b, a_i, a_k, M, K, batch, a_vs) ||
      !copies_fit(b, esize, b_kc != 0, b_b, b_j, b_k, N, K, batch, b_vs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int m_tiles = (M + kTileM[tile] - 1) / kTileM[tile], n_tiles = (N + kTileN[tile] - 1) / kTileN[tile];
  if (static_cast<long long>(m_tiles) * n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const ProductArgs p{a, b, static_cast<float*>(out), a_b, a_i, a_k, b_b, b_k, b_j, M, N, K, k_per_split,
                      n_tiles, a_vs, b_vs, stages};
  const ProductKernel kern = use_bf16 ? product_kernel<bf16>(tile, a_kc != 0, b_kc != 0)
                                      : product_kernel<float>(tile, a_kc != 0, b_kc != 0);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int& smem_max = g_smem_max[use_bf16 != 0][tile][a_kc != 0][b_kc != 0];
  if (smem > 48 * 1024 && smem > smem_max) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_max = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, m_tiles * n_tiles, batch);
  cfg.blockDim = dim3(kPThreads * groups);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// attrs[0..3] of the strided_product instantiation a plan names, with its
// dynamic shared memory (probe_common.cuh: kernel_attrs).
extern "C" int se3_probe_product_attrs(int use_bf16, int tile, int a_kc, int b_kc, int smem, int* attrs) {
  const ProductKernel kern = tile < 0 || tile >= kTiles ? nullptr
                            : use_bf16 ? product_kernel<bf16>(tile, a_kc != 0, b_kc != 0)
                                       : product_kernel<float>(tile, a_kc != 0, b_kc != 0);
  return kern == nullptr ? static_cast<int>(cudaErrorInvalidValue) : kernel_attrs(kern, smem, attrs);
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

// attrs[0..3] of kernel `which`: 0 strided_copy<vec>, 1
// strided_copy<scalar>, 2 blockdiag_build, 3 mid_write (probe_common.cuh:
// kernel_attrs; the products' by se3_probe_product_attrs).
extern "C" int se3_probe_mosaic_attrs(int which, int* attrs) {
  switch (which) {
    case 0: return kernel_attrs(strided_copy<true>, 0, attrs);
    case 1: return kernel_attrs(strided_copy<false>, 0, attrs);
    case 2: return kernel_attrs(blockdiag_build, 0, attrs);
    case 3: return kernel_attrs(mid_write, 0, attrs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
