// The fused PNE-conv forward, stage by stage, for NVIDIA Hopper (sm_90a):
// the stage probe.  Per query row m of E = 32 edges, G = 2 out-frames of
// Q = 32 basis functions (GQ = 64), C = O = 64 channels and D <= 19 pne
// inputs:
//
//   pre[e, gq]      = sum_k geo[m*E + e, k] * proj[k, gq] (+ bias[gq])
//   pne             = gelu(pre)                        (tanh form, as jax.nn.gelu)
//   basis[gq, m, c] = sum_e pne[e, gq] * feat[m, e, c]
//   per_gq[gq, m, o] = sum_c basis[gq, m, c] * W[gq, c, o]
//   out[g, m, o]    = sum_q per_gq[g*Q + q, m, o]
//
// Replaces the TPU Pallas kernels of experiments/chip_stage_time.py (kern,
// :17, called by run, :42) and experiments/bisect_fused.py (the kernels of
// s1_pne .. s5_reduce through call, :46, and s6_vmap's single, :193).  A
// stage stops the computation after pne, the aggregation, the swap (the
// TPU's relayout of basis to [GQ, rows, C]), the weight contraction or the
// sum over q.  Two kernels, by output mode:
//
// - tensor mode (stage_fwd, bisect_fused's s1-s6 at MP = 1024): the stage's
//   whole tensor, float32 with the bias; a batch index in the grid's y
//   gives s6's leading batch.
// - tile-sum mode (tile_fwd, chip_stage_time): one partial sum of the
//   stage's values per tile of 16 query rows, no bias, float32 or bfloat16
//   compute (T).  The stage's work stays live but its intermediate never
//   reaches HBM, so the stage times differ by the stage's own cost; the
//   last stage also writes the output [G, M, O] (chip_stage_time's run
//   summed it).  With bfloat16 the values are rounded where the JAX script
//   casts: geo and proj before the first product, pne before the
//   aggregation, feat, basis before the weight product, and W; every sum is
//   float32.
//
// See se3conv3d_tpu_torch/kernels/probes.py for the wrapper and the plain
// PyTorch version.
//
// What bounds the tensor mode (MP = 1024 rows, D = 18): s1 writes 8.4 MB
// of pne and s2-s4 16.8 MB of basis or per_gq beside 2.4 MB of geo and 8.4
// MB of feat, so they are bound by bytes (0.003-0.009 ms at 3.35 TB/s);
// s5 / s6 write 0.5 MB and run 0.88 GFLOP (pne 0.08, aggregation 0.27,
// weight product 0.54), bound by operations at the 3xTF32 ceiling (0.005
// ms at a third of 495 TFLOP/s).  At these sizes a launch costs about 2
// us, mma.sync reaches a fraction of that ceiling, and each block's loads,
// products and stores follow one another, so what decides the time is how
// many SMs work and how much of each block's chain overlaps.  The design
// (stage_fwd):
//
// - the whole card: a block of 8 warps for each (16-row tile, chunk of 16
//   gq), 256 blocks at MP = 1024, two resident an SM (at most 112 KB of
//   shared memory, at most 128 registers a thread, no local memory); warp w
//   owns tile rows 2w, 2w + 1.  The reduce stage sums over the out-frame's
//   two chunks: their blocks form a cluster of 2 and add their partial
//   tiles through distributed shared memory in chunk order, so no sum
//   crosses a launch and no atomic is needed.  Each block reads its tile's
//   geo and feat (the 4 chunks of a tile from L2) and its chunk's 256 KB of
//   W (64 MB from L2 at MP = 1024 for s4-s6, what a 16-row tile costs).
// - geo reaches each warp's scratch in shared memory by cp.async, a row a
//   group, so that row 0's pne starts while row 1's lands.  pne on mma.sync
//   m16n8k8 in 3xTF32: pre^T[16 gq][32 edges] a row, the bias folded in as
//   row D of the product (geo reads a one there, depth padded with zeros to
//   24), GELU (tanh form) applied to the accumulator.  pne stays in
//   registers, split into its TF32 halves once: the aggregation reads each
//   lane's own accumulator values as its A fragment (the depth index
//   relabelled, edge 2 tig + {0, 1}).  s1 stages each row in the scratch
//   and writes it with 16-byte stores.
// - the aggregation basis[16 gq][8 c] = pne^T . feat per row and feat
//   group on mma.sync 3xTF32.  feat streams through a ring of slots of 2 KB
//   a warp (cp.async, the warp's own two rows, so no block barrier; the
//   32-byte edge rows of each line permuted for conflict-free fragment
//   reads), never held whole.  s2 and s3 write each group from registers:
//   lanes tig, tig ^ 1 trade a pair, so that each stores 4 channels of one
//   q as a 16-byte store along C, and the stores stream while the next
//   groups compute; s4 / s5 put it in the chunk's basis in shared memory
//   ([16 q][16 rows][64 c], 64 KB, 16-byte chunks XOR-swizzled).
// - the weight contraction D[16 rows][64 o] += basis[q][rows][8 c] .
//   W[gq0 + q][8 c][64 o] on mma.sync 3xTF32, warp w over its q = 2w, 2w +
//   1; W's 2 KB k-steps come through the same ring as feat (3 slots for
//   the feat-only stages, 2 beside the basis, which measured faster than
//   3), the rows of a slot swizzled for the B fragments.  s4 writes each
//   q's tile through its own dead basis rows as a 4 KB run of 16-byte
//   stores along O; s5 / s6 add the 8 warps' tiles in warp order, then the
//   cluster's.
// - each 8-deep product slice is summed into a zeroed tile and added to the
//   running sum by a rounded float32 add (the tensor cores' own adds
//   truncate), as the port's conv kernels; every sum runs in a fixed
//   order, so two calls give the same bits.
//
// What bounds the tile-sum forward (chip_stage_time's M = 65,536): 5.10 +
// 17.18 + 34.36 GFLOP (pne, aggregation, weight product), against 159 MB
// of geo, 537 MB of feat and 34 MB of output (0.22 ms at 3.35 TB/s).  On
// tensor cores the float32 products run as 3xTF32 (0.34 ms at a third of
// 495 TFLOP/s) and bfloat16 ones at 989 TFLOP/s, so bfloat16 is bound by
// bytes and float32 by operations.  The design (tile_fwd):
//
// - a persistent block per SM walks tiles of 16 query rows (512 edges):
//   two consumer warpgroups compute, a producer warpgroup hands them its
//   registers (setmaxnreg: 12 warps start at 168 a thread, the consumers
//   then hold 232) and loads with two warps, feat in one, W in the other.
// - pne first: each consumer warp computes pre^T[16 gq][32 e] of its two
//   rows for the 4 chunks of 16 gq on mma.sync (m16n8k8 3xTF32 / m16n8k16
//   bf16; D padded with zeros to 24 / 32; its geo fetched into registers a
//   tile ahead), applies the tanh GELU to the accumulator in the form
//   x / (1 + exp(-2u)) (one expf, no branch), and keeps pne in shared
//   memory in fragment order (128 KB float32, 64 KB bf16): each lane reads
//   its own accumulator values back as the aggregation's A fragment (for
//   TF32 with the depth index relabelled, edge 2 tig + {0, 1}, and so the
//   feat operand).
// - then feat streams through a ring of two groups of 8 channels (16 KB,
//   cp.async, the 32-byte edge rows of each 128-byte line permuted so that
//   the fragment reads hit 32 banks), a group ahead; each group feeds 4
//   blocks (one per chunk): the aggregation basis[16 gq][8 c] of each
//   warp's rows on mma.sync, the swap (the block's basis rounded to T into
//   a [16 rows][128 = 16 q x 8 c] buffer, K-major in 128-byte swizzled
//   atoms, double-buffered), a barrier of the consumers, and the weight
//   contraction D^T[64 o][16 rows] += W^T[64 o][128] . basis^T (M = o),
//   the block's depth split between the warpgroups: float32 on mma.sync
//   3xTF32, each warp 16 o of the 16 rows; bfloat16 on wgmma m64n16k16,
//   both operands from shared memory by descriptor.  The two halves are
//   added at the tile's end.
// - W reaches the contraction through shared memory: a ring of 8 KB
//   slices (6 float32, 12 bf16) of a W image (stage_w_image, run before
//   each call: W^T of each block, in the blocks' order and the operand's
//   swizzled layout, bf16-rounded for T = bf16) that the W warp streams
//   with cp.async.bulk as slots free up; each slice serves the tile's 16
//   rows.  L2 reads of W: one image a tile, 4 GiB (float32) or 2 GiB (bf16)
//   at M = 65,536.  A tile of 16 rows is what fits: a row's resident pne
//   takes 8 KB in float32.  Clusters of 4 blocks sharing each slice by
//   multicast (64 rows a slice) ran slower on the H100 (PERF.md).
// - each 8-deep (float32) or 16-deep (bfloat16) product slice is summed
//   into a zeroed tile and added to the running sum by a rounded float32
//   add (the tensor cores' own adds truncate), as the port's conv kernels.
// - the tile's partial sum is indexed by its tile, not by the block that
//   ran it, and the partials are added in tile order (sum_partials_fixed):
//   two calls give the same bits.

#include <cooperative_groups.h>
#include <stdint.h>

#include "fused_equiv_common.cuh"
#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPE = 32, kPGQ = 64, kPG = 2, kPC = 64, kPO = 64;
constexpr int kDMax = 19;

enum Stage : int { kPne = 0, kAgg = 1, kSwap = 2, kWcontract = 3, kReduce = 4 };
enum Mode : int { kTensor = 0, kTileSum = 1 };

// wait until at most N of this thread's newest cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_wait_but() { asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory"); }
__device__ __forceinline__ void cp_wait_all() { cp_wait_but<0>(); }
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

constexpr int kRows = 16;                // query rows a tile (both modes)
constexpr int kEdges = kRows * kPE;      // 512

// ============================================================================
// Tile-sum mode: tile_fwd (see the design at the top of the file).
// ============================================================================

constexpr int kTR = kRows;                   // query rows a tile
constexpr int kQC = 16;                      // gq a chunk: the m16 of the pne and aggregation products
constexpr int kNChunk = kPGQ / kQC;          // 4; chunk j belongs to out-frame j / 2
constexpr int kCT = 8;                       // channels a feat group: the aggregation's n8
constexpr int kNCT = kPC / kCT;              // 8 groups a tile
constexpr int kBlockK = kQC * kCT;           // 128: a contraction block's depth, kk = q * 8 + c
constexpr int kSlotBytes = 8192;             // a W slice: 64 o x one 128-byte atom of depth
constexpr int kGroupBytes = kTR * kPE * kCT * 4;  // a feat group: 16 rows x 32 edges x 8 channels
constexpr int kFeatSlots = 2;                // the feat ring
constexpr int kCWarps = 8;                   // consumer warps: two warpgroups
constexpr int kConsumers = 32 * kCWarps;
constexpr int kTileThreads = kConsumers + 128;  // and the producer warpgroup (two of its warps load)
constexpr int kBarAll = 1;                   // the named barrier of the consumers

template <typename T>
struct TileCfg {
  static constexpr int kSz = static_cast<int>(sizeof(T));
  static constexpr int kE16 = 16 / kSz;                    // values in 16 bytes
  static constexpr int kAtomK = 8 * kE16;                  // depth of a 128-byte atom row: 32 or 64
  static constexpr int kSlotsPerBlock = kBlockK / kAtomK;  // a W slice is one atom column deep: 4 or 2
  static constexpr int kSlots = kSz == 4 ? 6 : 12;         // the W ring
  static constexpr int kBasisBytes = kTR * kBlockK * kSz;  // a block's basis, 16 rows
  static constexpr int kPneBytes = kTR * kPE * kPGQ * kSz;  // the tile's pne, in fragment order
  // shared memory in bytes from a 1024-byte aligned base
  static constexpr int kOffBasis = kSlots * kSlotBytes;
  static constexpr int kOffFeat = kOffBasis + 2 * kBasisBytes;
  static constexpr int kOffPne = kOffFeat + kFeatSlots * kGroupBytes;
  static constexpr int kOffRed = kOffPne + kPneBytes;
  static constexpr int kOffBar = kOffRed + 2 * kCWarps * 4;
  static constexpr int kNBar = 2 * kFeatSlots + 2 * kSlots;
  static constexpr int kBytes = kOffBar + kNBar * 8 + 1024;  // + the alignment slack
  static_assert(kOffBasis % 1024 == 0 && kOffFeat % 1024 == 0 && kOffPne % 16 == 0, "aligned regions");
  static_assert(kPneBytes >= kConsumers * 2 * 8 * 4, "the epilogue's scratch fits in pne");
  static_assert(kBytes <= kSmemMax, "one block's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)), "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
// an arrival on b once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(b)) : "memory");
}
// bytes (a multiple of 16) from global to shared memory, completing on b
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, int bytes, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Byte offset of element (r, k) of a K-major operand of T in 128-byte
// swizzled atoms (8 rows x 128 bytes, the 16-byte chunks of row r XORed
// with r % 8: wgmma's 128-byte swizzle), atoms ordered [k / atom][r / 8]
// for nrg groups of 8 rows.
template <typename T>
__host__ __device__ constexpr int swz_off(int r, int k, int nrg) {
  return ((k / TileCfg<T>::kAtomK) * nrg + (r >> 3)) * 1024 + (r & 7) * 128 +
         ((((k % TileCfg<T>::kAtomK) / TileCfg<T>::kE16) ^ (r & 7)) << 4) + (k % TileCfg<T>::kE16) * TileCfg<T>::kSz;
}

// Float offset of feat[row][e][c] (c < 8) in a feat group: rows of 8
// channels, the four 32-byte edge rows of each 128-byte line permuted by
// ((e >> 2) & 1), so that the aggregation's fragment reads (edges 2 tig,
// + 1 of an 8-edge step, channel gid) hit 32 banks.
__device__ __forceinline__ int feat_off(int row, int e, int c) {
  return ((row * kPE + (e & ~3)) + ((e & 3) ^ ((e >> 2) & 1))) * kCT + c;
}

// wgmma operand descriptor: K-major, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }
// d = A . B over one 16-deep step, M = 64, N = 16 (d's input ignored: scale-d 0)
__device__ __forceinline__ void wgmma_m64n16k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(0));
}

// The W image: slice s = (block * kSlotsPerBlock + slice of the block) of
// kSlotBytes holds W^T[o][kk] of its depth range, kk = q * 8 + c within
// block (group t, chunk j) = t * 4 + j, gq = 16 j + q, channel 8 t + c,
// at swz_off(o, kk % atom, 8), rounded to T.  The blocks' order is the
// kernel's: feat group outer, chunk inner.
template <typename T>
__global__ void __launch_bounds__(256) stage_w_image(const float* __restrict__ w, T* __restrict__ img) {
  using Cfg = TileCfg<T>;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= kPGQ * kPC * kPO) return;
  const int o = i % kPO, c = (i / kPO) % kPC, gq = i / (kPO * kPC);
  const int kk = (gq % kQC) * kCT + c % kCT;
  const int slice = ((c / kCT) * kNChunk + gq / kQC) * Cfg::kSlotsPerBlock + kk / Cfg::kAtomK;
  uint8_t* base = reinterpret_cast<uint8_t*>(img) + static_cast<long long>(slice) * kSlotBytes;
  *reinterpret_cast<T*>(base + swz_off<T>(o, kk % Cfg::kAtomK, 8)) = from_f<T>(w[i]);
}

// The geo operand of a warp's two rows (lr0, lr0 + 1 of tile tt), as the pne
// product's B fragments, k >= D zeros; fetched a tile ahead.
template <typename T>
struct GeoFrags {
  static constexpr int kK = sizeof(T) == 4 ? 3 : 2;   // depth steps: 24 = 3 x 8 (TF32), 32 = 2 x 16 (bf16)
  static constexpr int kV = sizeof(T) == 4 ? 2 : 4;   // values of a step
  float v[2][4][kK][kV];
  __device__ __forceinline__ void load(const float* __restrict__ geo, long long tt, int ntiles, int lr0, int D,
                                       int gid, int tig) {
    if (tt >= ntiles) {  // past the block's last tile: never used, but zeros (a bare
                         // return compiled to a tile loop 5% slower on the H100)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int ks = 0; ks < kK; ++ks)
#pragma unroll
            for (int x = 0; x < kV; ++x) v[rr][n][ks][x] = 0.f;
      return;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* gr = geo + ((tt * kTR + lr0 + rr) * kPE + 8 * n + gid) * D;
#pragma unroll
        for (int ks = 0; ks < kK; ++ks)
#pragma unroll
          for (int x = 0; x < kV; ++x) {
            // TF32: k = 8 ks + tig (+4); bf16: 16 ks + 2 tig (+1, +8, +9)
            const int k = sizeof(T) == 4 ? 8 * ks + tig + 4 * x : 16 * ks + 2 * tig + (x & 1) + 8 * (x >> 1);
            v[rr][n][ks][x] = k < D ? __ldg(gr + k) : 0.f;
          }
      }
  }
};

// gelu_tanh(x) = x * (1 + tanh(u)) / 2 = x / (1 + exp(-2u)), u = sqrt(2/pi)
// (x + 0.044715 x^3): one accurate expf and a fast division, branch-free,
// where tanhf takes two paths by |u|.  Within a few float32 ulp of
// gelu_tanh (the card's gates hold it to the plain version's values).
__device__ __forceinline__ float gelu_tanh_exp(float x) {
  const float u = kSqrt2OverPi * (x + kGeluCubic * (x * x * x));
  return __fdividef(x, 1.0f + expf(-2.0f * u));
}

// pre^T[gq][e] = proj^T[gq][k] . geo^T[k][e] for the warp's two rows and
// chunk j, then gelu: pne[rr][n][v] at gq = 16j + gid (+8 for v >= 2), edge
// 8n + 2 tig (+1 for odd v) of row lr0 + rr (the mma accumulator layout).
// geo and proj rounded to T; k >= D are zeros.
template <typename T>
__device__ __forceinline__ void pne_chunk(float (&pne)[2][4][4], const GeoFrags<T>& g,
                                          const float* __restrict__ proj, int j, int D, int gid, int tig) {
  const int gq = kQC * j + gid;
  auto P = [&](int k, int dg) { return k < D ? rnd<T>(__ldg(proj + k * kPGQ + gq + dg)) : 0.f; };
  if constexpr (sizeof(T) == 4) {
    uint32_t ah[3][4], al[3][4];
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      const int k = 8 * ks + tig;
      split_tf32(P(k, 0), ah[ks][0], al[ks][0]);
      split_tf32(P(k, 8), ah[ks][1], al[ks][1]);
      split_tf32(P(k + 4, 0), ah[ks][2], al[ks][2]);
      split_tf32(P(k + 4, 8), ah[ks][3], al[ks][3]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 3; ++ks) {
          uint32_t bh[2], bl[2];
          split_tf32(g.v[rr][n][ks][0], bh[0], bl[0]);
          split_tf32(g.v[rr][n][ks][1], bh[1], bl[1]);
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, al[ks], bh);
          mma_tf32(p, ah[ks], bl);
          mma_tf32(p, ah[ks], bh);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] += p[v];
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) pne[rr][n][v] = gelu_tanh_exp(acc[v]);
      }
  } else {
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k = 16 * ks + 2 * tig;
      a[ks][0] = pack_bf16(__float2bfloat16_rn(P(k, 0)), __float2bfloat16_rn(P(k + 1, 0)));
      a[ks][1] = pack_bf16(__float2bfloat16_rn(P(k, 8)), __float2bfloat16_rn(P(k + 1, 8)));
      a[ks][2] = pack_bf16(__float2bfloat16_rn(P(k + 8, 0)), __float2bfloat16_rn(P(k + 9, 0)));
      a[ks][3] = pack_bf16(__float2bfloat16_rn(P(k + 8, 8)), __float2bfloat16_rn(P(k + 9, 8)));
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const float* x = g.v[rr][n][ks];
          const uint32_t bb[2] = {pack_bf16(__float2bfloat16_rn(x[0]), __float2bfloat16_rn(x[1])),
                                  pack_bf16(__float2bfloat16_rn(x[2]), __float2bfloat16_rn(x[3]))};
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(p, a[ks], bb);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] += p[v];
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) pne[rr][n][v] = gelu_tanh_exp(acc[v]);
      }
  }
}

// The warp's pne of chunk j in shared memory, in fragment order: each lane
// keeps its own accumulator values (rounded to T), read back by the same
// lane for the aggregation.  float32: a float4 per (row, chunk, 8-edge
// step); bfloat16: the aggregation's packed A fragment, a uint4 per (row,
// chunk, 16-edge step).
template <typename T>
__device__ __forceinline__ void pne_store(uint8_t* pw, const float (&pne)[2][4][4], int j, int lane) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        reinterpret_cast<float4*>(pw)[((rr * kNChunk + j) * 4 + n) * 32 + lane] =
            make_float4(pne[rr][n][0], pne[rr][n][1], pne[rr][n][2], pne[rr][n][3]);
    } else {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* p0 = pne[rr][2 * ks];
        const float* p1 = pne[rr][2 * ks + 1];
        reinterpret_cast<uint4*>(pw)[((rr * kNChunk + j) * 2 + ks) * 32 + lane] =
            make_uint4(pack_bf16(__float2bfloat16_rn(p0[0]), __float2bfloat16_rn(p0[1])),
                       pack_bf16(__float2bfloat16_rn(p0[2]), __float2bfloat16_rn(p0[3])),
                       pack_bf16(__float2bfloat16_rn(p1[0]), __float2bfloat16_rn(p1[1])),
                       pack_bf16(__float2bfloat16_rn(p1[2]), __float2bfloat16_rn(p1[3])));
      }
    }
  }
}

// basis[gq][c] of feat group fg (8 channels) and chunk j for the warp's two
// rows: a[rr][v] at gq = 16j + gid (+8 for v >= 2), c = 2 tig (+1 for odd
// v).  TF32: pne's accumulator tile is the A fragment with the depth index
// relabelled (position tig <-> edge 2 tig, tig + 4 <-> 2 tig + 1), and so
// is feat's B fragment.
template <typename T>
__device__ __forceinline__ void agg_block(float (&a)[2][4], const uint8_t* pw, const float* fg, int lr0, int j,
                                          int lane, int gid, int tig) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float4 p = reinterpret_cast<const float4*>(pw)[((rr * kNChunk + j) * 4 + n) * 32 + lane];
        uint32_t ah[4], al[4], bh[2], bl[2];
        split_tf32(p.x, ah[0], al[0]);
        split_tf32(p.z, ah[1], al[1]);
        split_tf32(p.y, ah[2], al[2]);
        split_tf32(p.w, ah[3], al[3]);
        const int e = 8 * n + 2 * tig;
        split_tf32(fg[feat_off(lr0 + rr, e, gid)], bh[0], bl[0]);
        split_tf32(fg[feat_off(lr0 + rr, e + 1, gid)], bh[1], bl[1]);
        float q[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(q, al, bh);
        mma_tf32(q, ah, bl);
        mma_tf32(q, ah, bh);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] += q[v];
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint4 p = reinterpret_cast<const uint4*>(pw)[((rr * kNChunk + j) * 2 + ks) * 32 + lane];
        const uint32_t af[4] = {p.x, p.y, p.z, p.w};
        const int e = 16 * ks + 2 * tig;
        auto F = [&](int ee) { return __float2bfloat16_rn(fg[feat_off(lr0 + rr, ee, gid)]); };
        const uint32_t bb[2] = {pack_bf16(F(e), F(e + 1)), pack_bf16(F(e + 8), F(e + 9))};
        float q[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(q, af, bb);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] += q[v];
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) a[rr][v] = acc[v];
  }
}

// The swap: basis (rounded to T) of tile row r at kk = 8 q + c, q = gid
// (+8), c = 2 tig (+1), into the block's [16 rows][128] buffer.
template <typename T>
__device__ __forceinline__ void swap_store(uint8_t* bb, const float* a, int r, int gid, int tig) {
  const int kk = kCT * gid + 2 * tig;
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(bb + swz_off<T>(r, kk, 2)) = make_float2(a[0], a[1]);
    *reinterpret_cast<float2*>(bb + swz_off<T>(r, kk + 8 * kCT, 2)) = make_float2(a[2], a[3]);
  } else {
    *reinterpret_cast<uint32_t*>(bb + swz_off<T>(r, kk, 2)) =
        pack_bf16(__float2bfloat16_rn(a[0]), __float2bfloat16_rn(a[1]));
    *reinterpret_cast<uint32_t*>(bb + swz_off<T>(r, kk + 8 * kCT, 2)) =
        pack_bf16(__float2bfloat16_rn(a[2]), __float2bfloat16_rn(a[3]));
  }
}

// The sum of the block's 16 x 128 values, consumer i reading values i, i +
// 256, ... (another mapping than the stores').
template <typename T>
__device__ __forceinline__ float block_readback(const uint8_t* bb, int i) {
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < kTR * kBlockK / kConsumers; ++v) {
    const int x = i + kConsumers * v;
    s += to_f(*reinterpret_cast<const T*>(bb + swz_off<T>(x >> 7, x & 127, 2)));
  }
  return s;
}

// acc[n][v] += warpgroup h's half of the block's contraction (its slices),
// D^T[o][row] with o = 16 wq + gid (+8 for v >= 2), tile row 8n + 2 tig (+1
// for odd v): W^T from the ring (the block's first slice is fill f), basis^T
// from bb.  float32: mma.sync 3xTF32, each warp its 16 o over the 16 rows;
// bfloat16: wgmma m64n16k16 by the warpgroup.
template <typename T>
__device__ __forceinline__ void contract_half(float (&acc)[2][4], const uint8_t* slots, const uint8_t* bb,
                                              uint64_t* w_full, uint64_t* w_empty, long long f, int h, int wq,
                                              int gid, int tig, int lane) {
  using Cfg = TileCfg<T>;
  constexpr int kHalf = Cfg::kSlotsPerBlock / 2;
#pragma unroll
  for (int s = 0; s < kHalf; ++s) {
    const int sb = h * kHalf + s;  // the slice of the block
    const long long fs = f + sb;
    const int slot = static_cast<int>(fs % Cfg::kSlots);
    mbar_wait(w_full + slot, static_cast<int>((fs / Cfg::kSlots) & 1));
    const uint8_t* ws = slots + slot * kSlotBytes;
    if constexpr (sizeof(T) == 4) {
      const int o = 16 * wq + gid;
#pragma unroll
      for (int ks = 0; ks < Cfg::kAtomK / 8; ++ks) {
        const int k = 8 * ks + tig, kk = Cfg::kAtomK * sb + k;
        uint32_t ah[4], al[4];
        split_tf32(*reinterpret_cast<const float*>(ws + swz_off<T>(o, k, 8)), ah[0], al[0]);
        split_tf32(*reinterpret_cast<const float*>(ws + swz_off<T>(o + 8, k, 8)), ah[1], al[1]);
        split_tf32(*reinterpret_cast<const float*>(ws + swz_off<T>(o, k + 4, 8)), ah[2], al[2]);
        split_tf32(*reinterpret_cast<const float*>(ws + swz_off<T>(o + 8, k + 4, 8)), ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t bh[2], bl[2];
          split_tf32(*reinterpret_cast<const float*>(bb + swz_off<T>(8 * n + gid, kk, 2)), bh[0], bl[0]);
          split_tf32(*reinterpret_cast<const float*>(bb + swz_off<T>(8 * n + gid, kk + 4, 2)), bh[1], bl[1]);
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, al, bh);
          mma_tf32(p, ah, bl);
          mma_tf32(p, ah, bh);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[n][v] += p[v];
        }
      }
    } else {
      constexpr int kSteps = Cfg::kAtomK / 16;  // 4 16-deep steps a slice
      float p[kSteps][8];
#pragma unroll
      for (int i = 0; i < kSteps; ++i)
#pragma unroll
        for (int v = 0; v < 8; ++v) p[i][v] = 0.f;
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < kSteps; ++kq)
        wgmma_m64n16k16(p[kq], wg_desc(ws + 32 * kq), wg_desc(bb + 2048 * sb + 32 * kq));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < kSteps; ++i)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[v >> 2][v & 3] += p[i][v];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(w_empty + slot);
  }
}

// Persistent blocks: block c walks the 16-row tiles tt = c, c + blocks, ...
// (ntiles = B * M / 16, batch-flat rows).  geo [B*M*E, D], feat [B*M, E, C],
// proj [D, GQ], wimg the W image (stage_w_image), out [B, G, M, O]
// (kReduce), part [ntiles]: the sum of the tile's stage values.
template <int kStage, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
tile_fwd(const float* __restrict__ geo, const float* __restrict__ feat, const float* __restrict__ proj,
         const void* __restrict__ wimg, float* __restrict__ out, float* __restrict__ part, int ntiles, int M,
         int D) {
  using Cfg = TileCfg<T>;
  constexpr bool kFeat = kStage >= kAgg, kW = kStage == kReduce;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* slots = smem;
  uint8_t* basis = smem + Cfg::kOffBasis;
  float* featS = reinterpret_cast<float*>(smem + Cfg::kOffFeat);
  uint8_t* pneS = smem + Cfg::kOffPne;
  float* red = reinterpret_cast<float*>(smem + Cfg::kOffRed);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Cfg::kOffBar);
  uint64_t* feat_full = bars;
  uint64_t* feat_empty = feat_full + kFeatSlots;
  uint64_t* w_full = feat_empty + kFeatSlots;
  uint64_t* w_empty = w_full + Cfg::kSlots;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kFeatSlots; ++s) {
      mbar_init(feat_full + s, 32);
      mbar_init(feat_empty + s, kCWarps);
    }
    for (int s = 0; s < Cfg::kSlots; ++s) {
      mbar_init(w_full + s, 1);
      mbar_init(w_empty + s, 4);  // a slice serves one warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int blk = static_cast<int>(blockIdx.x), nb = static_cast<int>(gridDim.x);
  const int my_tiles = (ntiles - 1 - blk) / nb + 1;  // the grid is at most ntiles blocks
  auto tile_of = [&](int it) { return blk + static_cast<long long>(it) * nb; };

  if (warp >= kCWarps) {
    // ---- the producer warpgroup hands its registers to the consumers (12
    // warps start at 168 registers a thread; 4 x 40 + 8 x 232 fit the same
    // 65,536); its first warp loads feat, its second W
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp == kCWarps && kFeat) {  // feat, group by group, a group ahead of the consumers
      const int steps = my_tiles * kNCT;
      for (int q = 0; q < steps; ++q) {
        const int slot = q % kFeatSlots;
        if (q >= kFeatSlots) mbar_wait(feat_empty + slot, (q / kFeatSlots - 1) & 1);
        const float* src = feat + tile_of(q / kNCT) * kTR * kPE * kPC + kCT * (q % kNCT);
        float* dst = featS + slot * (kGroupBytes / 4);
        for (int i = lane; i < kTR * kPE * 2; i += 32) {  // (row, edge) i / 2, channels 4 (i & 1) ..
          const int re = i >> 1, c = 4 * (i & 1);
          cp_async16(dst + feat_off(re / kPE, re % kPE, c), src + re * kPC + c, 16);
        }
        cp_async_arrive(feat_full + slot);
      }
      cp_wait_all();
    } else if (warp == kCWarps + 1 && kW && lane == 0) {  // the W slices, every tile's in the consumers' order
      const long long fills = static_cast<long long>(my_tiles) * kNCT * kNChunk * Cfg::kSlotsPerBlock;
      const uint8_t* src = static_cast<const uint8_t*>(wimg);
      constexpr int kPerTile = kNCT * kNChunk * Cfg::kSlotsPerBlock;
      for (long long f = 0; f < fills; ++f) {
        const int s = static_cast<int>(f % Cfg::kSlots);
        if (f >= Cfg::kSlots) mbar_wait(w_empty + s, static_cast<int>((f / Cfg::kSlots - 1) & 1));
        mbar_expect_tx(w_full + s, kSlotBytes);
        bulk_g2s(slots + s * kSlotBytes, src + (f % kPerTile) * kSlotBytes, kSlotBytes, w_full + s);
      }
    }
    return;
  }

  // ---- the consumers: warp w (warpgroup h = w / 4, wq = w % 4) computes the
  // pne and the aggregation of tile rows lr0 = 2w, + 1, and the contraction's
  // o = 16 wq .. + 15 of all 16 rows over warpgroup h's half of each block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int h = warp >> 2, wq = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int lr0 = 2 * warp;
  uint8_t* pw = pneS + warp * (Cfg::kPneBytes / kCWarps);
  GeoFrags<T> gnext;
  gnext.load(geo, tile_of(0), ntiles, lr0, D, gid, tig);
  long long f = 0;
  int buf = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const long long tt = tile_of(it);
    const GeoFrags<T> gcur = gnext;
    gnext.load(geo, tile_of(it + 1), ntiles, lr0, D, gid, tig);
    float tsum = 0.f;
#pragma unroll 1
    for (int j = 0; j < kNChunk; ++j) {
      float pne[2][4][4];
      pne_chunk<T>(pne, gcur, proj, j, D, gid, tig);
      if constexpr (kStage == kPne) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int v = 0; v < 4; ++v) tsum += pne[rr][n][v];
      } else {
        pne_store<T>(pw, pne, j, lane);
      }
    }
    if constexpr (kStage != kPne) {
      __syncwarp();
      float acc[2][2][4] = {};  // [g][row half][v]: warpgroup h's half of the contraction
#pragma unroll 1
      for (int t = 0; t < kNCT; ++t) {
        const int q = it * kNCT + t, fslot = q % kFeatSlots;
        mbar_wait(feat_full + fslot, (q / kFeatSlots) & 1);
        const float* fg = featS + fslot * (kGroupBytes / 4);
#pragma unroll
        for (int j = 0; j < kNChunk; ++j) {
          float a[2][4];
          agg_block<T>(a, pw, fg, lr0, j, lane, gid, tig);
          if (j == kNChunk - 1) {
            __syncwarp();
            if (lane == 0) mbar_arrive(feat_empty + fslot);
          }
          if constexpr (kStage == kAgg) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
#pragma unroll
              for (int v = 0; v < 4; ++v) tsum += a[rr][v];
          } else {
            uint8_t* bb = basis + buf * Cfg::kBasisBytes;
            swap_store<T>(bb, a[0], lr0, gid, tig);
            swap_store<T>(bb, a[1], lr0 + 1, gid, tig);
            if constexpr (sizeof(T) == 2 && kStage == kReduce)
              asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            named_sync(kBarAll, kConsumers);
            if constexpr (kStage == kSwap) {
              tsum += block_readback<T>(bb, tid);
            } else {
              contract_half<T>(acc[j >> 1], slots, bb, w_full, w_empty, f, h, wq, gid, tig, lane);
              f += Cfg::kSlotsPerBlock;
            }
            buf ^= 1;
          }
        }
      }
      if constexpr (kStage == kReduce) {
        // out = warpgroup 0's half + warpgroup 1's, through pne's space (free now)
        float* scratch = reinterpret_cast<float*>(pneS) + (tid & 127) * 16;
        if (h == 1) {
#pragma unroll
          for (int i = 0; i < 16; i += 4)
            *reinterpret_cast<float4*>(scratch + i) = make_float4(
                acc[i >> 3][(i >> 2) & 1][0], acc[i >> 3][(i >> 2) & 1][1], acc[i >> 3][(i >> 2) & 1][2],
                acc[i >> 3][(i >> 2) & 1][3]);
        }
        named_sync(kBarAll, kConsumers);
        if (h == 0) {
#pragma unroll
          for (int g = 0; g < kPG; ++g)
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const float4 o1 = *reinterpret_cast<const float4*>(scratch + 8 * g + 4 * n);
              const float other[4] = {o1.x, o1.y, o1.z, o1.w};
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                const float y = acc[g][n][v] + other[v];
                const long long r = tt * kTR + 8 * n + 2 * tig + (v & 1);
                const long long bi = r / M, m = r - bi * M;
                out[((bi * kPG + g) * M + m) * kPO + 16 * wq + gid + 8 * (v >> 1)] = y;
                tsum += y;
              }
            }
        }
      }
    }
    // the tile's sum: a shuffle tree in each warp, then the warps in order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
    float* r = red + (it & 1) * kCWarps;
    if (lane == 0) r[warp] = tsum;
    named_sync(kBarAll, kConsumers);
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kCWarps; ++w) s += r[w];
      part[tt] = s;
    }
  }
}

typedef void (*TileKernel)(const float*, const float*, const float*, const void*, float*, float*, int, int, int);

template <int S>
TileKernel tile_pick(bool use_bf16) {
  return use_bf16 ? tile_fwd<S, bf16> : tile_fwd<S, float>;
}

TileKernel tile_kernel(int stage, bool use_bf16) {
  switch (stage) {
    case kPne: return tile_pick<kPne>(use_bf16);
    case kAgg: return tile_pick<kAgg>(use_bf16);
    case kSwap: return tile_pick<kSwap>(use_bf16);
    case kReduce: return tile_pick<kReduce>(use_bf16);
    default: return nullptr;
  }
}

int tile_smem_bytes(bool use_bf16) { return use_bf16 ? TileCfg<bf16>::kBytes : TileCfg<float>::kBytes; }

// blocks an SM and on the card at once (cached per instantiation): the
// persistent grid is that many blocks at most
cudaError_t tile_occupancy(TileKernel kern, int stage, bool use_bf16, int* per_sm, int* blocks) {
  static int cache[5][2][2] = {};
  int* c = cache[stage][use_bf16 ? 1 : 0];
  if (c[1] == 0) {
    const int smem = tile_smem_bytes(use_bf16);
    int dev = 0, nsm = 0;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(c, kern, kTileThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    c[1] = nsm * c[0];
    if (err == cudaSuccess && c[1] == 0) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return err;
  }
  *per_sm = c[0];
  *blocks = c[1];
  return cudaSuccess;
}

// ============================================================================
// Tensor mode: stage_fwd (see the design at the top of the file).
// ============================================================================

constexpr int kTThreads = 256;                 // 8 warps; warp w owns tile rows 2w, 2w + 1
constexpr int kTWarps = kTThreads / 32;
constexpr int kTChunks = kPGQ / kQC;           // 4 blocks a tile, one per chunk of 16 gq
constexpr int kSlice = 2 * kPE * kCT;          // 512 floats: a warp's feat group or a W k-step
static_assert(kCT * kPO == kSlice, "a W k-step (8 c x 64 o) fills one ring slot");
constexpr int kFeatSteps = kNCT;               // 8 feat groups of 8 channels
constexpr int kWSteps = 2 * (kPC / kCT);       // the warp's 2 q x 8 k-steps of 8 channels
constexpr int kBasisFloats = kQC * kTR * kPC;  // the chunk's basis, 64 KB (wcontract, reduce)
constexpr int kGeoFloats = 2 * kPE * kDMax;    // a warp's two rows of geo, at most
constexpr int kPneStride = kQC + 4;            // s1's staging row: one edge's 16 gq, padded
static_assert(kTWarps * kGeoFloats <= kBasisFloats, "the warps' geo fits the basis region");

// a warp's scratch: its rows' geo, then (pne) one row's staging
__host__ __device__ constexpr int scratch_floats(int stage) {
  return kGeoFloats + (stage == kPne ? kPE * kPneStride : 0);
}

// the slots of a warp's ring by stage: feat only (agg, swap), or feat then
// W (wcontract, reduce, beside the 64 KB basis)
__host__ __device__ constexpr int ring_slots(int stage) { return stage >= kWcontract ? 2 : 3; }
// shared memory in floats: the scratch (or the basis holding it), then the
// rings
__host__ __device__ constexpr int ring_offset(int stage) {
  return stage >= kWcontract ? kBasisFloats : kTWarps * scratch_floats(stage);
}
constexpr int tensor_smem_bytes(int stage) {
  return 4 * (ring_offset(stage) + (stage == kPne ? 0 : kTWarps * ring_slots(stage) * kSlice));
}
static_assert(tensor_smem_bytes(kAgg) <= kSmemMax / 2 - 1024 && tensor_smem_bytes(kReduce) <= kSmemMax / 2 - 1024,
              "two blocks an SM");

// Float offset of basis[q][row][c] in the chunk's basis: [16 q][16 rows][64
// c], each row's 16-byte chunks XORed with (row + q) % 8, so that the
// contraction's A fragment reads (rows gid, + 8; c = tig, + 4) and the
// aggregation's stores (q = gid, + 8; c pairs) fall on distinct banks.
__device__ __forceinline__ int basis_off(int q, int row, int c) {
  return (q * kTR + row) * kPC + (c ^ (((row + q) & 7) << 2));
}

// Float offset of W[c][o] in a W k-step slice (8 c x 64 o), each row's
// 8-float groups XORed with c % 4: the B fragment reads (c = tig, tig + 4;
// o = 8 nt + gid) fall on distinct banks.
__device__ __forceinline__ int w_off(int c, int o) { return c * kPO + (o ^ ((c & 3) << 3)); }

// Float offset of element (row, o) of a 16 x 64 output tile staged for
// 16-byte stores, each row's 8-float groups XORed with row % 8.
__device__ __forceinline__ int tile_off(int row, int o) { return row * kPO + (o ^ ((row & 7) << 3)); }

// pre^T[gq][e] = [proj; bias]^T[gq][k] . [geo, 1]^T[k][e] for the 32 edges
// of one query row (its geo rows at gr, in shared memory), then gelu:
// pne[n][v] at gq = gq0 + gid
// (+8 for v >= 2), edge 8n + 2 tig (+1 for odd v) (the mma accumulator).
// The bias is row k = D of the product: geo reads a one there and (ah, al),
// the A fragments of proj by depth step, hold the bias; k > D are zeros.
__device__ __forceinline__ void pne_row(float (&pne)[4][4], const float* gr, int D,
                                        const uint32_t (&ah)[3][4], const uint32_t (&al)[3][4], int gid,
                                        int tig) {
  float x[4][3][2];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * ks + tig + 4 * h;
        x[n][ks][h] = k < D ? gr[(8 * n + gid) * D + k] : (k == D ? 1.f : 0.f);
      }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      uint32_t bh[2], bl[2];
      split_tf32(x[n][ks][0], bh[0], bl[0]);
      split_tf32(x[n][ks][1], bh[1], bl[1]);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(p, al[ks], bh);
      mma_tf32(p, ah[ks], bl);
      mma_tf32(p, ah[ks], bh);
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] += p[v];
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) pne[n][v] = gelu_tanh_exp(acc[v]);
  }
}

// Block (x, y): tile x / 4 (query rows m0 = 16 (x / 4) ..) of batch y,
// chunk j = x % 4 (gq0 = 16 j); the reduce stage runs in clusters of 2
// blocks, the two chunks of out-frame j / 2.  Tensors, batch leading: geo
// [B, M*E, D], feat [B, M, E, C], proj [D, GQ], bias [GQ], W [GQ, C, O];
// out by stage: pne [B, M*E, GQ], basis_t [B, M, GQ, C], basis_b [B, GQ, M,
// C], per_gq [B, GQ, M, O], out [B, G, M, O].
template <int kStage>
__global__ void __launch_bounds__(kTThreads, 2)
stage_fwd(const float* __restrict__ geo, const float* __restrict__ feat, const float* __restrict__ proj,
          const float* __restrict__ bias, const float* __restrict__ w, float* __restrict__ out, int M, int D) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kFeat = kStage >= kAgg ? kFeatSteps : 0;
  constexpr int kSteps = kFeat + (kStage >= kWcontract ? kWSteps : 0);
  constexpr int kRing = ring_slots(kStage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int j = static_cast<int>(blockIdx.x) & (kTChunks - 1), gq0 = kQC * j;
  const int b = static_cast<int>(blockIdx.y), m0 = static_cast<int>(blockIdx.x / kTChunks) * kTR;
  const long long row0 = static_cast<long long>(b) * M + m0;  // the tile's first row, batch-flat
  const int lr0 = 2 * warp;
  float* basis = smem;
  float* scratch = smem + warp * scratch_floats(kStage);
  float* ring = smem + ring_offset(kStage) + warp * kRing * kSlice;

  // the warp's ring: steps 0-7 feat group t of its two rows, then (wcontract,
  // reduce) the W k-steps of its two q; one cp.async group a step
  auto load_step = [&](int s) {
    float* dst = ring + (s % kRing) * kSlice;
    if (s < kFeat) {  // (row, edge) i / 2, channels 4 (i & 1) .. + 3 of group s
      const float* src = feat + (row0 + lr0) * kPE * kPC + kCT * s;
#pragma unroll
      for (int k = 0; k < 2 * kPE * 2 / 32; ++k) {
        const int i = lane + 32 * k, re = i >> 1, c = 4 * (i & 1);
        cp_async16(dst + feat_off(re / kPE, re % kPE, c), src + re * kPC + c, 16);
      }
    } else {  // W[gq0 + q][8 ks + c][o]: row c = i / 16, o = 4 (i % 16) .. + 3
      const int ws = s - kFeat, q = lr0 + ws / (kPC / kCT), c0 = kCT * (ws % (kPC / kCT));
      const float* src = w + (static_cast<long long>(gq0 + q) * kPC + c0) * kPO;
#pragma unroll
      for (int k = 0; k < kCT * kPO / 4 / 32; ++k) {
        const int i = lane + 32 * k, c = i >> 4, o = 4 * (i & 15);
        cp_async16(dst + w_off(c, o), src + c * kPO + o, 16);
      }
    }
  };
  // before step s: the slot of step s - 1 is free (every lane is past it),
  // step s + kRing - 1 is issued and step s has landed
  auto next_step = [&](int s) {
    __syncwarp();
    if (s + kRing - 1 < kSteps) load_step(s + kRing - 1);
    cp_commit();
    cp_wait_but<kRing - 1>();
    __syncwarp();
  };
  // the warp's rows' geo into its scratch, 8 D float4s a row: the first two
  // cp.async groups, so that row 0's pne starts while row 1's geo lands
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float* src = geo + (row0 + lr0 + rr) * kPE * D;
    for (int i = lane; i < kPE * D / 4; i += 32) cp_async16(scratch + rr * kPE * D + 4 * i, src + 4 * i, 16);
    cp_commit();
  }
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < kSteps) load_step(s);
    cp_commit();
  }

  // 1. pne of the warp's rows for the chunk's 16 gq on mma.sync 3xTF32
  float pne[2][4][4];
  {
    uint32_t ah[3][4], al[3][4];
    auto P = [&](int k, int dg) {
      const int gq = gq0 + gid + dg;
      return k < D ? __ldg(proj + k * kPGQ + gq) : (k == D ? __ldg(bias + gq) : 0.f);
    };
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      const int k = 8 * ks + tig;
      split_tf32(P(k, 0), ah[ks][0], al[ks][0]);
      split_tf32(P(k, 8), ah[ks][1], al[ks][1]);
      split_tf32(P(k + 4, 0), ah[ks][2], al[ks][2]);
      split_tf32(P(k + 4, 8), ah[ks][3], al[ks][3]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (rr == 0)
        cp_wait_but<kRing>();  // row 0's geo (row 1's and the ring's first groups may be in flight)
      else
        cp_wait_but<kRing - 1>();
      __syncwarp();
      pne_row(pne[rr], scratch + rr * kPE * D, D, ah, al, gid, tig);
      if constexpr (kStage == kPne) {
        // the row's pne through staging rows [32 edges][16 gq + 4] of the
        // warp's scratch (past its geo) to 16-byte stores
        float* st = scratch + 2 * kPE * D;
        __syncwarp();  // every lane is past the last row's staging
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int v = 0; v < 4; ++v) st[(8 * n + 2 * tig + (v & 1)) * kPneStride + gid + 8 * (v >> 1)] = pne[rr][n][v];
        __syncwarp();
        float* dst = out + (row0 + lr0 + rr) * kPE * kPGQ + gq0;
#pragma unroll
        for (int k = 0; k < kPE * (kQC / 4) / 32; ++k) {
          const int i = lane + 32 * k, e = i >> 2, q4 = 4 * (i & 3);
          *reinterpret_cast<float4*>(dst + e * kPGQ + q4) = *reinterpret_cast<const float4*>(st + e * kPneStride + q4);
        }
      }
    }
  }
  if constexpr (kStage == kPne) return;

  // 2. the aggregation, feat group by group: basis[q][row][c] of the
  // warp's rows on mma.sync 3xTF32, pne's accumulator tile the A fragment
  // with the depth relabelled (position tig <-> edge 2 tig, tig + 4 <-> 2
  // tig + 1); s2 / s3 write it out group by group, s4 / s5 into the
  // chunk's basis in shared memory (over the warps' scratch: a barrier
  // first)
  if constexpr (kStage >= kWcontract) __syncthreads();
  {
    uint32_t ph[2][4][4], pl[2][4][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        split_tf32(pne[rr][n][0], ph[rr][n][0], pl[rr][n][0]);
        split_tf32(pne[rr][n][2], ph[rr][n][1], pl[rr][n][1]);
        split_tf32(pne[rr][n][1], ph[rr][n][2], pl[rr][n][2]);
        split_tf32(pne[rr][n][3], ph[rr][n][3], pl[rr][n][3]);
      }
#pragma unroll 2
    for (int t = 0; t < kFeatSteps; ++t) {
      next_step(t);
      const float* fg = ring + (t % kRing) * kSlice;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int e = 8 * n + 2 * tig;
          uint32_t bh[2], bl[2];
          split_tf32(fg[feat_off(rr, e, gid)], bh[0], bl[0]);
          split_tf32(fg[feat_off(rr, e + 1, gid)], bh[1], bl[1]);
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(p, pl[rr][n], bh);
          mma_tf32(p, ph[rr][n], bl);
          mma_tf32(p, ph[rr][n], bh);
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] += p[v];
        }
        const int row = lr0 + rr;
        if constexpr (kStage == kAgg || kStage == kSwap) {
          // 3. basis_t [.., M, GQ, C] or basis_b [.., GQ, M, C]: lanes tig,
          // tig ^ 1 trade a pair, so that each holds 4 channels of one q
          // (even tig: q = gid, odd: gid + 8), one 16-byte store a row
          const bool odd = tig & 1;
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[0] : acc[2], 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[1] : acc[3], 1);
          const float4 v = odd ? make_float4(r0, r1, acc[2], acc[3]) : make_float4(acc[0], acc[1], r0, r1);
          const int q = gid + (odd ? 8 : 0), c = kCT * t + 4 * (tig >> 1);
          float* dst = kStage == kAgg
                           ? out + ((row0 + row) * kPGQ + gq0 + q) * kPC + c
                           : out + ((static_cast<long long>(b) * kPGQ + gq0 + q) * M + m0 + row) * kPC + c;
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          const int c = kCT * t + 2 * tig;
          *reinterpret_cast<float2*>(basis + basis_off(gid, row, c)) = make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(basis + basis_off(gid + 8, row, c)) = make_float2(acc[2], acc[3]);
        }
      }
    }
  }
  if constexpr (kStage == kAgg || kStage == kSwap) return;
  __syncthreads();  // the chunk's basis is whole

  // 4. the weight contraction, warp w over its q = 2w, 2w + 1: D[16 rows][64
  // o] += basis[q][rows][8 c] . W[gq0 + q][8 c][64 o], each 8-deep slice
  // summed into a zeroed tile; W's k-steps come through the warp's ring
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;
#pragma unroll 1
  for (int qi = 0; qi < 2; ++qi) {
    const int q = lr0 + qi;
#pragma unroll 2
    for (int ks = 0; ks < kPC / kCT; ++ks) {
      const int s = kFeat + qi * (kPC / kCT) + ks;
      next_step(s);
      const float* ws = ring + (s % kRing) * kSlice;
      const int c = kCT * ks + tig;
      uint32_t ah[4], al[4];
      split_tf32(basis[basis_off(q, gid, c)], ah[0], al[0]);
      split_tf32(basis[basis_off(q, gid + 8, c)], ah[1], al[1]);
      split_tf32(basis[basis_off(q, gid, c + 4)], ah[2], al[2]);
      split_tf32(basis[basis_off(q, gid + 8, c + 4)], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bh[2], bl[2];
        split_tf32(ws[w_off(tig, 8 * nt + gid)], bh[0], bl[0]);
        split_tf32(ws[w_off(tig + 4, 8 * nt + gid)], bh[1], bl[1]);
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(p, al, bh);
        mma_tf32(p, ah, bl);
        mma_tf32(p, ah, bh);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[nt][v] += p[v];
      }
    }
    if (kStage == kWcontract || qi == 1) {
      // the warp's tile into its own q's basis rows (no other warp reads
      // them; reduce: its q = 2w + 1's)
      __syncwarp();
      float* st = basis + q * kTR * kPC;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<float2*>(st + tile_off(gid, 8 * nt + 2 * tig)) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(st + tile_off(gid + 8, 8 * nt + 2 * tig)) = make_float2(acc[nt][2], acc[nt][3]);
      }
      __syncwarp();
      if constexpr (kStage == kWcontract) {  // per_gq [.., GQ, M, O]: the q's 16 rows, one 4 KB run
        float* dst = out + ((static_cast<long long>(b) * kPGQ + gq0 + q) * M + m0) * kPO;
#pragma unroll
        for (int k = 0; k < kTR * kPO / 4 / 32; ++k) {
          const int i = lane + 32 * k, row = i >> 4, o = 4 * (i & 15);
          *reinterpret_cast<float4*>(dst + row * kPO + o) = *reinterpret_cast<const float4*>(st + tile_off(row, o));
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;
      }
    }
  }

  if constexpr (kStage == kReduce) {
    // 5. out-frame j / 2: the 8 warps' tiles added in warp order into the
    // block's partial, then the cluster's two partials in rank order (chunk
    // 2g, then 2g + 1) through distributed shared memory, each block writing
    // 8 of the 16 rows
    __syncthreads();
    float* part = smem + kBasisFloats;  // the rings are spent
    {
      const int row = tid >> 4, o = 4 * (tid & 15);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int wq = 0; wq < kTWarps; ++wq) {
        const float4 x = *reinterpret_cast<const float4*>(basis + (2 * wq + 1) * kTR * kPC + tile_off(row, o));
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      *reinterpret_cast<float4*>(part + row * kPO + o) = s;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = static_cast<int>(cluster.block_rank());
    if (tid < kTR * kPO / 8) {
      const int f = rank * (kTR * kPO / 8) + tid, row = f >> 4, o = 4 * (f & 15);
      const float4 x = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0))[f];
      const float4 y = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 1))[f];
      *reinterpret_cast<float4*>(out + ((static_cast<long long>(b) * kPG + (j >> 1)) * M + m0 + row) * kPO + o) =
          make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
    }
    cluster.sync();  // no block leaves while its partner still reads its partial
  }
}

typedef void (*StageKernel)(const float*, const float*, const float*, const float*, const float*, float*, int,
                            int);

StageKernel tensor_kernel(int stage) {
  switch (stage) {
    case kPne: return stage_fwd<kPne>;
    case kAgg: return stage_fwd<kAgg>;
    case kSwap: return stage_fwd<kSwap>;
    case kWcontract: return stage_fwd<kWcontract>;
    case kReduce: return stage_fwd<kReduce>;
    default: return nullptr;
  }
}

// the tensor-mode instantiation's dynamic shared memory, raised past 48 KB
// with the carveout at its most (two blocks an SM)
cudaError_t tensor_prepare(StageKernel kern, int stage) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, tensor_smem_bytes(stage));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace

// The instantiation's registers, local (stack and spill) bytes, static and
// dynamic shared memory, blocks an SM and blocks the card holds at once
// (the persistent grid's most; 0 in tensor mode): attrs[6];
// cudaErrorInvalidValue for a combination that is not instantiated.
extern "C" int se3_probe_stage_attrs(int stage, int mode, int use_bf16, int* attrs) {
  if (mode == kTensor) {
    const StageKernel kern = use_bf16 ? nullptr : tensor_kernel(stage);
    if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = tensor_smem_bytes(stage);
    cudaError_t err = tensor_prepare(kern, stage);
    if (err == cudaSuccess) err = static_cast<cudaError_t>(kernel_attrs(kern, smem, attrs));
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(attrs + 4, kern, kTThreads, smem);
    attrs[5] = 0;
    return static_cast<int>(err);
  }
  const TileKernel kern = mode == kTileSum ? tile_kernel(stage, use_bf16 != 0) : nullptr;
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = tile_occupancy(kern, stage, use_bf16 != 0, attrs + 4, attrs + 5);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_attrs(kern, tile_smem_bytes(use_bf16 != 0), attrs);
}

// geo [B, M*E, D], feat [B, M, E, C], proj [D, GQ], bias [GQ] (tensor mode)
// or null (tile-sum mode), w [GQ, C, O], all float32 (rounded inside where
// use_bf16); wimg: GQ * C * O floats of scratch for the W image (tile-sum
// mode's reduce stage) or null; out as the stage (null for pne, agg and
// swap in tile-sum mode); part [B*M/16] and total [1] in tile-sum mode:
// total = the sum of the stage's values, the tiles' partials added in tile
// order.  M a multiple of 16 rows; E = 32, GQ = 64 (G = 2, Q = 32), C = O =
// 64, D <= 19; in tensor mode geo, feat, w and out 16-byte aligned.
extern "C" int se3_probe_stage_fwd(const void* geo, const void* feat, const void* proj, const void* bias,
                                   const void* w, void* wimg, void* out, void* part, void* total, int B, int M,
                                   int D, int stage, int mode, int use_bf16, void* stream_ptr) {
  if (B < 1 || M < kRows || M % kRows != 0 || D < 1 || D > kDMax || (kEdges * D) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((bias != nullptr) != (mode == kTensor)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (mode == kTensor) {
    const StageKernel kern = use_bf16 ? nullptr : tensor_kernel(stage);
    const bool aligned = (reinterpret_cast<uintptr_t>(geo) | reinterpret_cast<uintptr_t>(feat) |
                          reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
    if (kern == nullptr || !aligned || B > 65535 || static_cast<long long>(M / kRows) * kTChunks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = tensor_prepare(kern, stage);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((M / kRows) * kTChunks, B);
    cfg.blockDim = dim3(kTThreads);
    cfg.dynamicSmemBytes = tensor_smem_bytes(stage);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;  // reduce: the two chunks of an out-frame
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = stage == kReduce ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(geo), static_cast<const float*>(feat),
                             static_cast<const float*>(proj), static_cast<const float*>(bias),
                             static_cast<const float*>(w), static_cast<float*>(out), M, D);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const bool bf = use_bf16 != 0;
  const TileKernel kern = mode == kTileSum ? tile_kernel(stage, bf) : nullptr;
  if (kern == nullptr || (stage == kReduce && (wimg == nullptr || out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, blocks = 0;
  cudaError_t err = tile_occupancy(kern, stage, bf, &per_sm, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = B * (M / kRows);
  if (stage == kReduce) {
    if (bf)
      stage_w_image<bf16><<<kPGQ * kPC * kPO / 256, 256, 0, stream>>>(static_cast<const float*>(w),
                                                                     static_cast<bf16*>(wimg));
    else
      stage_w_image<float><<<kPGQ * kPC * kPO / 256, 256, 0, stream>>>(static_cast<const float*>(w),
                                                                      static_cast<float*>(wimg));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = ntiles < blocks ? ntiles : blocks;
  kern<<<grid, kTileThreads, tile_smem_bytes(bf), stream>>>(
      static_cast<const float*>(geo), static_cast<const float*>(feat), static_cast<const float*>(proj), wimg,
      static_cast<float*>(out), static_cast<float*>(part), ntiles, M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_fixed<<<1, kPartThreads, 0, stream>>>(static_cast<const float*>(part), ntiles, 1,
                                                      static_cast<float*>(total));
  return static_cast<int>(cudaGetLastError());
}
