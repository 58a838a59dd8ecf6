// The conv's shared product on Hopper's tensor cores (sm_90a), float32
// operands in the 3xTF32 form or bfloat16 ones, float32 accumulation:
//
//   C[z][i, j] = sum over the depth k of split z, [z*kPer, min((z+1)*kPer, K)),
//                of A(i, k) * B(k, j)
//
// at the conv's three call sites (rows: the L*G live scratch rows):
//   forward  out  = basis . W    A = basis [rows, C*Q], depth contiguous;
//                                B = W [C*Q, O] through an image (below);
//                                row r stored at out row live[r / G]*G + r % G
//   d_w      d_w  = basis^T . gl A = basis read with the depth along its
//                                rows (A(i, k) = basis[k][i], M contiguous);
//                                B = gl [rows, O], the compact gout rows (N
//                                contiguous); split along the rows
//   dbasis   dbasis = gl . W^T   A = gl, depth contiguous; B = W^T through an
//                                image; stored over the basis scratch, in T
//
// Replaces the products that the TPU kernels compute in their own bodies
// (se3conv3d_tpu/ops/pallas/fused_equiv.py): _fwd_kernel's per_gq and its
// sum over q (the port's [L*G, C*Q] . [C*Q, O] with W shared over g sums
// over (c, q) at once), _bwd_kernel's dw2 (summed over g, as
// _unfold_param_grads does) and dbasis_b.
//
// What bounds it: at the ScanNet level 0 (131,072 rows, C*Q = 2,048, O = 64)
// each product is 34.4 GFLOP against one pass over the basis scratch (537 MB
// in float32 or 268 MB in bfloat16, or the same written by dbasis): bytes,
// 0.16 / 0.33 ms at 3.35 TB/s, where 3xTF32 at a third of 495 TFLOP/s
// needs 0.21 ms.  At C = O = 512 the products are bound by operations.  So
// the design keeps enough bytes in flight on every SM and leaves the
// tensor cores to wgmma:
//
// - a persistent grid, one block an SM: block b walks the items t = b, b +
//   gridDim.x, ... of (depth split z, row tile, column tile), the column
//   tile fastest, so blocks that run at once share their A rows in L2.
//   Each item is computed by one block in a fixed order, so the result does
//   not depend on the grid: two calls give the same bits.
// - a block of 384 threads: a producer warpgroup, whose first warp loads
//   and which gives its registers to two consumer warpgroups (setmaxnreg:
//   232 a consumer thread, where 9 warps would cap every thread at 168),
//   each of 64 rows of the 128-row tile (kPM) and BN = 64 or 128 columns.
// - a ring of kStages (4-8) stages of 128 depth bytes (32 float32 or 64
//   bfloat16 values), each completed on an mbarrier.  One lane of the
//   producer warp fills a stage with TMA: A as one box of a 2-D tensor map
//   ({128 bytes, 128 rows}, 128-byte swizzle; at d_w 2-4 boxes of 128 bytes
//   x the stage's depth rows), gl's depth rows (d_w: one box, or one a 64
//   columns swizzled in bfloat16), or W's stage as one cp.async.bulk of a
//   prebuilt image.  The maps are encoded
//   on the host by cuTensorMapEncodeTiled, which the runtime hands over
//   by its entry-point query: the libraries stay plain C for ctypes and
//   do not link libcuda.  Copying A row by row with cp.async.bulk (128
//   bytes a copy) cost ~45 ns a copy on the H100, ~6 us a stage: the TMA
//   unit's cost per request, not the bytes, set the time.  An operand
//   whose base or row stride is not a multiple of 16 bytes (no tensor map
//   describes it) is copied value by value by the warp into the same
//   layout instead, zeros past its edge as a box's fill.
// - bfloat16: both operands by descriptor, as the boxes land: A and W's
//   tile K-major (128-byte swizzle), d_w's basis and gl MN-major (wgmma's
//   transpose bits; LBO the box stride along M / N, SBO 1024 bytes a group
//   of 8 depth rows).  Nothing is copied or converted in shared memory.
// - float32 (3xTF32): tf32 wgmma reads a shared-memory operand only K-major
//   and needs the hi / lo split, so A reaches it from registers: each
//   consumer thread reads its fragment values of a slice from the stage
//   (the swizzle puts a warp's reads on 32 banks for depth-contiguous A,
//   two-way at d_w, whose M-contiguous basis is read as it lies) and
//   splits each into hi = tf32(x) and lo = tf32(x - hi) (to_tf32: an
//   integer add and mask).  B is K-major from shared memory: W's image
//   holds hi and lo tiles (8 bytes a weight: 1 MiB at the ScanNet level 0,
//   128 MiB at the O = 1024 global vector); d_w's B, gl, lies N-contiguous,
//   so the consumers split and transpose each stage's small gl tile (BN x
//   32 values, 8-16 a thread) into K-major hi / lo tiles (two such buffers,
//   reused every other stage), a named barrier of the 256 consumers, then
//   wgmma.  (The producer warpgroup's three idle warps, at 40 registers,
//   did it slower: d_w 0.67 -> 0.90 ms at the ScanNet level 0.)
// - W's image is made once a call (product_image, through shared memory):
//   for every column tile and stage its tiles in the ring's layout, zero
//   past J x K, so that a stage's B is one bulk copy.
// - the slice rule of the tensor cores' truncating adds: each 16-deep slice
//   (two k8 steps of three wgmma m64nNk8 in 3xTF32: lo.hi, hi.lo, hi.hi; or
//   one m64nNk16 in bfloat16) is summed into a zeroed accumulator (scale-d
//   0 on the slice's first step) and added to the running sum by a rounded
//   float32 add.  Up to four slice accumulators (kParts) take the slices
//   in turn, so later slices' products run while earlier ones are added.
// - the epilogue stores from registers, each quad of a row trading pairs so
//   that a thread writes whole 16-byte chunks (store_row: a quarter of the
//   store instructions of pairs, whole 32-byte sectors), through the row
//   map (mapped_row), or as split z's partials, which sum_splits /
//   sum_partials add in split order.
//
// The plans (se3_fused_equiv_fwd_plan, se3_fused_equiv_bwd_plan,
// se3_product_plan) take their splits from product_splits; the Python mirror
// is se3conv3d_tpu_torch/kernels/product.py.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime

#include "fused_equiv_common.cuh"

namespace {

constexpr int kPM = 128;                     // rows of an output tile: two consumer warpgroups of 64
constexpr int kPDepthBytes = 128;            // depth bytes of a stage: 32 float32 or 64 bfloat16 values
constexpr int kPConsumers = 256;             // the two consumer warpgroups
constexpr int kPThreads = kPConsumers + 128;  // and the producer warpgroup (one warp loads)
constexpr int kPMaxStages = 8;
constexpr int kPSlots = 132;                 // the plans' persistent blocks: one an SM of an H100
constexpr int kPMinSplitDepth = 256;         // least depth of a split
constexpr int kPMaxSplits = 64;
constexpr int kPBarConv = 1;                 // the consumers' named barrier (float32 d_w's B tiles)

// Columns of an output tile for J output columns.
inline int product_tile_cols(int J) { return J <= 64 ? 64 : 128; }
// Depth of a stage for operands of elem_bytes.
inline int product_stage_depth(int elem_bytes) { return kPDepthBytes / elem_bytes; }
inline long long product_tiles(long long I, int J) {
  const int bn = product_tile_cols(J);
  return (I + kPM - 1) / kPM * ((J + bn - 1LL) / bn);
}
// Bytes of the image of a J x K operand B: per column tile and stage, BN
// rows of 128 depth bytes (two tiles, hi and lo, for float32).
inline long long product_image_bytes(int J, int K, int elem_bytes) {
  const int bn = product_tile_cols(J), ks = product_stage_depth(elem_bytes);
  return (J + bn - 1LL) / bn * ((K + ks - 1LL) / ks) * bn * kPDepthBytes * (elem_bytes == 4 ? 2 : 1);
}
inline long long round16(long long x) { return (x + 15) / 16 * 16; }

// Depth splits of a product of `tiles` output tiles over `depth`, each
// split writing and reading back a partial whose bytes are about width /
// depth of its operand's (the forward's O output columns per C*Q of basis,
// d_w's O per row): s splits run tiles*s items of a block's depth / s, the
// fullest block ceil(tiles*s / kPSlots) of them; take the s with the least
// of that / s + 2 s width / depth * tiles / kPSlots (the partials' traffic
// over the whole card's), at most `room`.
inline int product_splits(long long tiles, long long depth, long long width, long long room) {
  long long s_max = (depth + kPMinSplitDepth - 1) / kPMinSplitDepth;
  s_max = s_max < room ? s_max : room;
  s_max = s_max < kPMaxSplits ? s_max : kPMaxSplits;
  int s = 1;
  double best = static_cast<double>((tiles + kPSlots - 1) / kPSlots);
  for (long long t = 2; t <= s_max; ++t) {
    const double cost = static_cast<double>((tiles * t + kPSlots - 1) / kPSlots) / t +
                        2.0 * t * width / depth * tiles / kPSlots;
    if (cost < best) best = cost, s = static_cast<int>(t);
  }
  return s;
}

// The depth of each split of `depth` in `splits`, a multiple of the stage.
inline int product_split_depth(long long depth, int splits, int elem_bytes) {
  const int ks = product_stage_depth(elem_bytes);
  const long long per = (depth + splits - 1) / splits;
  return static_cast<int>((per + ks - 1) / ks * ks);
}

// The call sites, as the kernel's first template argument (so that a
// profile tells them apart): A M-contiguous (kAMn) and B from N-contiguous
// rows (kBRows) at d_w only; the output float32, or T at dbasis.
struct SiteFwd {
  static constexpr bool kAMn = false, kBRows = false;
  template <typename T> using Out = float;
};
struct SiteDw {
  static constexpr bool kAMn = true, kBRows = true;
  template <typename T> using Out = float;
};
struct SiteDbasis {
  static constexpr bool kAMn = false, kBRows = false;
  template <typename T> using Out = T;
};

// One block's layout: T the operand type, kAMn: A M-contiguous (d_w), kBRows:
// B from N-contiguous rows (d_w) rather than an image, BN columns.
template <typename T, bool kAMn, bool kBRows, int BN>
struct Prod {
  static constexpr int kSz = static_cast<int>(sizeof(T));
  static constexpr bool kTf32 = kSz == 4;
  static constexpr int kKS = kPDepthBytes / kSz;         // depth of a stage
  static constexpr int kSteps = 4;                       // wgmma depth steps a stage: k8 or k16
  static constexpr int kSliceSteps = kTf32 ? 2 : 1;      // steps of a 16-deep slice
  static constexpr int kSlices = kSteps / kSliceSteps;
  // slice accumulators in flight (the consumers' 232 registers a thread):
  // every slice of a stage at BN = 64 (two float32, beside its A fragments,
  // four bfloat16), at BN = 128 one float32, two bfloat16
  static constexpr int kParts = BN <= 64 ? (kTf32 ? 2 : 4) : (kTf32 ? 1 : 2);
  static constexpr int kImages = kTf32 ? 2 : 1;          // B's tiles: hi and lo, or bfloat16
  static constexpr int kE = kPDepthBytes / kSz;          // values in a 128-byte row
  // A: kPM tile rows of 128 depth bytes, or (kAMn) kPM / kE column blocks of
  // kKS depth rows of 128 bytes; rows swizzled as the tensor maps lay them
  static constexpr int kABytes = kPM * kPDepthBytes;
  static constexpr int kBTile = BN * kPDepthBytes;       // one K-major swizzled tile of B
  static constexpr int kBBytes = kImages * kBTile;
  // bfloat16 d_w: both operands MN-major from the boxes as they land (wgmma's
  // transpose bits), no converted B
  static constexpr bool kSS = !kTf32 && kBRows;
  // gl's depth rows as loaded: [kKS][BN] (float32), or BN / kE boxes of kKS
  // swizzled 128-byte rows (kSS)
  static constexpr int kRawBytes = kBRows ? kKS * BN * kSz : 0;
  static constexpr int kFixed = kBRows && !kSS ? 2 * kBBytes : 0;  // float32 d_w: the two converted B buffers
  static constexpr int kPerStage = (kBRows ? 0 : kBBytes) + kABytes + kRawBytes;
  static constexpr int kRoom = kSmemMax - 1024 - 2 * kPMaxStages * 8;
  static constexpr int kFit = (kRoom - kFixed) / kPerStage;
  static constexpr int kStages = kFit < kPMaxStages ? kFit : kPMaxStages;
  // from a 1024-byte aligned base: A, B (the ring's tiles, or the two buffers), raw rows, barriers
  static constexpr int kOffB = kStages * kABytes;
  static constexpr int kOffRaw = kOffB + (kBRows ? kFixed : kStages * kBBytes);
  static_assert(!kSS || BN % kE == 0, "whole boxes of gl's columns");
  static constexpr int kOffBar = kOffRaw + kStages * kRawBytes;
  static constexpr int kBytes = kOffBar + 2 * kStages * 8 + 1024;  // + the alignment slack
  static_assert(kStages >= 4, "a ring of at least four stages");
  static_assert(kBytes <= kSmemMax, "one block's shared memory");
  static_assert(kBTile % 1024 == 0 && kABytes % 1024 == 0 && kRawBytes % 1024 == 0, "aligned regions");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ring_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void ring_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(b)) : "memory");
}
// bytes that bulk copies will complete on b in its current phase
__device__ __forceinline__ void ring_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(bytes) : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void ring_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nRING_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra RING_WAIT;\n}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// A box of a 2-D tensor map (inner coordinate c0, row c1) to shared
// memory, completing on b; the map lives in the kernel's parameters
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(b))
      : "memory");
}

// Byte offset of (row n, depth byte k) in a K-major tile of 128-byte
// swizzled atoms (8 rows x 128 bytes, the 16-byte chunks of row n XORed
// with n % 8), atoms 1024 bytes apart along the rows.
__host__ __device__ __forceinline__ int swz128(int n, int k) {
  return (n >> 3) * 1024 + (n & 7) * 128 + ((((k >> 4) ^ (n & 7)) << 4) | (k & 15));
}
// wgmma descriptor of a K-major operand in 128-byte swizzled atoms at
// shared address a (8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
// wgmma descriptor of an MN-major operand in 128-byte swizzled atoms (8
// depth rows x 128 bytes of M or N) at shared address a: 8-row depth groups
// 1024 bytes apart (SBO), atoms along M or N `lbo` bytes apart (LBO)
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t a, int lbo) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory"); }
// ties the compiler's view of the registers d to this point (after a
// wgmma wait, so that no read of the accumulator moves above it)
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . b, M = 64, N = 64, K = 8 (tf32): a in registers, b by descriptor;
// scale_d = 0 ignores d's input (the slice's first step)
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a . b, M = 64, N = 128, K = 8 (tf32): a in registers, b by descriptor;
// scale_d = 0 ignores d's input (the slice's first step)
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a . b, M = 64, N = 64 or 128, K = 16 (bf16), both from shared memory by
// descriptor, K-major or (kTransA / kTransB = 1) MN-major; scale_d = 0 ignores d's input
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16_ss_n64(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16_ss_n128(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}


__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kPBarConv), "n"(kPConsumers) : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  if constexpr (BN == 64) wgmma_tf32_n64(d, a, b, scale_d); else wgmma_tf32_n128(d, a, b, scale_d);
}
template <int BN, bool kTransA, bool kTransB>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BN == 64) wgmma_bf16_ss_n64<kTransA, kTransB>(d, a, b, scale_d);
  else wgmma_bf16_ss_n128<kTransA, kTransB>(d, a, b, scale_d);
}

// Byte offset of A(tile row r, stage depth k) in a stage: depth-contiguous A
// as the box {kKS, kPM} of its tensor map lies (row r's 128 bytes
// swizzled), M-contiguous A (kAMn) as kPM / kE boxes {kE, kKS} (column block
// r / kE: depth row k's 128 bytes swizzled).
template <typename P, bool kAMn>
__device__ __forceinline__ int a_off(int r, int k) {
  if constexpr (kAMn)
    return (r / P::kE) * (P::kKS * kPDepthBytes) + swz128(k, (r % P::kE) * P::kSz);
  else
    return swz128(r, k * P::kSz);
}

// Stores this thread's values of one tile row (accumulators 4 n + 2 hh +
// {0, 1}: columns j0 + 8 n + 2 tig + {0, 1}) as 16-byte chunks after the
// quad trades them: float32, threads tig, tig ^ 1 swap one pair of each two
// column blocks (tig even keeps block 2m, odd 2m + 1); bfloat16, the four
// trade pairs so that thread tig holds block 4m + tig.  Every lane takes
// part; a null orow stores nothing.  vec: 16-byte aligned chunks (else, and
// past J, value by value).
template <typename TO, int HH, int N>
__device__ __forceinline__ void store_row(TO* orow, const float (&acc)[N], int j0, int J, int tig, bool vec) {
  constexpr int BN = 2 * N;
  if constexpr (sizeof(TO) == 4) {
    const bool odd = tig & 1;
#pragma unroll
    for (int m = 0; m < BN / 16; ++m) {
      // block 2m: acc[8m + 2HH + {0, 1}]; block 2m + 1: acc[8m + 4 + 2HH + {0, 1}]
      const float a0 = acc[8 * m + 2 * HH], a1 = acc[8 * m + 2 * HH + 1];
      const float b0 = acc[8 * m + 4 + 2 * HH], b1 = acc[8 * m + 5 + 2 * HH];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
      const float c0 = odd ? r0 : a0, c1 = odd ? r1 : a1, c2 = odd ? b0 : r0, c3 = odd ? b1 : r1;
      const int j = j0 + 16 * m + (odd ? 8 + 2 * (tig - 1) : 2 * tig);
      if (orow != nullptr) {
        if (vec && j + 3 < J) {
          *reinterpret_cast<float4*>(orow + j) = make_float4(c0, c1, c2, c3);
        } else {
          if (j < J) orow[j] = c0;
          if (j + 1 < J) orow[j + 1] = c1;
          if (j + 2 < J) orow[j + 2] = c2;
          if (j + 3 < J) orow[j + 3] = c3;
        }
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < BN / 32; ++m) {
      // this thread's pairs of blocks 4m + t, as bfloat16 pairs
      const uint32_t w0 = pack_bf16(__float2bfloat16_rn(acc[16 * m + 2 * HH]), __float2bfloat16_rn(acc[16 * m + 2 * HH + 1]));
      const uint32_t w1 = pack_bf16(__float2bfloat16_rn(acc[16 * m + 4 + 2 * HH]), __float2bfloat16_rn(acc[16 * m + 5 + 2 * HH]));
      const uint32_t w2 = pack_bf16(__float2bfloat16_rn(acc[16 * m + 8 + 2 * HH]), __float2bfloat16_rn(acc[16 * m + 9 + 2 * HH]));
      const uint32_t w3 = pack_bf16(__float2bfloat16_rn(acc[16 * m + 12 + 2 * HH]), __float2bfloat16_rn(acc[16 * m + 13 + 2 * HH]));
      // block 4m + tig: word q from thread q, traded over tig ^ 1, ^ 2, ^ 3
      auto pick = [&](int q) { return q == 0 ? w0 : q == 1 ? w1 : q == 2 ? w2 : w3; };
      uint32_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int q = tig ^ x;
        const uint32_t got = x == 0 ? pick(q) : __shfl_xor_sync(0xffffffffu, pick(q), x);
        c0 = q == 0 ? got : c0;
        c1 = q == 1 ? got : c1;
        c2 = q == 2 ? got : c2;
        c3 = q == 3 ? got : c3;
      }
      const int j = j0 + 8 * (4 * m + tig);
      if (orow != nullptr) {
        if (vec && j + 7 < J) {
          *reinterpret_cast<uint4*>(orow + j) = make_uint4(c0, c1, c2, c3);
        } else {
          const uint32_t c[4] = {c0, c1, c2, c3};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (j + e < J) orow[j + e] = __ushort_as_bfloat16(static_cast<unsigned short>(c[e >> 1] >> (16 * (e & 1))));
        }
      }
    }
  }
}

// C[z] = A . B over split z, as the header says.  A(i, k) = A[i*lda + k],
// or A[k*lda + i] at d_w (Site::kAMn); B from `img` (product_image's, for
// this BN), or at d_w B(k, j) = Brows[k*ldb + j].  Cout[z] at Cout + z*sCs,
// row i at mapped_row(rowmap, G, map_rows, i) with stride ldc, rounded to
// TO.  a_tma / b_tma: A / Brows come through the tensor maps a_map / b_map
// (2-D, rows ld apart, operand_map); else their values are copied one by
// one (a base or stride off 16 bytes).
template <typename Site, typename T, int BN>
__global__ void __launch_bounds__(kPThreads, 1)
wg_product(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
           const T* __restrict__ A, long long lda, const uint8_t* __restrict__ img,
           const T* __restrict__ Brows, long long ldb, typename Site::template Out<T>* __restrict__ Cout,
           long long sCs, long long ldc, int I, int J, int K, int kPer, int splits, int a_tma, int b_tma,
           const int* __restrict__ rowmap, int G, int map_rows) {
  using TO = typename Site::template Out<T>;
  constexpr bool kAMn = Site::kAMn, kBRows = Site::kBRows;
  using P = Prod<T, kAMn, kBRows, BN>;
  constexpr int kKS = P::kKS, kSz = P::kSz, kS = P::kStages, kN = BN / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kOffBar);
  uint64_t* empty = full + kS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      ring_init(full + s, 32);  // the producer warp's lanes
      ring_init(empty + s, 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int tiles_j = (J + BN - 1) / BN;
  const long long tiles = static_cast<long long>((I + kPM - 1) / kPM) * tiles_j;
  const long long items = tiles * splits;
  const int img_stages = (K + kKS - 1) / kKS;  // image stages of a column tile

  if (warp >= kPConsumers / 32) {
    // ---- the producer warpgroup hands its registers to the consumers (12
    // warps start at 168 a thread; 4 x 40 + 8 x 232 fit the same 65,536:
    // the setmaxnreg pair needs whole warpgroups) and loads with its first
    // warp: every stage of the block's items, in order; lane 0 issues the
    // tensor-map boxes and the image copy, every lane copies values where
    // an operand has no map
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp != kPConsumers / 32) return;
    if (lane == 0) {
      if (a_tma) asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&a_map)) : "memory");
      if (b_tma) asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&b_map)) : "memory");
    }
    long long f = 0;  // stage fills so far
    for (long long t = blockIdx.x; t < items; t += gridDim.x) {
      const int z = static_cast<int>(t / tiles);
      const long long tr = t - z * tiles;
      const int ti = static_cast<int>(tr / tiles_j), tj = static_cast<int>(tr - static_cast<long long>(ti) * tiles_j);
      const long long kb = static_cast<long long>(z) * kPer;
      const int ke = static_cast<int>(min(static_cast<long long>(K), kb + kPer));
      const int i0 = ti * kPM, j0 = tj * BN;
      const int iv = min(kPM, I - i0), jv = min(BN, J - j0);
      for (int k0 = static_cast<int>(kb); k0 < ke; k0 += kKS, ++f) {
        const int s = static_cast<int>(f % kS);
        if (f >= kS) ring_wait(empty + s, static_cast<int>((f / kS - 1) & 1));
        const int kv = min(kKS, ke - k0);
        uint8_t* as = smem + s * P::kABytes;
        uint8_t* raw = smem + P::kOffRaw + s * P::kRawBytes;  // [kKS][BN] (d_w)
        if (lane == 0) {
          // whole boxes (their parts past the operand are zero-filled), and the image's stage
          const int bytes = (a_tma ? P::kABytes : 0) + (kBRows ? (b_tma ? P::kRawBytes : 0) : P::kBBytes);
          if (bytes > 0) ring_expect(full + s, bytes);
          if (a_tma) {
            if constexpr (kAMn) {
              for (int b = 0; b < kPM / P::kE; ++b)
                tma_load(as + b * kKS * kPDepthBytes, &a_map, i0 + b * P::kE, k0, full + s);
            } else {
              tma_load(as, &a_map, k0, i0, full + s);
            }
          }
          if constexpr (P::kSS) {
            if (b_tma)
              for (int b = 0; b < BN / P::kE; ++b)
                tma_load(raw + b * kKS * kPDepthBytes, &b_map, j0 + b * P::kE, k0, full + s);
          } else if constexpr (kBRows) {
            if (b_tma) tma_load(raw, &b_map, j0, k0, full + s);
          } else {
            const long long blk = static_cast<long long>(tj) * img_stages + k0 / kKS;
            bulk_copy(smem + P::kOffB + s * P::kBBytes, img + blk * P::kBBytes, P::kBBytes, full + s);
          }
        }
        // without a map, the stage's values one by one where the boxes would
        // put them, zeros past the operand (as the boxes' fill)
        if (!a_tma) {
          for (int e = lane; e < kPM * kKS; e += 32) {
            const int i = e / kKS, k = e - i * kKS;
            *reinterpret_cast<T*>(as + a_off<P, kAMn>(i, k)) =
                i < iv && k < kv ? (kAMn ? A[(k0 + k) * lda + i0 + i] : A[(i0 + i) * lda + k0 + k]) : from_f<T>(0.f);
          }
        }
        if constexpr (kBRows) {
          if (!b_tma) {
            for (int e = lane; e < kKS * BN; e += 32) {
              const int k = e / BN, j = e - k * BN;
              const int off = P::kSS ? (j / P::kE) * (kKS * kPDepthBytes) + swz128(k, (j % P::kE) * kSz) : e * kSz;
              *reinterpret_cast<T*>(raw + off) = k < kv && j < jv ? Brows[(k0 + k) * ldb + j0 + j] : from_f<T>(0.f);
            }
          }
        }
        ring_arrive(full + s);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup h owns tile rows 64 h .. 64 h + 63; warp w
  // of it rows 16 w + gid and + 8 of those
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int h = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const int r0 = 64 * h + 16 * (warp & 3) + gid;
  float acc[kN], part[P::kParts][kN];
#pragma unroll
  for (int v = 0; v < kN; ++v) {
    acc[v] = 0.f;
#pragma unroll
    for (int p = 0; p < P::kParts; ++p) part[p][v] = 0.f;
  }
  long long f = 0;
  for (long long t = blockIdx.x; t < items; t += gridDim.x) {
    const int z = static_cast<int>(t / tiles);
    const long long tr = t - z * tiles;
    const int ti = static_cast<int>(tr / tiles_j), tj = static_cast<int>(tr - static_cast<long long>(ti) * tiles_j);
    const long long kb = static_cast<long long>(z) * kPer;
    const int ke = static_cast<int>(min(static_cast<long long>(K), kb + kPer));
    const int i0 = ti * kPM, j0 = tj * BN;
    for (int k0 = static_cast<int>(kb); k0 < ke; k0 += kKS, ++f) {
      const int s = static_cast<int>(f % kS);
      ring_wait(full + s, static_cast<int>((f / kS) & 1));
      const int kv = min(kKS, ke - k0);
      const uint8_t* as = smem + s * P::kABytes;
      // the stage's slices, each summed into a zeroed part (slice sl into
      // part sl % kParts), the parts added to acc in slice order: with two
      // parts one slice's products run while the last one is added
      auto add_part = [&](float (&p)[kN]) {
        reg_fence(p);
#pragma unroll
        for (int v = 0; v < kN; ++v) acc[v] += p[v];
      };
      // after slice sl's commit: once kParts slices are in flight, wait for
      // the oldest (sl - kParts + 1) and add it
      auto retire_slice = [&](int sl) {
        if (sl >= P::kParts - 1) {
          if constexpr (P::kParts == 4) wg_wait<3>();
          if constexpr (P::kParts == 2) wg_wait<1>();
          if constexpr (P::kParts == 1) wg_wait<0>();
          add_part(part[(sl - P::kParts + 1) % P::kParts]);
        }
      };
      if constexpr (!P::kTf32) {
        // bfloat16: both operands by descriptor.  Warpgroup h's A: tile rows
        // 64h.. (K-major rows of 128 bytes, a k16 step 32 bytes on) or box h
        // (d_w, MN-major: depth rows of 128 bytes, a step 16 rows on); B: the
        // image's K-major tile, or gl's MN-major boxes (d_w)
        const uint32_t a0 = smem_addr(as + h * 64 * kPDepthBytes);
        const uint32_t b0 = smem_addr(kBRows ? smem + P::kOffRaw + s * P::kRawBytes : smem + P::kOffB + s * P::kBBytes);
#pragma unroll
        for (int sl = 0; sl < P::kSlices; ++sl) {
          wg_fence();
          wgmma_bf16<BN, kAMn, kBRows>(
              part[sl % P::kParts],
              kAMn ? mnmajor_desc(a0 + 16 * kPDepthBytes * sl, kKS * kPDepthBytes) : kmajor_desc(a0 + 32 * sl),
              kBRows ? mnmajor_desc(b0 + 16 * kPDepthBytes * sl, kKS * kPDepthBytes) : kmajor_desc(b0 + 32 * sl), 0);
          wg_commit();
          retire_slice(sl);
        }
      } else {
        uint8_t* bt;
        if constexpr (kBRows) {
          // gl's [kKS][BN] rows into the K-major tiles of buffer f % 2, split
          // hi / lo, zero past kv rows or jv columns; the other buffer may
          // still be read by the last stage's wgmma
          bt = smem + P::kOffB + (f & 1) * P::kBBytes;
          const T* raw = reinterpret_cast<const T*>(smem + P::kOffRaw + s * P::kRawBytes);
          const int jv = min(BN, J - j0);
          for (int e = tid; e < kKS * BN; e += kPConsumers) {
            const int k = e / BN, n = e % BN;
            const int off = swz128(n, k * kSz);
            const float x = k < kv && n < jv ? raw[e] : 0.f;
            const uint32_t hi = to_tf32(x);
            *reinterpret_cast<uint32_t*>(bt + off) = hi;
            *reinterpret_cast<uint32_t*>(bt + P::kBTile + off) = to_tf32(x - __uint_as_float(hi));
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          consumers_sync();
        } else {
          bt = smem + P::kOffB + s * P::kBBytes;
        }
        const uint32_t b0 = smem_addr(bt);
        // float32: A from registers, split hi / lo, loaded slice by slice
        // (part p's slice keeps its own fragments until its wgmma is done)
        uint32_t ah[P::kParts][2][4], al[P::kParts][2][4];
#pragma unroll
        for (int sl = 0; sl < P::kSlices; ++sl) {
          const int p = sl % P::kParts;
#pragma unroll
          for (int ss = 0; ss < 2; ++ss) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              // read unconditionally and masked by arithmetic: a load under
              // a branch here made ptxas serialize every wgmma of the kernel
              const int r = r0 + 8 * (v & 1), k = 16 * sl + 8 * ss + tig + 4 * (v >> 1);
              const float x = __uint_as_float(*reinterpret_cast<const uint32_t*>(as + a_off<P, kAMn>(r, k)) &
                                              (0u - static_cast<uint32_t>(k < kv)));
              ah[p][ss][v] = to_tf32(x);
              al[p][ss][v] = to_tf32(x - __uint_as_float(ah[p][ss][v]));
            }
          }
          wg_fence();
#pragma unroll
          for (int ss = 0; ss < 2; ++ss) {
            const uint32_t koff = 32 * (2 * sl + ss);  // a k8 step is 32 depth bytes
            wgmma_tf32<BN>(part[p], al[p][ss], kmajor_desc(b0 + koff), ss);              // lo . hi
            wgmma_tf32<BN>(part[p], ah[p][ss], kmajor_desc(b0 + P::kBTile + koff), 1);  // hi . lo
            wgmma_tf32<BN>(part[p], ah[p][ss], kmajor_desc(b0 + koff), 1);              // hi . hi
          }
          wg_commit();
          retire_slice(sl);
        }
      }
      // the stage's last kParts - 1 slices, oldest first
#pragma unroll
      for (int d = P::kParts - 2; d >= 0; --d) {
        if (d == 2) wg_wait<2>();
        if (d == 1) wg_wait<1>();
        if (d == 0) wg_wait<0>();
        add_part(part[(P::kSlices - 1 - d) % P::kParts]);
      }
      __syncwarp();
      if (lane == 0) ring_arrive(empty + s);
    }

    // accumulator 4 n + 2 hh + e: tile row r0 + 8 hh, column 8 n + 2 tig + e.
    // The quad (tig 0-3) of a row trades pairs so that each thread stores
    // whole 16-byte chunks (store_chunk)
    TO* out = Cout + z * sCs;
    const bool vec = ldc * sizeof(TO) % 16 == 0 && sCs * sizeof(TO) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Cout) % 16 == 0;
    const long long m0 = i0 + r0 < I ? mapped_row(rowmap, G, map_rows, i0 + r0) : -1;
    const long long m1 = i0 + r0 + 8 < I ? mapped_row(rowmap, G, map_rows, i0 + r0 + 8) : -1;
    store_row<TO, 0>(m0 >= 0 ? out + m0 * ldc : nullptr, acc, j0, J, tig, vec);
    store_row<TO, 1>(m1 >= 0 ? out + m1 * ldc : nullptr, acc, j0, J, tig, vec);
#pragma unroll
    for (int v = 0; v < kN; ++v) acc[v] = 0.f;
  }
}

// The image of B (J x K, B(k, j) = W[j*ldw + k] with w_kc, else W[k*ldw +
// j]) for wg_product<Site, T, BN>: per column tile tj and stage ks, at (tj *
// stages + ks) * kBBytes, kImages K-major swizzled tiles of BN rows, tile
// row n holding B(ks*kKS + k, tj*BN + n) at swz128(n, k * sizeof(T)): split
// hi / lo (float32) or rounded to bfloat16; zero outside J x K.  One block
// a (tile, stage): W's values read along its rows into shared memory
// ([BN][kKS + 1]), the tile written along its rows.
template <typename T, int BN>
__global__ void __launch_bounds__(256) product_image(const float* __restrict__ W, long long ldw, int w_kc, int J,
                                                     int K, uint8_t* __restrict__ img) {
  using P = Prod<T, false, false, BN>;
  constexpr int kKS = P::kKS;
  __shared__ float tile[BN][kKS + 1];
  const int stages = (K + kKS - 1) / kKS;
  const long long blk = blockIdx.x;
  const int tj = static_cast<int>(blk / stages), ks = static_cast<int>(blk - static_cast<long long>(tj) * stages);
  for (int e = threadIdx.x; e < BN * kKS; e += 256) {
    const int k = w_kc ? e % kKS : e / BN, c = w_kc ? e / kKS : e % BN;  // W's contiguous index fastest
    const int j = tj * BN + c, kk = ks * kKS + k;
    tile[c][k] = j < J && kk < K ? W[w_kc ? j * ldw + kk : kk * ldw + j] : 0.f;
  }
  __syncthreads();
  uint8_t* out = img + blk * P::kBBytes;
  for (int e = threadIdx.x; e < BN * kKS; e += 256) {
    const int c = e / kKS, k = e % kKS;
    const float x = tile[c][k];
    const int off = swz128(c, k * P::kSz);
    if constexpr (P::kTf32) {
      const uint32_t hi = to_tf32(x);
      *reinterpret_cast<uint32_t*>(out + off) = hi;
      *reinterpret_cast<uint32_t*>(out + P::kBTile + off) = to_tf32(x - __uint_as_float(hi));
    } else {
      *reinterpret_cast<bf16*>(out + off) = __float2bfloat16_rn(x);
    }
  }
}

template <typename T>
cudaError_t launch_product_image(const float* W, long long ldw, bool w_kc, int J, int K, uint8_t* img,
                                 cudaStream_t stream) {
  const int bn = product_tile_cols(J), ks = product_stage_depth(sizeof(T));
  const long long blocks = (J + bn - 1LL) / bn * ((K + ks - 1LL) / ks);
  if (bn == 64)
    product_image<T, 64><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(W, ldw, w_kc, J, K, img);
  else
    product_image<T, 128><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(W, ldw, w_kc, J, K, img);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// cuTensorMapEncodeTiled, taken from libcuda through the runtime's
// entry-point query (the libraries do not link libcuda); null where the
// installed libcuda has none.
typedef CUresult (*TensorMapEncoder)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                     const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline TensorMapEncoder tensor_map_encoder() {
  static TensorMapEncoder fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<TensorMapEncoder>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// A 2-D tensor map over `rows` rows of `inner` values of elem_bytes, rows
// ld values apart, boxes of {box_inner, box_rows} (parts outside read as
// zeros), 128-byte rows swizzled or not; false where the operand cannot be
// described (a base or stride off 16 bytes, or no encoder).
inline bool operand_map(CUtensorMap* map, const void* base, int elem_bytes, long long inner, long long rows,
                    long long ld, int box_inner, int box_rows, bool swizzle) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr || !aligned16(base) || ld * elem_bytes % 16 != 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * elem_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t one[2] = {1, 1};
  return encode(map, elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches wg_product at call site Site over I x J outputs and `splits`
// splits of kPer (a multiple of the stage depth) on a persistent grid of one
// block an SM, A (and d_w's B rows) through tensor maps where they can be.
template <typename Site, typename T, int BN>
cudaError_t launch_product_bn(const T* A, long long lda, const uint8_t* img, const T* Brows,
                              long long ldb, typename Site::template Out<T>* Cout, long long sCs,
                              long long ldc, int I, int J, int K, int kPer, int splits, const int* rowmap,
                              int G, int map_rows, cudaStream_t stream) {
  using P = Prod<T, Site::kAMn, Site::kBRows, BN>;
  const auto kernel = wg_product<Site, T, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = kPSlots;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  constexpr int sz = sizeof(T);
  CUtensorMap a_map{}, b_map{};
  // A: boxes {kKS, kPM} of the [I, K] rows, or (d_w) {kE, kKS} of the [K, I] rows, swizzled
  const int a_tma = Site::kAMn ? operand_map(&a_map, A, sz, I, K, lda, P::kE, P::kKS, true)
                               : operand_map(&a_map, A, sz, K, I, lda, P::kKS, kPM, true);
  // d_w's B: boxes of the [K, J] rows, {BN, kKS} as they lie (float32), or
  // {kE, kKS} swizzled (bfloat16, read MN-major by wgmma)
  const int b_tma = Site::kBRows && (P::kSS ? operand_map(&b_map, Brows, sz, J, K, ldb, P::kE, P::kKS, true)
                                            : operand_map(&b_map, Brows, sz, J, K, ldb, BN, P::kKS, false));
  const long long items = product_tiles(I, J) * splits;
  const int grid = static_cast<int>(items < sms ? items : sms);
  if (grid < 1) return cudaSuccess;
  kernel<<<grid, kPThreads, P::kBytes, stream>>>(a_map, b_map, A, lda, img, Brows, ldb, Cout, sCs, ldc, I, J, K,
                                                 kPer, splits, a_tma, b_tma, rowmap, G, map_rows);
  return cudaGetLastError();
}

template <typename Site, typename T>
cudaError_t launch_product(const T* A, long long lda, const uint8_t* img, const T* Brows, long long ldb,
                           typename Site::template Out<T>* Cout, long long sCs, long long ldc, int I, int J,
                           int K, int kPer, int splits, const int* rowmap, int G, int map_rows,
                           cudaStream_t stream) {
  if (product_tile_cols(J) == 64)
    return launch_product_bn<Site, T, 64>(A, lda, img, Brows, ldb, Cout, sCs, ldc, I, J, K, kPer, splits,
                                          rowmap, G, map_rows, stream);
  return launch_product_bn<Site, T, 128>(A, lda, img, Brows, ldb, Cout, sCs, ldc, I, J, K, kPer, splits,
                                         rowmap, G, map_rows, stream);
}

// --- the split sums -----------------------------------------------------------
constexpr int kSumThreads = 256;

// out[mapped_row(live, G, BM, i / J) * ldc + i % J] = sum_{s < S} part[s][i],
// in order of s (deterministic): the forward's depth splits, stored at
// their rows (none for a table entry outside [0, BM)).
__global__ void __launch_bounds__(kSumThreads)
sum_splits(const float* __restrict__ part, int S, long long n, int J, const int* __restrict__ live, int G,
           int BM, float* __restrict__ out, long long ldc) {
  const long long i = blockIdx.x * static_cast<long long>(kSumThreads) + threadIdx.x;
  if (i >= n) return;
  const long long row = mapped_row(live, G, BM, static_cast<int>(i / J));
  if (row < 0) return;
  float s = 0.f;
  for (int p = 0; p < S; ++p) s += part[p * n + i];
  out[row * ldc + i % J] = s;
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

inline cudaError_t launch_sum_partials(const float* part, int S, long long n, float* out,
                                       cudaStream_t stream) {
  sum_partials<<<static_cast<unsigned>((n + 31) / 32), dim3(32, 8), 0, stream>>>(part, S, n, out);
  return cudaGetLastError();
}

// --- the three call sites -----------------------------------------------------

// forward: out rows = A [I, K] (row stride lda) . B (img: W's image, J x K)
// over `splits` splits, row i stored at mapped_row(rowmap, G, map_rows, i)
// of out (stride ldc); splits > 1 go through part (splits x I x J float32)
// and sum_splits.
template <typename T>
cudaError_t product_fwd(const T* A, long long lda, const uint8_t* img, float* out, long long ldc,
                        float* part, int I, int J, int K, int splits, const int* rowmap, int G,
                        int map_rows, cudaStream_t stream) {
  const int k_per = product_split_depth(K, splits, sizeof(T));
  if (splits == 1)
    return launch_product<SiteFwd, T>(A, lda, img, nullptr, 0, out, 0, ldc, I, J, K, k_per, 1, rowmap, G,
                                          map_rows, stream);
  const long long n = static_cast<long long>(I) * J;
  cudaError_t err = launch_product<SiteFwd, T>(A, lda, img, nullptr, 0, part, n, J, I, J, K, k_per, splits,
                                               nullptr, 1, 0, stream);
  if (err != cudaSuccess) return err;
  sum_splits<<<static_cast<unsigned>((n + kSumThreads - 1) / kSumThreads), kSumThreads, 0, stream>>>(
      part, splits, n, J, rowmap, G, map_rows, out, ldc);
  return cudaGetLastError();
}

// d_w: out [I, J] = sum over K depth rows of A[k*lda + i] * B[k*ldb + j],
// split along the rows: splits > 1 through part (splits x I x J) and
// sum_partials.
template <typename T>
cudaError_t product_dw(const T* A, long long lda, const T* B, long long ldb, float* out, float* part, int I,
                       int J, int K, int splits, cudaStream_t stream) {
  const int k_per = product_split_depth(K, splits, sizeof(T));
  const long long n = static_cast<long long>(I) * J;
  cudaError_t err = launch_product<SiteDw, T>(A, lda, nullptr, B, ldb, splits == 1 ? out : part, n, J, I, J,
                                              K, k_per, splits, nullptr, 1, 0, stream);
  if (err != cudaSuccess || splits == 1) return err;
  return launch_sum_partials(part, splits, n, out, stream);
}

// dbasis: out [I, J] (stride ldc, in T) = A [I, K] (stride lda) . B (img:
// W^T's image, J x K), no split.
template <typename T>
cudaError_t product_dbasis(const T* A, long long lda, const uint8_t* img, T* out, long long ldc, int I,
                           int J, int K, cudaStream_t stream) {
  return launch_product<SiteDbasis, T>(A, lda, img, nullptr, 0, out, 0, ldc, I, J, K,
                                       product_split_depth(K, 1, sizeof(T)), 1, nullptr, 1, 0, stream);
}

}  // namespace
