// The cell-blocked conv's building blocks, for NVIDIA Hopper (sm_90a),
// float32, ids int32:
//
//   block_gather (p1, p2, p4): out[i] = scale * tab[ids[i]] (p1, R = 1:
//                            blocks of P x C) or ((0 + tab[ids[i, 0]]) +
//                            tab[ids[i, 1]]) + ... over r < R, in r order
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
// 1.3 MB, p4 2.4 MB: launch latency at these sizes).  One kernel,
// block_gather, takes all three (instantiated scaled for p1, summing for
// p2 and p4).  Scalar prefetch becomes "the block loads its own ids": block
// (i, y) of the grid (cellconv_probes.gather_plan: output block i, slice y
// of its float4s, 128 threads a float4 each; 128 blocks at p1 / p2, 512 at
// p4) knows its output block, so its threads read block i's ids straight
// into registers (one broadcast load a warp; staging them in shared memory
// behind a block barrier put a step more between p1's id load and its table
// load), and each thread issues its table loads, 4 at a time, before its
// first add; the index math is a 64-bit multiply-add, with no division.  An
// id outside [0, NB) is never clamped or read through: the block writes NaN
// over its slice, and the wrapper's caller checks the ids
// (cellconv_probes.bad_ids).  p1 writes scale * x, with no zero added first
// (-0.0 stays -0.0); the sums keep the JAX grid's order (from zero, r = 0,
// 1, ...), so kernel, plain version and JAX kernel agree bit for bit.
//
// p3 is 2 * 2048 * 512 * 128 = 268 MFLOP of products over 1.4 MB: 1.6 us at
// the 3xTF32 ceiling (a third of the TF32 tensor-core peak), 4.0 us at the
// float32 FMA peak, 0.4 us of bytes; launch latency alone is about 2 us.
// Its design, a block a tile of 64 queries x 32 channels (128 blocks for
// 132 SMs at 2,048 x 128), 8 warps:
//
// - products on tensor cores, mma.sync m16n8k8 TF32 in the 3xTF32 form
//   (x = hi + lo, each TF32; lo.hi, hi.lo and hi.hi each into a register
//   tile of its own over the warp's whole depth, added as (lo.hi + hi.lo) +
//   hi.hi at the end), as strided_product and tf32x3_gemm do;
// - pne built where the A fragment needs it: each thread computes, on the
//   CUDA cores, exactly the pne values of its fragment elements (query rows
//   lane / 4 (+ 8) of each 16-row tile, candidates lane % 4 (+ 4) of each
//   8-deep step), from its queries' xyz held in registers and the
//   candidates' xyz staged in shared memory; no pne tile goes through
//   shared memory, and pne_out (where asked, by the blocks of the first
//   channel tile) is written straight from the fragments;
// - d2 and 3 d2 + 1 rounded step by step (__fmul_rn / __fadd_rn, which nvcc
//   never contracts into an FMA), as the JAX kernel computes them: a pair
//   near d2 = 0.04 must fall on the same side of the mask in both, or an
//   error of order |cf| appears;
// - the candidates in slices of 32: the block's 8 warps are 4 depth groups
//   of 2 (rows 0-31 and 32-63), group g over slices g, g + 4, ..., each
//   with a ring of 4 slots and its own named barrier; a slot holds the
//   slice's cf [32][32 + 8] (the pad puts a B fragment load's 32 words on
//   32 banks) and its candidates' xyz, copied by cp.async (16 bytes a copy
//   for cf), so the next slices load while this one is multiplied; at 512
//   candidates (4 slices a group) no slot is refilled;
// - each block reads its 32 columns of cf once (64 KB; 8 MB of L2 reads in
//   all);
// - the four groups' partial tiles meet in shared memory and are added in
//   group order, ((g0 + g1) + g2) + g3: no atomics, two calls give the same
//   bits.  The candidates' order differs from the plain product's.
//
// What limits it on the card is the three products' mma.sync and the pne
// math on the CUDA cores, whose times add up rather than overlap
// (probe_variants.py p3 times the kernel without each).

#include <math.h>
#include <stdint.h>

#include "fused_equiv_common.cuh"
#include "probe_common.cuh"

namespace {

// masked_dist_product: a block's queries and channels, candidates a staged
// slice, depth groups, ring slots a group, m16 tiles a warp (its rows),
// the warps of a group over the block's rows
constexpr int kMT = 2;                             // m16 tiles a warp: its rows
constexpr int kNT = 4;                             // n8 tiles a warp: every channel of the block
constexpr int kWarpsM = 2;                         // warps of a group, over the block's rows
constexpr int kPQ = 16 * kMT * kWarpsM;
constexpr int kPC = 8 * kNT;
constexpr int kPK = 32;
constexpr int kPGroups = 4;
constexpr int kPStages = 4;
constexpr int kPGroupThreads = 32 * kWarpsM;
constexpr int kPThreads = kPGroups * kPGroupThreads;
constexpr int kFS = kPC + 8;                       // a staged cf row, padded
constexpr int kSlot = kPK * kFS + kPK * 4;         // floats a slot: cf slice, then xyz as float4
constexpr int kP3Smem = kPGroups * kPStages * kSlot * 4;
static_assert(kPGroups * kPQ * kFS <= kPGroups * kPStages * kSlot, "the partial tiles reuse the rings");
constexpr float kRadius2 = 0.04f;

// block_gather: most threads a block; ids a thread reads, and table loads
// it issues, before its first add
constexpr int kGatherMaxThreads = 256;
constexpr int kGatherAhead = 4;

// out [NQ, blk4] float4, block i = scale * tab[ids[i]] (kScaled, R = 1) or
// the sum over r < R, in order from zero, of tab's row ids[i * R + r];
// tab [NB, blk4] float4.  Block (i, y) writes float4s j = y T + t, (y +
// gridDim.y) T + t, ... of block i (T = blockDim.x).  Every thread reads
// block i's ids itself (the same address across a warp: one load a warp),
// 4 at a time, each checked before the table loads they name; an id
// outside [0, NB) stops the reads and makes the float4 NaN.
template <bool kScaled>
__global__ void __launch_bounds__(kGatherMaxThreads)
block_gather(const int* __restrict__ ids, int R, const float4* __restrict__ tab, int NB, long long blk4,
             float scale, float4* __restrict__ out) {
  const int* bid = ids + static_cast<long long>(blockIdx.x) * R;
  float4* o = out + static_cast<long long>(blockIdx.x) * blk4;
  const long long step = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x; j < blk4; j += step) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    bool bad = false;
    for (int r0 = 0; r0 < R; r0 += kGatherAhead) {
      int id[kGatherAhead];
#pragma unroll
      for (int k = 0; k < kGatherAhead; ++k)
        if (r0 + k < R) {
          id[k] = __ldg(bid + r0 + k);
          bad |= id[k] < 0 || id[k] >= NB;
        }
      if (bad) break;
      float4 x[kGatherAhead];
#pragma unroll
      for (int k = 0; k < kGatherAhead; ++k)
        if (r0 + k < R) x[k] = __ldg(tab + id[k] * blk4 + j);
      if (kScaled) {
        s = make_float4(scale * x[0].x, scale * x[0].y, scale * x[0].z, scale * x[0].w);
      } else {
#pragma unroll
        for (int k = 0; k < kGatherAhead; ++k)
          if (r0 + k < R) {
            s.x += x[k].x;
            s.y += x[k].y;
            s.z += x[k].z;
            s.w += x[k].w;
          }
      }
    }
    o[j] = bad ? make_float4(NAN, NAN, NAN, NAN) : s;
  }
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// (d2 < 0.04) * (3 d2 + 1), d2 = (dx*dx + dy*dy) + dz*dz, each step rounded
__device__ __forceinline__ float masked_pne(float qx, float qy, float qz, float4 c) {
  const float dx = __fsub_rn(qx, c.x), dy = __fsub_rn(qy, c.y), dz = __fsub_rn(qz, c.z);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return d2 < kRadius2 ? __fadd_rn(__fmul_rn(d2, 3.f), 1.f) : 0.f;
}

// grid (NQ / kPQ, C / kPC), kPThreads threads, kP3Smem bytes of dynamic
// shared memory: out[q, c] = sum over k < NC of pne[q, k] * cf[k, c] for the
// block's 64 queries and 32 channels.  Warp w: rows 32 (w & 1) .. + 31 (two
// m16 tiles), all 32 channels (four n8 tiles), depth group w >> 1 (slices
// g, g + 4, ...); pne_out, where not null, from the blocks with
// blockIdx.y == 0.
__global__ void __launch_bounds__(kPThreads, 1)
masked_dist_product(const float* __restrict__ qp, int ldq, const float* __restrict__ cp, int ldc, int NC,
                    const float* __restrict__ cf, int C, float* __restrict__ out, float* __restrict__ pne_out) {
  extern __shared__ __align__(16) float p3_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int g = warp / kWarpsM, wm = 16 * kMT * (warp % kWarpsM), gt = threadIdx.x - g * kPGroupThreads;
  const int q0 = blockIdx.x * kPQ, c0 = blockIdx.y * kPC;
  float* const pne_rows = blockIdx.y == 0 ? pne_out : nullptr;
  float* const ring = p3_smem + g * kPStages * kSlot;

  // the xyz of this thread's query rows wm + 16 mt + gid + 8 h
  float qx[kMT][2], qy[kMT][2], qz[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* q = qp + static_cast<long long>(q0 + wm + 16 * mt + gid + 8 * h) * ldq;
      qx[mt][h] = __ldg(q);
      qy[mt][h] = __ldg(q + 1);
      qz[mt][h] = __ldg(q + 2);
    }

  // slice sl (candidates 32 sl .. + 31) into ring slot st: cf's 32 x 32
  // block by 16-byte copies, the xyz by 4-byte ones
  auto load = [&](int sl, int st) {
    float* fs = ring + st * kSlot;
    float* ps = fs + kPK * kFS;
    const int k0 = sl * kPK;
#pragma unroll
    for (int i = 0; i < kPK * kPC / 4 / kPGroupThreads; ++i) {
      const int u = gt + i * kPGroupThreads, r = u / (kPC / 4), c4 = u % (kPC / 4);
      cp_async16(fs + r * kFS + 4 * c4, cf + static_cast<long long>(k0 + r) * C + c0 + 4 * c4, 16);
    }
#pragma unroll
    for (int i = 0; i < (kPK * 3 + kPGroupThreads - 1) / kPGroupThreads; ++i) {
      const int u = gt + i * kPGroupThreads;
      if (u < kPK * 3)
        cp_async4(ps + (u / 3) * 4 + u % 3, cp + static_cast<long long>(k0 + u / 3) * ldc + u % 3, 4);
    }
  };

  float hh[kMT][kNT][4], lh[kMT][kNT][4], hl[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) hh[mt][nt][v] = lh[mt][nt][v] = hl[mt][nt][v] = 0.f;

  const int nslices = NC / kPK, ns = (nslices - g + kPGroups - 1) / kPGroups;
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < ns) load(g + kPGroups * s, s);
    cp_commit();
  }
  for (int t = 0; t < ns; ++t) {
    cp_wait<kPStages - 2>();
    asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(kPGroupThreads) : "memory");  // slice t landed; slot t - 1 is free
    if (t + kPStages - 1 < ns) load(g + kPGroups * (t + kPStages - 1), (t + kPStages - 1) % kPStages);
    cp_commit();
    const float* fs = ring + (t % kPStages) * kSlot;
    const float4* ps = reinterpret_cast<const float4*>(fs + kPK * kFS);
    const int k0 = (g + kPGroups * t) * kPK;
#pragma unroll
    for (int ks = 0; ks < kPK; ks += 8) {
      const float4 ca = ps[ks + tig], cb = ps[ks + tig + 4];
      uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // the A fragment: (row gid, k tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4)
        const float v[4] = {masked_pne(qx[mt][0], qy[mt][0], qz[mt][0], ca),
                            masked_pne(qx[mt][1], qy[mt][1], qz[mt][1], ca),
                            masked_pne(qx[mt][0], qy[mt][0], qz[mt][0], cb),
                            masked_pne(qx[mt][1], qy[mt][1], qz[mt][1], cb)};
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[mt][i], al[mt][i]);
        if (pne_rows != nullptr) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pne_rows[static_cast<long long>(q0 + wm + 16 * mt + gid + 8 * (i & 1)) * NC + k0 + ks + tig +
                     4 * (i >> 1)] = v[i];
        }
      }
      // the B fragment: (k tig, n gid), (tig + 4, gid) of each n8 tile
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int v = 0; v < 2; ++v) split_tf32(fs[(ks + tig + 4 * v) * kFS + 8 * nt + gid], bh[nt][v], bl[nt][v]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma_tf32(lh[mt][nt], al[mt], bh[nt]);
          mma_tf32(hl[mt][nt], ah[mt], bl[nt]);
          mma_tf32(hh[mt][nt], ah[mt], bh[nt]);
        }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every ring is consumed: the partial tiles take their place

  // group g's partial [kPQ][kFS] tile, then out = ((g0 + g1) + g2) + g3; the
  // D fragment: (row gid, columns 2 tig, 2 tig + 1), (gid + 8, the same)
  float* const red = p3_smem;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = red + (g * kPQ + wm + 16 * mt + gid + 8 * h) * kFS + 8 * nt + 2 * tig;
        p[0] = (lh[mt][nt][2 * h] + hl[mt][nt][2 * h]) + hh[mt][nt][2 * h];
        p[1] = (lh[mt][nt][2 * h + 1] + hl[mt][nt][2 * h + 1]) + hh[mt][nt][2 * h + 1];
      }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPQ * kPC / 4 / kPThreads; ++i) {
    const int u = threadIdx.x + i * kPThreads, r = u / (kPC / 4), c = 4 * (u % (kPC / 4));
    float4 s = *reinterpret_cast<const float4*>(red + r * kFS + c);
#pragma unroll
    for (int gg = 1; gg < kPGroups; ++gg) {
      const float4 x = *reinterpret_cast<const float4*>(red + (gg * kPQ + r) * kFS + c);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    *reinterpret_cast<float4*>(out + static_cast<long long>(q0 + r) * C + c0 + c) = s;
  }
}

}  // namespace

// ids [NQ, R] int32; tab [NB, block] and out [NQ, block] float32, 16-byte
// aligned, block a multiple of 4; scaled (p1): R = 1, out = scale * tab
// block; threads a block (cellconv_probes.gather_plan), a multiple of 32 up
// to 256.
extern "C" int se3_probe_block_gather(const void* ids, int NQ, int R, const void* tab, int NB, long long block,
                                      int scaled, float scale, int threads, void* out, void* stream_ptr) {
  if (NQ < 1 || R < 1 || NB < 1 || block < 4 || block % 4 != 0 || (scaled && R != 1) || threads < 32 ||
      threads > kGatherMaxThreads || threads % 32 != 0 || reinterpret_cast<uintptr_t>(tab) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int block_threads = threads;
  const long long blk4 = block / 4, slices = (blk4 + block_threads - 1) / block_threads;
  const dim3 grid(NQ, slices < 65535 ? static_cast<unsigned>(slices) : 65535u);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (scaled)
    block_gather<true><<<grid, block_threads, 0, stream>>>(static_cast<const int*>(ids), R,
                                                            static_cast<const float4*>(tab), NB, blk4, scale,
                                                            static_cast<float4*>(out));
  else
    block_gather<false><<<grid, block_threads, 0, stream>>>(static_cast<const int*>(ids), R,
                                                             static_cast<const float4*>(tab), NB, blk4, scale,
                                                             static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// qp [NQ, ldq], cp [NC, ldc] (x, y, z in the first three columns), cf [NC,
// C], out [NQ, C], pne [NQ, NC] or null; float32, cf and out 16-byte
// aligned.  NQ a multiple of 64, NC of 32, C of 32; ldq, ldc >= 3.
extern "C" int se3_probe_masked_dist_product(const void* qp, int ldq, int NQ, const void* cp, int ldc, int NC,
                                             const void* cf, int C, void* out, void* pne, void* stream_ptr) {
  if (NQ < kPQ || NQ % kPQ != 0 || NC < kPK || NC % kPK != 0 || C < kPC || C % kPC != 0 || C / kPC > 65535 ||
      ldq < 3 || ldc < 3 || reinterpret_cast<uintptr_t>(cf) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool raised[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(masked_dist_product, kP3Smem, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(NQ / kPQ, C / kPC);
  masked_dist_product<<<grid, kPThreads, kP3Smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(qp), ldq, static_cast<const float*>(cp), ldc, NC, static_cast<const float*>(cf),
      C, static_cast<float*>(out), static_cast<float*>(pne));
  return static_cast<int>(cudaGetLastError());
}

// attrs[0..3] of kernel `which`: 0 block_gather<scaled>, 1 block_gather<sum>,
// 2 masked_dist_product (probe_common.cuh: kernel_attrs).
extern "C" int se3_probe_cellconv_attrs(int which, int* attrs) {
  switch (which) {
    case 0: return kernel_attrs(block_gather<true>, 0, attrs);
    case 1: return kernel_attrs(block_gather<false>, 0, attrs);
    case 2: return kernel_attrs(masked_dist_product, kP3Smem, attrs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
