// The fused PNE-conv forward, stage by stage, for NVIDIA Hopper (sm_90a):
// the stage probe.  Per query row m of E = 32 edges, G = 2 out-frames of
// Q = 32 basis functions (GQ = 64), C = O = 64 channels and D = 18 or 19
// pne inputs:
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
// stage (kStage) stops the computation after pne, the aggregation, the swap
// (the TPU's relayout of basis to [GQ, rows, C]), the weight contraction or
// the sum over q; the output mode (kMode) writes the stage's whole tensor
// (kTensor, with the bias, as bisect_fused does) or one partial sum of it
// per block (kTileSum, without, as chip_stage_time does: its kernel
// broadcast each tile's sum over the tile's output block).  In kTileSum the stage's work stays live
// but its intermediate never reaches HBM, so the stage times differ by the
// stage's own cost.  The last stage writes its output [G, M, O] in both
// modes: it is the forward's result (chip_stage_time's run summed it).  A
// batch index in the grid's y gives s6's leading batch.  With bfloat16
// operands (T, chip_stage_time's CDT=bf16) the values are rounded where the
// JAX script casts: geo and proj before the first product, pne before the
// aggregation, feat, basis before the weight product, and W; every sum is
// float32.  See se3conv3d_tpu_torch/kernels/probes.py for the wrapper and
// the plain PyTorch version.
//
// What bounds it (chip_stage_time's M = 65,536): 5.10 + 17.18 + 34.36 GFLOP
// (pne, aggregation, weight product), 0.85 ms at 67 TFLOP/s of float32 FMA,
// against 159 MB of geo, 537 MB of feat and 34 MB of output, 0.22 ms at
// 3.35 TB/s.  The design: a block of 256 threads owns kRows = 16 query rows
// and stages their geo (38 KB) and feat (128 KB) in shared memory with
// cp.async, then walks the GQ columns in chunks of kQL = 8 (one out-frame g
// for 4 chunks): each thread evaluates the chunk's pne for 2 edges (D FMAs a
// column, in shared memory), then 8 x 4 basis values of one row (a float
// FMA loop over the 32 edges, as the port's basis pass aggregates), which
// the swap stores rounded into shared memory as [ql][rows][C], rows padded
// to 68 floats so that the fragment reads below hit distinct banks; then
// each warp owns 8 output columns of the 16 rows and contracts the chunk's
// 8 x 64-deep basis against W on the tensor cores, with the port's product
// building blocks of fused_equiv_common.cuh: the 3xTF32 split and
// mma.m16n8k8 of tf32x3_gemm for float32, the mma.m16n8k16 of bf16_gemm for
// bfloat16 (each 8- or 16-deep step summed into a zeroed tile and added to
// the running sum by a rounded float32 add, as they do).  Those two are
// whole kernels that read their operands from HBM; here the basis never
// leaves shared memory, so their device-level pieces are used, not the
// kernels.  W (1 MiB) is read once per block of 16 rows, from L2: 4 GiB of
// L2 reads at M = 65,536, the design's known cost.  The per-block partial
// sums are added in a fixed order (sum_partials_fixed): two calls give the
// same bits.

#include <stdint.h>

#include "fused_equiv_common.cuh"
#include "probe_common.cuh"

namespace {

constexpr int kPE = 32, kPGQ = 64, kPQ = 32, kPG = 2, kPC = 64, kPO = 64;
constexpr int kRows = 16;                // query rows per block
constexpr int kEdges = kRows * kPE;      // 512
constexpr int kQL = 8;                   // gq columns per chunk
constexpr int kChunks = kPGQ / kQL;
constexpr int kThreads = 256;
constexpr int kDMax = 19;
constexpr int kBStride = kPC + 4;        // a basis row in shared memory

enum Stage : int { kPne = 0, kAgg = 1, kSwap = 2, kWcontract = 3, kReduce = 4 };
enum Mode : int { kTensor = 0, kTileSum = 1 };

// shared memory, in floats; every region starts on 16 bytes
constexpr int kOffProj = 0;                               // [D][GQ]
constexpr int kOffBias = kOffProj + kDMax * kPGQ;         // [GQ]
constexpr int kOffRed = kOffBias + kPGQ;                  // [32]
constexpr int kOffGeo = kOffRed + 32;                     // [kEdges][D]
constexpr int kOffPne = kOffGeo + kEdges * kDMax;         // [kEdges][kQL]
constexpr int kOffFeat = kOffPne + kEdges * kQL;          // [kRows][E][C]
constexpr int kOffBasis = kOffFeat + kRows * kPE * kPC;   // [kQL][kRows][kBStride]
constexpr int kSmemFloats = kOffBasis + kQL * kRows * kBStride;
static_assert(kOffGeo % 4 == 0 && kOffPne % 4 == 0 && kOffFeat % 4 == 0 && kOffBasis % 4 == 0,
              "16-byte regions");
static_assert(kSmemFloats * 4 <= kSmemMax, "one block's shared memory");

constexpr int stage_smem_bytes(int stage) {
  return 4 * (stage == kPne ? kOffFeat : (stage == kAgg ? kOffBasis : kSmemFloats));
}

__device__ __forceinline__ void cp_wait_all_but_one() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// acc (this warp's m16n8 tile: rows 0..15, columns n0 .. n0+7) += as [16][64]
// (row stride kBStride) . wq [64][kPO] (float32: 3xTF32; bf16: the operands
// are already rounded values, packed in pairs).
template <typename T>
__device__ __forceinline__ void contract_chunk_row(float* acc, const float* as,
                                                   const float* __restrict__ wq, int n0, int gid,
                                                   int tig) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k0 = 0; k0 < kPC; k0 += 8) {
      uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
      for (int v = 0; v < 4; ++v)
        split_tf32(as[(gid + 8 * (v & 1)) * kBStride + k0 + tig + 4 * (v >> 1)], ah[v], al[v]);
#pragma unroll
      for (int v = 0; v < 2; ++v) split_tf32(__ldg(wq + (k0 + tig + 4 * v) * kPO + n0 + gid), bh[v], bl[v]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(part, al, bh);
      mma_tf32(part, ah, bl);
      mma_tf32(part, ah, bh);
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] += part[v];
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < kPC; k0 += 16) {
      uint32_t a[4], b[2];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float2 x = *reinterpret_cast<const float2*>(
            as + (gid + 8 * (v & 1)) * kBStride + k0 + 2 * tig + 8 * (v >> 1));
        a[v] = pack_bf16(__float2bfloat16_rn(x.x), __float2bfloat16_rn(x.y));
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int k = k0 + 2 * tig + 8 * v;
        b[v] = pack_bf16(__float2bfloat16_rn(__ldg(wq + k * kPO + n0 + gid)),
                         __float2bfloat16_rn(__ldg(wq + (k + 1) * kPO + n0 + gid)));
      }
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(part, a, b);
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] += part[v];
    }
  }
}

// Block (x, y) owns query rows m0 = 16x .. 16x + 15 of batch y.  Tensors,
// batch leading: geo [B, M*E, D], feat [B, M, E, C], proj [D, GQ], bias
// [GQ] (kTensor) or null (kTileSum), W [GQ, C, O]; out by stage: pne [B, M*E, GQ], basis_t [B, M,
// GQ, C], basis_b [B, GQ, M, C], per_gq [B, GQ, M, O], out [B, G, M, O];
// part [B * M / 16] in kTileSum.  kTensor adds the bias, kTileSum has none.
template <int kStage, int kMode, typename T>
__global__ void __launch_bounds__(kThreads, 1)
stage_fwd(const float* __restrict__ geo, const float* __restrict__ feat,
          const float* __restrict__ proj, const float* __restrict__ bias,
          const float* __restrict__ w, float* __restrict__ out, float* __restrict__ part, int M,
          int D) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr bool kBias = kMode == kTensor;
  extern __shared__ __align__(16) float smem[];
  float* projS = smem + kOffProj;
  float* biasS = smem + kOffBias;
  float* redS = smem + kOffRed;
  float* geoS = smem + kOffGeo;
  float* pneS = smem + kOffPne;
  float* featS = smem + kOffFeat;
  float* basisS = smem + kOffBasis;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, m0 = blockIdx.x * kRows;
  const long long row0 = static_cast<long long>(b) * M + m0;  // the block's first row, batch-flat

  // geo (copy group 0), then feat (group 1)
  {
    const float* src = geo + row0 * kPE * D;
    for (int i = tid; i < kEdges * D / 4; i += kThreads) cp_async16(geoS + 4 * i, src + 4 * i, 16);
  }
  cp_commit();
  if constexpr (kStage >= kAgg) {
    const float* src = feat + row0 * kPE * kPC;
    for (int i = tid; i < kRows * kPE * kPC / 4; i += kThreads) cp_async16(featS + 4 * i, src + 4 * i, 16);
  }
  cp_commit();
  for (int i = tid; i < D * kPGQ; i += kThreads) projS[i] = rnd<T>(proj[i]);
  if constexpr (kBias)
    for (int i = tid; i < kPGQ; i += kThreads) biasS[i] = bias[i];
  cp_wait_all_but_one();
  __syncthreads();
  if constexpr (kBf16) {
    for (int i = tid; i < kEdges * D; i += kThreads) geoS[i] = rnd<T>(geoS[i]);
    __syncthreads();
  }

  float tsum = 0.f;                          // this thread's share of the tile sum
  float acc[4] = {0.f, 0.f, 0.f, 0.f};       // the weight product's m16n8 tile
  const int gid = lane >> 2, tig = lane & 3, n0 = warp * 8;
  const int ar = tid >> 4, c4 = (tid & 15) * 4;  // aggregation: row ar, channels c4 .. c4+3

  for (int ch = 0; ch < kChunks; ++ch) {
    const int gq0 = ch * kQL;
    // 1. pne of the chunk's kQL columns for edges tid and tid + 256
#pragma unroll
    for (int h = 0; h < kEdges / kThreads; ++h) {
      const int e = tid + h * kThreads;
      const float* gr = geoS + e * D;
      float pre[kQL];
#pragma unroll
      for (int j = 0; j < kQL; ++j) pre[j] = 0.f;
      for (int k = 0; k < D; ++k) {
        const float x = gr[k];
        const float4 q0 = *reinterpret_cast<const float4*>(projS + k * kPGQ + gq0);
        const float4 q1 = *reinterpret_cast<const float4*>(projS + k * kPGQ + gq0 + 4);
        const float pk[kQL] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
        for (int j = 0; j < kQL; ++j) pre[j] = fmaf(x, pk[j], pre[j]);
      }
      float p[kQL];
#pragma unroll
      for (int j = 0; j < kQL; ++j) p[j] = gelu_tanh(kBias ? pre[j] + biasS[gq0 + j] : pre[j]);
      if constexpr (kStage == kPne) {
        if constexpr (kMode == kTensor) {
          float4* dst = reinterpret_cast<float4*>(out + (row0 * kPE + e) * kPGQ + gq0);
          dst[0] = make_float4(p[0], p[1], p[2], p[3]);
          dst[1] = make_float4(p[4], p[5], p[6], p[7]);
        } else {
#pragma unroll
          for (int j = 0; j < kQL; ++j) tsum += p[j];
        }
      } else {
        float4* dst = reinterpret_cast<float4*>(pneS + e * kQL);
        dst[0] = make_float4(rnd<T>(p[0]), rnd<T>(p[1]), rnd<T>(p[2]), rnd<T>(p[3]));
        dst[1] = make_float4(rnd<T>(p[4]), rnd<T>(p[5]), rnd<T>(p[6]), rnd<T>(p[7]));
      }
    }
    if constexpr (kStage != kPne) {
      if (ch == 0) {
        cp_wait_all();
        __syncthreads();
        if constexpr (kBf16)
          for (int i = tid; i < kRows * kPE * kPC; i += kThreads) featS[i] = rnd<T>(featS[i]);
      }
      __syncthreads();  // the chunk's pne rows (and, first, feat) are in
      // 2. basis[ql][ar][c4 + i] = sum_e pne[ar, e, ql] * feat[ar, e, c4 + i]
      float a[kQL][4];
#pragma unroll
      for (int j = 0; j < kQL; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[j][i] = 0.f;
      const float* pr = pneS + ar * kPE * kQL;
      const float* fr = featS + ar * kPE * kPC + c4;
#pragma unroll 4
      for (int e = 0; e < kPE; ++e) {
        const float4 f = *reinterpret_cast<const float4*>(fr + e * kPC);
        const float4 p0 = *reinterpret_cast<const float4*>(pr + e * kQL);
        const float4 p1 = *reinterpret_cast<const float4*>(pr + e * kQL + 4);
        const float pv[kQL] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int j = 0; j < kQL; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[j][i] = fmaf(pv[j], fv[i], a[j][i]);
      }
      if constexpr (kStage == kAgg) {
        if constexpr (kMode == kTensor) {
#pragma unroll
          for (int j = 0; j < kQL; ++j)
            *reinterpret_cast<float4*>(out + ((row0 + ar) * kPGQ + gq0 + j) * kPC + c4) =
                make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
        } else {
#pragma unroll
          for (int j = 0; j < kQL; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) tsum += a[j][i];
        }
      } else {
        // 3. the swap: the chunk's basis, rounded, into shared memory as [ql][rows][C]
#pragma unroll
        for (int j = 0; j < kQL; ++j)
          *reinterpret_cast<float4*>(basisS + (j * kRows + ar) * kBStride + c4) =
              make_float4(rnd<T>(a[j][0]), rnd<T>(a[j][1]), rnd<T>(a[j][2]), rnd<T>(a[j][3]));
        __syncthreads();
        if constexpr (kStage == kSwap) {
          // read back in another mapping: float4 f of the chunk's [kQL][kRows][C]
#pragma unroll
          for (int i = 0; i < kQL * kRows * kPC / 4 / kThreads; ++i) {
            const int f = tid + i * kThreads;
            const int ql = f / (kRows * kPC / 4), r = (f / (kPC / 4)) % kRows, c = (f % (kPC / 4)) * 4;
            const float4 v = *reinterpret_cast<const float4*>(basisS + (ql * kRows + r) * kBStride + c);
            if constexpr (kMode == kTensor) {
              *reinterpret_cast<float4*>(
                  out + ((static_cast<long long>(b) * kPGQ + gq0 + ql) * M + m0 + r) * kPC + c) = v;
            } else {
              tsum += v.x + v.y + v.z + v.w;
            }
          }
        } else {
          // 4. the weight contraction: warp w, columns n0 .. n0 + 7 of the 16 rows
#pragma unroll 1
          for (int ql = 0; ql < kQL; ++ql) {
            const int gq = gq0 + ql;
            contract_chunk_row<T>(acc, basisS + ql * kRows * kBStride,
                                  w + static_cast<long long>(gq) * kPC * kPO, n0, gid, tig);
            if constexpr (kStage == kWcontract) {  // per_gq [B, GQ, M, O]
              float* orow = out + ((static_cast<long long>(b) * kPGQ + gq) * M + m0) * kPO + n0 + 2 * tig;
              *reinterpret_cast<float2*>(orow + gid * kPO) = make_float2(acc[0], acc[1]);
              *reinterpret_cast<float2*>(orow + (gid + 8) * kPO) = make_float2(acc[2], acc[3]);
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[v] = 0.f;
            }
          }
          if constexpr (kStage == kReduce) {
            if ((gq0 + kQL) % kPQ == 0) {  // 5. out-frame g is summed over its q
              const int g = gq0 / kPQ;
              float* orow = out + ((static_cast<long long>(b) * kPG + g) * M + m0) * kPO + n0 + 2 * tig;
              *reinterpret_cast<float2*>(orow + gid * kPO) = make_float2(acc[0], acc[1]);
              *reinterpret_cast<float2*>(orow + (gid + 8) * kPO) = make_float2(acc[2], acc[3]);
              if constexpr (kMode == kTileSum) tsum += (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[v] = 0.f;
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites pneS and basisS
  }
  if constexpr (kMode == kTileSum) {
    const float s = block_sum(tsum, redS);
    if (tid == 0) part[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = s;
  }
}

// The instantiations the probes run: every stage in kTensor (float32, with
// the bias: bisect_fused) and pne, agg, swap and reduce in kTileSum (float32
// or bfloat16, no bias: chip_stage_time).  Returns null for any other
// combination.
typedef void (*StageKernel)(const float*, const float*, const float*, const float*, const float*,
                            float*, float*, int, int);

template <int S>
StageKernel pick_mode(int mode, bool use_bf16) {
  if (mode == kTensor) return use_bf16 ? nullptr : stage_fwd<S, kTensor, float>;
  if constexpr (S == kWcontract) {
    return nullptr;
  } else {
    if (mode != kTileSum) return nullptr;
    return use_bf16 ? stage_fwd<S, kTileSum, bf16> : stage_fwd<S, kTileSum, float>;
  }
}

StageKernel stage_kernel(int stage, int mode, bool use_bf16) {
  switch (stage) {
    case kPne: return pick_mode<kPne>(mode, use_bf16);
    case kAgg: return pick_mode<kAgg>(mode, use_bf16);
    case kSwap: return pick_mode<kSwap>(mode, use_bf16);
    case kWcontract: return pick_mode<kWcontract>(mode, use_bf16);
    case kReduce: return pick_mode<kReduce>(mode, use_bf16);
    default: return nullptr;
  }
}

}  // namespace

// Query rows per block: M must be a multiple; kTileSum writes B * M / rows partials.
extern "C" int se3_probe_stage_rows() { return kRows; }

// The instantiation's registers, local (stack and spill) bytes, static and
// dynamic shared memory: attrs[4]; cudaErrorInvalidValue for a combination
// that is not instantiated.
extern "C" int se3_probe_stage_attrs(int stage, int mode, int use_bf16, int* attrs) {
  const StageKernel kern = stage_kernel(stage, mode, use_bf16 != 0);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = a.numRegs;
  attrs[1] = static_cast<int>(a.localSizeBytes);
  attrs[2] = static_cast<int>(a.sharedSizeBytes);
  attrs[3] = stage_smem_bytes(stage);
  return 0;
}

// geo [B, M*E, D], feat [B, M, E, C], proj [D, GQ], bias [GQ] (kTensor)
// or null (kTileSum), w [GQ, C, O], all float32 (rounded inside where use_bf16); out as the stage
// (null for pne, agg and swap in kTileSum); part [B*M/rows] and total [1]
// in kTileSum: total = the sum of the stage's values, its partials added in
// a fixed order.  E = 32, GQ = 64 (G = 2, Q = 32), C = O = 64, D <= 19.
extern "C" int se3_probe_stage_fwd(const void* geo, const void* feat, const void* proj,
                                   const void* bias, const void* w, void* out, void* part,
                                   void* total, int B, int M, int D, int stage, int mode,
                                   int use_bf16, void* stream_ptr) {
  if (B < 1 || M < kRows || M % kRows != 0 || D < 1 || D > kDMax || (kEdges * D) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((bias != nullptr) != (mode == kTensor)) return static_cast<int>(cudaErrorInvalidValue);
  const StageKernel kern = stage_kernel(stage, mode, use_bf16 != 0);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = stage_smem_bytes(stage);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  kern<<<dim3(M / kRows, B), kThreads, smem, stream>>>(
      static_cast<const float*>(geo), static_cast<const float*>(feat),
      static_cast<const float*>(proj), static_cast<const float*>(bias),
      static_cast<const float*>(w), static_cast<float*>(out), static_cast<float*>(part), M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode != kTileSum) return static_cast<int>(err);
  sum_partials_fixed<<<1, kPartThreads, 0, stream>>>(static_cast<const float*>(part), B * (M / kRows),
                                                     1, static_cast<float*>(total));
  return static_cast<int>(cudaGetLastError());
}
