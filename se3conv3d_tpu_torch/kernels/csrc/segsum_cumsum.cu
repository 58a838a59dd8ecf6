// Inclusive prefix sum along the rows of x [B, E, C] for NVIDIA Hopper
// (sm_90a): out[b, e, c] = sum_{e' <= e} x[b, e', c], x float32 or
// bfloat16, accumulated and written in float32.
//
// Replaces the TPU Pallas kernel se3conv3d_tpu/ops/pallas/segsum.py:
// _cumsum_kernel (reached through blocked_cumsum / sorted_segment_sum), the
// scan of the 'sorted' feature-gradient reduction of the conv backward.  See
// se3conv3d_tpu_torch/kernels/segsum.py for the wrapper, the plain PyTorch
// version and the segment sums built on it.
//
// What bounds it: bytes.  The function reads each input row once and writes
// each output row once, E*C*(payload bytes + 4) bytes per example: at the
// ScanNet level-0 block conv (E = 131,072 * 24 = 3,145,728 edges, C = 64,
// float32) 1.61 GB, 0.48 ms at 3.35 TB/s.
//
// The TPU kernel walks 256-row blocks in order on one core and carries the
// running total from block to block in VMEM.  Hopper blocks run in parallel
// and in no order, so this is one single-pass launch over tiles of 256 rows
// by 64 columns, one block each (two resident per SM; smaller tiles lost at
// every measured shape, see PERF.md):
//   1. a block takes its tile from a global ticket counter (not from
//      blockIdx), so it can only wait on tiles that started before it: the
//      waiting cannot deadlock, whatever the residency;
//   2. it loads the tile into registers once (16-byte vectors where C and
//      the pointers allow, scalars otherwise), scans it locally (each thread
//      a run of 16 rows of 4 columns in registers, the 16 runs' totals
//      scanned in shared memory), and publishes the tile's aggregate;
//   3. it takes the tile's offset from its predecessors and stores
//      out = x's local prefix + offset.
// A chain of tiles (one example, one column group) is cut into windows of
// kWindow tiles.  The offsets are fixed expressions of the tiles'
// aggregates, so every call gives the same bits whatever order the blocks
// run in (a classic decoupled look-back sums whichever predecessors it
// happens to find, and its float32 results change from call to call):
//   - the window sum WS[k], published by the window's last tile, is the sum
//     of the window's aggregates in a fixed order;
//   - the window prefix P[k] (k >= 1), published by the window's first
//     tile, is the sum of WS[0 .. k-1] in a fixed order (read in parallel:
//     no serial chain from window to window);
//   - a tile at position p of window k adds P[k] to the sum of the window's
//     aggregates 0 .. p-1 in a fixed order.
// Every sum in a fixed order is split over the block's 16 row lanes (lane r
// takes items r, r + 16, ...) and the 16 partial sums are added in lane
// order.  The dependency depth is three hops (aggregates -> WS -> P) at any
// length.  Each published value is a 64-bit word {float32 bits, 32-bit tag}
// written and read with volatile (L2-coherent) 16-byte accesses, so a value
// and its ready flag arrive together and no fence sits on the path; the tag
// is the call's generation.
//
// The state (ticket counter, done counter, generation, the tagged words)
// persists in a caller's buffer, zeroed once when it is made: the block that
// finishes last resets the two counters and advances the generation, so the
// next call needs no reset launch, and no argument from the host changes
// from call to call (a CUDA graph can hold the launch).  A buffer serves one
// stream at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColLanes = 16;                    // 4 columns each
constexpr int kRowLanes = kThreads / kColLanes;  // 16 runs of rows
constexpr int kRowsPerThread = 16;
constexpr int kRows = kRowLanes * kRowsPerThread;  // 256 rows per tile
constexpr int kCols = 4 * kColLanes;               // 64 columns per tile
constexpr int kWindow = 64;                      // tiles per window
constexpr int kBatch = 4;                        // look-back reads in flight per thread
constexpr long long kHeaderWords = 4;            // the counters (32 bytes)

struct Header {
  unsigned counter;  // tickets handed out in this call
  unsigned done;     // blocks finished in this call
  unsigned gen;      // generation of the last finished call
  unsigned pad;
};

__device__ __forceinline__ unsigned long long pack(float v, unsigned tag) {
  return (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
}

// 4 tagged words at p (16-byte aligned), volatile: each 64-bit word is one
// single-copy-atomic access, so its value and its tag arrive together.
__device__ __forceinline__ void store_words(unsigned long long* p, const float v[4], unsigned tag) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};"
               :: "l"(p), "l"(pack(v[0], tag)), "l"(pack(v[1], tag)) : "memory");
  asm volatile("st.volatile.global.v2.u64 [%0+16], {%1, %2};"
               :: "l"(p), "l"(pack(v[2], tag)), "l"(pack(v[3], tag)) : "memory");
}

__device__ __forceinline__ void load_words(const unsigned long long* p, unsigned long long w[4]) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(w[0]), "=l"(w[1]) : "l"(p) : "memory");
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2+16];"
               : "=l"(w[2]), "=l"(w[3]) : "l"(p) : "memory");
}

__device__ __forceinline__ bool tagged(const unsigned long long w[4], unsigned tag) {
  return static_cast<unsigned>(w[0] >> 32) == tag && static_cast<unsigned>(w[1] >> 32) == tag &&
         static_cast<unsigned>(w[2] >> 32) == tag && static_cast<unsigned>(w[3] >> 32) == tag;
}

// s[j] += value j of the words at base + i * stride, for i = first, first +
// kRowLanes, ... < count, in order of i; waits for each to carry `tag`.
// kBatch reads are in flight before the first wait; a thread that has to
// wait polls again after a sleep that doubles up to 1 us, so waiting
// blocks leave the L2 to the tiles' own traffic.
__device__ __forceinline__ void sum_tagged(const unsigned long long* base, long long stride,
                                           int first, int count, unsigned tag, float s[4]) {
  for (int i0 = first; i0 < count; i0 += kRowLanes * kBatch) {
    unsigned long long w[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kRowLanes;
      if (i < count) load_words(base + i * stride, w[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kRowLanes;
      if (i >= count) break;
      for (unsigned ns = 32; !tagged(w[u], tag); ns = ns < 1024 ? 2 * ns : ns) {
        __nanosleep(ns);
        load_words(base + i * stride, w[u]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += __uint_as_float(static_cast<unsigned>(w[u][j]));
    }
  }
}

// Columns c .. c+3 of a row of C (zero past C).  VEC: C % 4 == 0 and the
// row 4-element aligned, one 16-byte (float32) or 8-byte (bfloat16) load.
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* row, int c, int C, float v[4]) {
  if (VEC) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(row + c));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < C ? row[c + j] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load_cols(const uint16_t* row, int c, int C, float v[4]) {
  if (VEC) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(row + c));
    v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = c + j < C ? __uint_as_float(static_cast<unsigned>(row[c + j]) << 16) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_cols(float* row, int c, int C, const float v[4]) {
  if (VEC) {
    __stcs(reinterpret_cast<float4*>(row + c), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < C) row[c + j] = v[j];
  }
}

// One block per tile of kRows rows by kCols columns; T row tiles per
// example, G column groups; words: the Header, then the tiles' aggregates
// [total][kCols], then WS and P [B*G][nwin][kCols].  Tickets run over
// (b, t, g) with g fastest, so the blocks in flight read whole rows.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
scan_kernel(const T* __restrict__ x, float* __restrict__ out, unsigned long long* words,
            long long E, int C, int T_tiles, int G, int nwin, unsigned total) {
  __shared__ float part[kRowLanes][kCols];
  __shared__ float pre[kCols];
  __shared__ unsigned s_ticket, s_tag;
  Header* hdr = reinterpret_cast<Header*>(words);
  unsigned long long* agg = words + kHeaderWords;
  unsigned long long* wsum = agg + static_cast<long long>(total) * kCols;
  const long long chains = total / T_tiles;
  unsigned long long* wpre = wsum + chains * nwin * kCols;

  const int tid = threadIdx.x, rl = tid / kColLanes, cl = tid % kColLanes;
  if (tid == 0) {
    s_ticket = atomicAdd(&hdr->counter, 1u);
    s_tag = *reinterpret_cast<volatile unsigned*>(&hdr->gen) + 1u;
  }
  __syncthreads();
  const unsigned ticket = s_ticket, tag = s_tag;
  const int g = static_cast<int>(ticket % G);
  const unsigned bt = ticket / G;  // b * T + t
  const int t = static_cast<int>(bt % T_tiles), b = static_cast<int>(bt / T_tiles);
  const long long chain = static_cast<long long>(b) * G + g;
  const int k = t / kWindow, pos = t % kWindow;
  const int c = g * kCols + cl * 4;
  const long long r0 = static_cast<long long>(t) * kRows + rl * kRowsPerThread;
  const long long ex0 = static_cast<long long>(b) * E * C;

  // 2. the tile, once, and its local scan
  float v[kRowsPerThread][4];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (r0 + i < E && c < C) {
      load_cols<VEC>(x + ex0 + (r0 + i) * C, c, C, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
    }
  }
#pragma unroll
  for (int i = 1; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] += v[i - 1][j];
#pragma unroll
  for (int j = 0; j < 4; ++j) part[rl][cl * 4 + j] = v[kRowsPerThread - 1][j];
  __syncthreads();
  float base[4] = {0.f, 0.f, 0.f, 0.f};  // this run's exclusive prefix in the tile
  for (int r = 0; r < rl; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) base[j] += part[r][cl * 4 + j];
  float tile_sum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) tile_sum[j] = base[j] + v[kRowsPerThread - 1][j];
  if (rl == kRowLanes - 1 && pos + 1 < kWindow && t + 1 < T_tiles)
    store_words(agg + static_cast<long long>(ticket) * kCols + cl * 4, tile_sum, tag);
  __syncthreads();  // part is reused

  // 3. the offset: the window's earlier aggregates, or (first tile) P[k]
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (pos > 0)
    sum_tagged(agg + (static_cast<long long>(ticket) - static_cast<long long>(pos) * G) * kCols + cl * 4,
               static_cast<long long>(G) * kCols, rl, pos, tag, s);
  else if (k > 0)
    sum_tagged(wsum + chain * nwin * kCols + cl * 4, kCols, rl, k, tag, s);
#pragma unroll
  for (int j = 0; j < 4; ++j) part[rl][cl * 4 + j] = s[j];
  __syncthreads();
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < kRowLanes; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[j] += part[r][cl * 4 + j];

  float off[4];
  if (pos == 0) {  // sum is P[k] (zero in window 0)
    if (k > 0 && rl == 0 && t + 1 < T_tiles)
      store_words(wpre + (chain * nwin + k) * kCols + cl * 4, sum, tag);
#pragma unroll
    for (int j = 0; j < 4; ++j) off[j] = sum[j];
  } else {
    if (pos == kWindow - 1 && k + 1 < nwin && rl == kRowLanes - 1) {
      float ws[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[j] = sum[j] + tile_sum[j];
      store_words(wsum + (chain * nwin + k) * kCols + cl * 4, ws, tag);
    }
    if (k > 0) {  // P[k], read by one row lane for the block
      if (rl == 0) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        sum_tagged(wpre + (chain * nwin + k) * kCols + cl * 4, kCols, 0, 1, tag, p);
#pragma unroll
        for (int j = 0; j < 4; ++j) pre[cl * 4 + j] = p[j];
      }
      __syncthreads();  // block-uniform: pos and k are the block's
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) off[j] = (k > 0 ? pre[cl * 4 + j] : 0.f) + sum[j];
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) base[j] += off[j];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (r0 + i < E && c < C) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = v[i][j] + base[j];
      store_cols<VEC>(out + ex0 + (r0 + i) * C, c, C, o);
    }
  }

  // the last block to finish leaves the state ready for the next call (every
  // block read the generation, and used it, before it counts as done)
  __syncthreads();
  if (tid == 0) {
    if (atomicAdd(&hdr->done, 1u) == total - 1) {
      hdr->counter = 0;
      hdr->done = 0;
      hdr->gen = tag == 0xffffffffu ? 0u : tag;  // the next call's tag skips 0
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t launch(bool vec, const void* x, float* out, unsigned long long* words, long long E,
                   int C, int T_tiles, int G, int nwin, unsigned total, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  if (vec)
    scan_kernel<T, true><<<total, kThreads, 0, stream>>>(xp, out, words, E, C, T_tiles, G, nwin, total);
  else
    scan_kernel<T, false><<<total, kThreads, 0, stream>>>(xp, out, words, E, C, T_tiles, G, nwin, total);
  return cudaGetLastError();
}

}  // namespace

// 64-bit words of state a call over [B, E, C] needs, or -1 if it has more
// than 2**31 - 1 tiles.
extern "C" long long se3_blocked_cumsum_words(int B, long long E, int C) {
  const long long T = ceil_div(E, kRows), G = ceil_div(C, kCols);
  const long long total = B * T * G;
  if (total > 0x7fffffffLL) return -1;
  return kHeaderWords + total * kCols + 2 * B * G * ceil_div(T, kWindow) * kCols;
}

// Plain C entry point for ctypes.  x is [B, E, C] float32 (bf16 = 0) or
// bfloat16 (bf16 = 1), out [B, E, C] float32, both contiguous; words is the
// state, at least se3_blocked_cumsum_words(B, E, C) 16-byte aligned 64-bit
// words, zero when first used and used by one stream at a time.  One launch
// on `stream`; returns the first CUDA error (0 = launched).
extern "C" int se3_blocked_cumsum(const void* x, void* out, void* words, int B, long long E, int C,
                                  int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || E <= 0 || C <= 0) return 0;
  if (se3_blocked_cumsum_words(B, E, C) < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long T = ceil_div(E, kRows);
  const int G = static_cast<int>(ceil_div(C, kCols));
  const unsigned total = static_cast<unsigned>(B * T * G);
  const int nwin = static_cast<int>(ceil_div(T, kWindow));
  const size_t elem = bf16 ? 2 : 4;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * elem) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  float* o = static_cast<float*>(out);
  unsigned long long* w = static_cast<unsigned long long*>(words);
  const cudaError_t err =
      bf16 ? launch<uint16_t>(vec, x, o, w, E, C, static_cast<int>(T), G, nwin, total, stream)
           : launch<float>(vec, x, o, w, E, C, static_cast<int>(T), G, nwin, total, stream);
  return static_cast<int>(err);
}
