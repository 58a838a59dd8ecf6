// Inclusive float32 prefix sum along the rows of x [B, E, C] for NVIDIA
// Hopper (sm_90a): out[b, e, c] = sum_{e' <= e} x[b, e', c].
//
// Replaces the TPU Pallas kernel se3conv3d_tpu/ops/pallas/segsum.py:
// _cumsum_kernel (reached through blocked_cumsum / sorted_segment_sum), the
// scan of the 'sorted' feature-gradient reduction of the conv backward.  See
// se3conv3d_tpu_torch/kernels/segsum.py for the wrapper, the plain PyTorch
// version and the segment sums built on it.
//
// The TPU kernel walks 256-row blocks in order on one core and carries the
// running total from block to block in VMEM.  Hopper blocks run in parallel
// and in no order, so this is a reduce-then-scan in three launches:
//   1. tile_sums: the column sums of each 256-row tile -> sums [B, T, C];
//   2. scan_tile_sums: an exclusive scan of sums along T, in place, for
//      each (b, c) column: 32 threads per column each sum a segment of the
//      tiles, scan the 32 segment totals in shared memory, then rescan their
//      segment (the tiles' offsets);
//   3. tile_scan: each tile again, every thread holding 32 rows of one column
//      in registers: a running sum in registers, the 8 row groups' totals
//      scanned in shared memory, plus the tile's offset, stored.
// A block is 32 columns (one warp: a row of 32 floats is one 128-byte load)
// by 8 row groups of 32 rows.
//
// What bounds it: bytes.  The function reads E*C*4 bytes and writes as many;
// at the ScanNet level-0 block conv (E = 131,072 * 24 = 3,145,728 edges,
// C = 64) that is 1.61 GB, 0.48 ms at 3.35 TB/s.  This design reads x twice
// (passes 1 and 3), 1.5x the bound's bytes; a single-pass decoupled
// look-back scan would reach 1x and is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                          // columns per block
constexpr int kGroups = 8;                         // row groups (warps) per block
constexpr int kRowsPerThread = 32;
constexpr int kTile = kGroups * kRowsPerThread;    // 256 rows per tile

__global__ void __launch_bounds__(kCols * kGroups)
tile_sums(const float* __restrict__ x, float* __restrict__ sums, long long E, int C, int T) {
  __shared__ float red[kGroups][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = blockIdx.x, c = blockIdx.y * kCols + tx, b = blockIdx.z;
  const long long r0 = static_cast<long long>(t) * kTile + ty * kRowsPerThread;
  float s = 0.f;
  if (c < C) {
    const float* p = x + (static_cast<long long>(b) * E + r0) * C + c;
#pragma unroll 8
    for (int i = 0; i < kRowsPerThread; ++i)
      if (r0 + i < E) s += __ldg(p + static_cast<long long>(i) * C);
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < C) {
    float tot = 0.f;
#pragma unroll
    for (int y = 0; y < kGroups; ++y) tot += red[y][tx];
    sums[(static_cast<long long>(b) * T + t) * C + c] = tot;
  }
}

// Block (32, 32): threadIdx.x a column, threadIdx.y one of 32 segments of T.
__global__ void __launch_bounds__(1024)
scan_tile_sums(float* __restrict__ sums, int T, int C) {
  __shared__ float seg[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx, b = blockIdx.y;
  const int per = (T + 31) / 32;
  const int t0 = min(T, ty * per), t1 = min(T, t0 + per);
  float* col = sums + static_cast<long long>(b) * T * C + c;
  float s = 0.f;
  if (c < C)
    for (int t = t0; t < t1; ++t) s += col[static_cast<long long>(t) * C];
  seg[ty][tx] = s;
  __syncthreads();
  if (ty == 0) {
    float run = 0.f;
    for (int y = 0; y < 32; ++y) {
      const float v = seg[y][tx];
      seg[y][tx] = run;
      run += v;
    }
  }
  __syncthreads();
  float run = seg[ty][tx];
  if (c < C)
    for (int t = t0; t < t1; ++t) {
      const float v = col[static_cast<long long>(t) * C];
      col[static_cast<long long>(t) * C] = run;
      run += v;
    }
}

__global__ void __launch_bounds__(kCols * kGroups)
tile_scan(const float* __restrict__ x, const float* __restrict__ offsets,
          float* __restrict__ out, long long E, int C, int T) {
  __shared__ float part[kGroups][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = blockIdx.x, c = blockIdx.y * kCols + tx, b = blockIdx.z;
  const long long r0 = static_cast<long long>(t) * kTile + ty * kRowsPerThread;
  const long long base = (static_cast<long long>(b) * E + r0) * C + c;
  float v[kRowsPerThread];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const float xi = (c < C && r0 + i < E) ? __ldg(x + base + static_cast<long long>(i) * C) : 0.f;
    s += xi;
    v[i] = s;
  }
  part[ty][tx] = s;
  __syncthreads();
  if (c >= C) return;
  float off = offsets[(static_cast<long long>(b) * T + t) * C + c];
  for (int y = 0; y < ty; ++y) off += part[y][tx];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    if (r0 + i < E) out[base + static_cast<long long>(i) * C] = v[i] + off;
}

}  // namespace

// Number of 256-row tiles of E rows: the caller's sums scratch is [B, T, C].
extern "C" long long se3_blocked_cumsum_tiles(long long E) { return (E + kTile - 1) / kTile; }

// Plain C entry point for ctypes.  x and out are [B, E, C] float32,
// contiguous; sums is a [B, T, C] float32 scratch.  Launches on `stream` and
// returns the first CUDA error (0 = launched).  Requires B <= 65535 and
// ceil(C / 32) <= 65535.
extern "C" int se3_blocked_cumsum(const void* x, void* out, void* sums, int B, long long E,
                                  int C, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long T = se3_blocked_cumsum_tiles(E);
  if (B == 0 || E == 0 || C == 0) return 0;
  if (T > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int Ti = static_cast<int>(T);
  const unsigned cblocks = static_cast<unsigned>((C + kCols - 1) / kCols);
  const dim3 tiles(static_cast<unsigned>(Ti), cblocks, static_cast<unsigned>(B));
  const dim3 block(kCols, kGroups);
  float* s = static_cast<float*>(sums);
  tile_sums<<<tiles, block, 0, stream>>>(static_cast<const float*>(x), s, E, C, Ti);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tile_sums<<<dim3(cblocks, static_cast<unsigned>(B)), dim3(32, 32), 0, stream>>>(s, Ti, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tile_scan<<<tiles, block, 0, stream>>>(static_cast<const float*>(x), s,
                                         static_cast<float*>(out), E, C, Ti);
  return static_cast<int>(cudaGetLastError());
}
