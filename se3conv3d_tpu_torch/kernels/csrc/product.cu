// The conv's shared product (wg_product.cuh) alone, at its three layouts,
// for NVIDIA Hopper (sm_90a): the entry that the card tests and
// chip_smoke.py hold against the product's plain version
// (se3conv3d_tpu_torch/kernels/product.py).  The conv's forward and
// backward launch the same kernels from their own sources; nothing on the
// main path calls this one.
//
// Layouts (T: float32, or bfloat16 with use_bf16; W float32, rounded to
// bfloat16 in its image with use_bf16):
//   0 forward: out [I, J] float32 = a [I, K] (row stride lda) . W [K, J]
//              (stride ldb); row i stored at rowmap[i / G] * G + i % G (none
//              outside [0, map_rows)) when rowmap is given;
//   1 d_w:     out [I, J] float32 = sum_k a[k][i] * b[k][j], a [K, I] and b
//              [K, J] (strides lda, ldb) in T;
//   2 dbasis:  out [I, J] in T = a [I, K] . W^T, W [J, K] (stride ldb).
// out's rows are ldc apart.  Replaces no TPU kernel of its own: the TPU
// kernels computed these products in _fwd_kernel / _bwd_kernel's bodies.

#include "wg_product.cuh"

namespace {
enum Layout : int { kLayoutFwd = 0, kLayoutDw = 1, kLayoutDbasis = 2 };
}

// Depth splits of the product (1 for dbasis) and the scratch bytes the
// caller allocates for it: W's image (forward, dbasis), then the float32
// split partials (splits x I x J, when more than one).
extern "C" void se3_product_plan(int layout, int I, int J, int K, int elem_bytes, int* splits,
                                 long long* scratch) {
  const int s = layout == kLayoutDbasis ? 1 : product_splits(product_tiles(I, J), K, J, kPMaxSplits);
  *splits = s;
  *scratch = (layout == kLayoutDw ? 0 : round16(product_image_bytes(J, K, elem_bytes))) +
             (s > 1 ? static_cast<long long>(s) * I * J * 4 : 0);
}

namespace {

template <typename T>
cudaError_t product_call(int layout, const void* a, long long lda, const void* b, long long ldb, void* out,
                         long long ldc, const int* rowmap, int G, int map_rows, int I, int J, int K,
                         int splits, void* scratch, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  auto* img = static_cast<uint8_t*>(scratch);
  const long long img_bytes = layout == kLayoutDw ? 0 : round16(product_image_bytes(J, K, sizeof(T)));
  float* part = reinterpret_cast<float*>(img + img_bytes);
  cudaError_t err;
  switch (layout) {
    case kLayoutFwd:
      err = launch_product_image<T>(static_cast<const float*>(b), ldb, false, J, K, img, stream);
      if (err != cudaSuccess) return err;
      return product_fwd<T>(at, lda, img, static_cast<float*>(out), ldc, part, I, J, K, splits, rowmap, G,
                            map_rows, stream);
    case kLayoutDw:
      if (ldc != J) return cudaErrorInvalidValue;  // the partials' rows are J wide
      return product_dw<T>(at, lda, static_cast<const T*>(b), ldb, static_cast<float*>(out), part, I, J, K,
                           splits, stream);
    default:
      err = launch_product_image<T>(static_cast<const float*>(b), ldb, true, J, K, img, stream);
      if (err != cudaSuccess) return err;
      return product_dbasis<T>(at, lda, img, static_cast<T*>(out), ldc, I, J, K, stream);
  }
}

}  // namespace

// Launches the product on `stream` and returns the first CUDA error (0 =
// launched).  Refuses (cudaErrorInvalidValue) an unknown layout, a size
// below 1, a split count other than se3_product_plan's kind (dbasis: 1), a
// map with G < 1, and a row stride shorter than its row: lda < K (forward,
// dbasis) or I (d_w), ldb < J (forward, d_w) or K (dbasis), ldc < J.
extern "C" int se3_product(int layout, int use_bf16, const void* a, long long lda, const void* b,
                           long long ldb, void* out, long long ldc, const void* rowmap, int G,
                           int map_rows, int I, int J, int K, int splits, void* scratch,
                           void* stream_ptr) {
  const bool dw = layout == kLayoutDw;
  if (layout < kLayoutFwd || layout > kLayoutDbasis || I < 1 || J < 1 || K < 1 || splits < 1 ||
      (layout == kLayoutDbasis && splits != 1) || (rowmap != nullptr && (G < 1 || layout != kLayoutFwd)) ||
      lda < (dw ? I : K) || ldb < (layout == kLayoutDbasis ? K : J) || ldc < J)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* map = static_cast<const int*>(rowmap);
  const cudaError_t err =
      use_bf16 ? product_call<bf16>(layout, a, lda, b, ldb, out, ldc, map, G, map_rows, I, J, K, splits, scratch,
                                    stream)
               : product_call<float>(layout, a, lda, b, ldb, out, ldc, map, G, map_rows, I, J, K, splits,
                                     scratch, stream);
  return static_cast<int>(err);
}
