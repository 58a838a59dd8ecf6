// Fused PNE-conv forward for NVIDIA Hopper (sm_90a), with float32 or
// bfloat16 operands and float32 accumulation and output.
//
//   out[b,m,g,o] = sum_{q,c} W[c,q,o] * sum_{k,f: mask[b,m,k]}
//                  act(P . x[b,m,k,g,f,:] + bias)[q] * feats[b, idx[b,m,k], f, c]
//
// with x the edge's pne inputs in one of three geometries (equivariant: the
// offsets in the receiver frame and the 6D relative rotation, kD = 9;
// standard: the raw offsets, kD = 3; kernel-point: the P correlation
// weights against the kernel points, kD = kKP, fused_equiv_common.cuh) and
// act gelu, relu, sin or the identity, chosen at run time.
//
// Replaces the TPU Pallas kernel se3conv3d_tpu/ops/pallas/fused_equiv.py:
// _fwd_kernel, every geometry and activation its callers give it
// (fused_equiv_conv, fused_conv and fused_kp_conv of ops/pne_conv.py).  See
// se3conv3d_tpu_torch/kernels/fused_equiv.py for the wrapper, the plain
// PyTorch version and the design note.
//
// What bounds it: per valid edge the pne row (G*Q activations after D*G*Q
// FMAs; at kD = kKP also the P correlation weights, about 10 FLOPs and an
// exp or a sqrt each) and the basis products (2*G*Q*C FLOPs), per live row
// the weight contraction (2*G*C*Q*O FLOPs), which dominates at C = O =
// 256-320.  On the TPU one grid step held a tile's basis in VMEM and
// contracted it on the MXU; a Hopper block has no room for the basis of
// enough rows to amortise W (C*Q*O floats, 13 MB at C = O = 320).  So the
// forward is two passes over the live rows only (the query rows with a
// valid edge, live[L] = b*M + m ascending; a padded row's output is zero,
// written by the caller), in chunks whose scratch stays within a cap the
// caller gives:
//   1. basis_kernel (fused_equiv_common.cuh, shared with the backward): the
//      chunk's basis rows into a scratch [Lc*G, C*Q];
//   2. wg_product (wg_product.cuh, the product the backward shares): out
//      rows = basis . W[C*Q, O] on wgmma (3xTF32 for float32), W read from
//      an image made once a call (product_image: K-major hi / lo tiles, or
//      bfloat16 ones), its epilogue storing scratch row r*G + g at
//      out[live[r], g, :].  Where the chunk has too few tiles to fill the
//      card, the depth C*Q is split into partials that sum_splits adds in
//      a fixed order, storing through the same map.
// The result depends only on the shapes and L: two calls agree bitwise.
//
// The standard (non-equivariant) conv is the same function at G = F = 1
// with 3 pne inputs, the raw offsets (se3conv3d_tpu/ops/pne_conv.py:
// fused_conv, whose _std_geo_chunk packs them for the same TPU kernel):
// se3_fused_std_fwd takes rel [B, M, K, 1, 3] and no rot6, and runs the
// kD = 3 instantiation of basis_kernel (a third of the pne inputs, a
// quarter of the G = F = 2 basis work per row) before the same product.
// The kernel-point conv (fused_kp_conv, whose _kp_geo_chunk computed the
// weights in XLA for the TPU kernel) is se3_fused_kp_fwd: the float32 raw
// offsets (3 floats an edge, where a table of weights would be P + 1), the
// kernel points and norm_dist in, the weights computed in basis_kernel.
//
// With bfloat16 operands (the TPU kernel's bf16 path, `cdt`) rel, rot6 and
// feats arrive in bfloat16 (the kernel-point offsets stay float32, and
// each weight is rounded); basis_kernel rounds the projection and bias,
// each pne and each basis entry to bfloat16 (a scratch of 2-byte rows), and
// the product's image holds W rounded to bfloat16.  Every sum stays
// float32, as does the output.

#include "wg_product.cuh"

// Work plan of se3_fused_equiv_fwd for L live rows within cap_bytes of
// scratch, with basis rows of elem_bytes (4: float32, 2: bfloat16) per
// value: live rows per chunk, depth splits of the product, and the scratch
// bytes the caller allocates (W's image, then the chunk's basis rows, then
// the float32 split partials).  One eighth of the cap is kept for the
// partials; a single live row whose basis exceeds the rest is taken alone.
// The image is outside the cap.
extern "C" void se3_fused_equiv_fwd_plan(int L, int G, int Q, int C, int O, long long cap_bytes,
                                         int elem_bytes, int* chunk, int* splits,
                                         long long* scratch) {
  const long long cq = static_cast<long long>(C) * Q;
  const long long part_cap = cap_bytes / 8;
  long long lc = (cap_bytes - part_cap) / (G * cq * elem_bytes);
  lc = lc < 1 ? 1 : lc;
  if (lc > L) lc = L > 0 ? L : 1;
  const long long n = (L + lc - 1) / lc;
  lc = (L + n - 1) / n;  // even chunks
  const long long rows = lc * G;
  const int s = product_splits(product_tiles(rows, O), cq, O, part_cap / (rows * O * 4));
  *chunk = static_cast<int>(lc);
  *splits = s;
  *scratch = round16(product_image_bytes(O, static_cast<int>(cq), elem_bytes)) +
             round16(rows * cq * elem_bytes) + (s > 1 ? s * rows * O * 4 : 0);
}

namespace {

// The chunks of one forward call with operand type T and the geometry kD
// (kp: the kernel-point geometry's arguments at kD = kKP); `img` is W's
// image for the product.
template <int kD, typename T>
cudaError_t forward(const T* rel, const T* rot6, const T* feats, const int64_t* idx,
                    const uint8_t* mask, const float* proj, const float* bias, const uint8_t* img,
                    const int* live, float* outf, T* basis, float* part, int B, int M, int N,
                    int K, int G, int F, int Q, int C, int O, int L, int chunk, int splits,
                    int act, const KpGeo& kp, cudaStream_t stream) {
  const int CQ = C * Q, BM = B * M;
  cudaError_t err;
  for (int r0 = 0; r0 < L; r0 += chunk) {
    const int lc = L - r0 < chunk ? L - r0 : chunk;
    const int* lv = live + r0;
    err = launch_basis<T, kD>(false, rel, rot6, feats, idx, mask, proj, bias, nullptr, lv, basis,
                              nullptr, M, N, K, G, F, Q, C, O, lc, BM, act, kp, stream);
    if (err == cudaSuccess)
      err = product_fwd<T>(basis, CQ, img, outf, O, part, lc * G, O, CQ, splits, lv, G, BM, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One forward call in the geometry kD (rot6 unread at kD = 3, rel and rot6
// unread at kD = kKP, which reads kp).
template <int kD>
int forward_call(const void* rel, const void* rot6, const void* feats, const void* idx,
                 const void* mask, const void* proj, const void* bias, const void* w,
                 const void* live, void* out, void* scratch, int B, int M, int N, int K, int G,
                 int F, int Q, int C, int O, int L, int chunk, int splits, int use_bf16, int act,
                 const KpGeo& kp, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* idxp = static_cast<const int64_t*>(idx);
  const auto* maskp = static_cast<const uint8_t*>(mask);
  const auto* projf = static_cast<const float*>(proj);
  const auto* biasf = static_cast<const float*>(bias);
  const auto* livep = static_cast<const int*>(live);
  const long long CQ = static_cast<long long>(C) * Q;
  const int eb = use_bf16 ? 2 : 4;
  auto* img = static_cast<uint8_t*>(scratch);  // W's image, then the basis rows, then the partials
  char* basis = reinterpret_cast<char*>(img) + round16(product_image_bytes(O, static_cast<int>(CQ), eb));
  float* part = reinterpret_cast<float*>(basis + round16(chunk * G * CQ * eb));
  cudaError_t err;
  if (use_bf16) {
    err = launch_product_image<bf16>(static_cast<const float*>(w), O, false, O, static_cast<int>(CQ), img,
                                     stream);
    if (err == cudaSuccess)
      err = forward<kD>(static_cast<const bf16*>(rel), static_cast<const bf16*>(rot6),
                        static_cast<const bf16*>(feats), idxp, maskp, projf, biasf, img, livep,
                        static_cast<float*>(out), reinterpret_cast<bf16*>(basis), part, B, M, N, K, G, F,
                        Q, C, O, L, chunk, splits, act, kp, stream);
  } else {
    err = launch_product_image<float>(static_cast<const float*>(w), O, false, O, static_cast<int>(CQ), img,
                                      stream);
    if (err == cudaSuccess)
      err = forward<kD>(static_cast<const float*>(rel), static_cast<const float*>(rot6),
                        static_cast<const float*>(feats), idxp, maskp, projf, biasf, img, livep,
                        static_cast<float*>(out), reinterpret_cast<float*>(basis), part, B, M, N, K, G,
                        F, Q, C, O, L, chunk, splits, act, kp, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` and returns
// the first CUDA error (0 = launched).  live is the int32 table of the
// L >= 1 query rows b*M + m that have a valid edge (a row without one may
// be listed too; an entry outside [0, B*M) is skipped); out [B, M, G, O]
// float32 must be zeroed by the caller (rows not listed are not written).
// use_bf16 != 0: rel, rot6 and feats are bfloat16, else float32; the
// parameters are float32 either way.  act is the activation (Act: 0 gelu,
// 1 relu, 2 sin, 3 linear).  Each requires the plan of
// se3_fused_equiv_fwd_plan for the same L, G and operand size.
//
// The equivariant conv: proj [9, Q]; G <= 4, G*Q <= 128 (column_capacity).
extern "C" int se3_fused_equiv_fwd(const void* rel, const void* rot6, const void* feats,
                                   const void* idx, const void* mask, const void* proj,
                                   const void* bias, const void* w, const void* live, void* out,
                                   void* scratch, int B, int M, int N, int K, int G, int F, int Q,
                                   int C, int O, int L, int chunk, int splits, int use_bf16,
                                   int act, void* stream_ptr) {
  if (column_capacity(G, Q) == 0) return static_cast<int>(cudaErrorInvalidValue);
  return forward_call<9>(rel, rot6, feats, idx, mask, proj, bias, w, live, out, scratch, B, M, N,
                         K, G, F, Q, C, O, L, chunk, splits, use_bf16, act, KpGeo{}, stream_ptr);
}

// The standard conv: rel [B, M, K, 1, 3], feats [B, N, 1, C], proj [3, Q],
// out [B, M, 1, O]; G = F = 1 and Q <= 64.
extern "C" int se3_fused_std_fwd(const void* rel, const void* feats, const void* idx,
                                 const void* mask, const void* proj, const void* bias,
                                 const void* w, const void* live, void* out, void* scratch, int B,
                                 int M, int N, int K, int Q, int C, int O, int L, int chunk,
                                 int splits, int use_bf16, int act, void* stream_ptr) {
  if (Q > 64) return static_cast<int>(cudaErrorInvalidValue);
  return forward_call<3>(rel, nullptr, feats, idx, mask, proj, bias, w, live, out, scratch, B, M,
                         N, K, 1, 1, Q, C, O, L, chunk, splits, use_bf16, act, KpGeo{}, stream_ptr);
}

// The kernel-point conv: rel [B, M, K, 1, 3] float32 raw offsets whatever
// use_bf16, points [P, 3] float32, norm_dist one float32, proj [P, Q],
// feats [B, N, 1, C], out [B, M, 1, O]; G = F = 1, Q <= 64, P <= kMaxKP;
// inv_s2 = 1 / sigma^2, corr the correlation (Corr: 0 gauss, 1 linear,
// 2 box).
extern "C" int se3_fused_kp_fwd(const void* rel, const void* points, const void* norm_dist,
                                const void* feats, const void* idx, const void* mask,
                                const void* proj, const void* bias, const void* w,
                                const void* live, void* out, void* scratch, int B, int M, int N,
                                int K, int P, int Q, int C, int O, int L, int chunk, int splits,
                                int use_bf16, int act, float inv_s2, int corr, void* stream_ptr) {
  if (Q > 64 || P < 1 || P > kMaxKP || corr < kCorrGauss || corr > kCorrBox)
    return static_cast<int>(cudaErrorInvalidValue);
  const KpGeo kp{static_cast<const float*>(rel), static_cast<const float*>(points),
                 static_cast<const float*>(norm_dist), inv_s2, P, corr};
  return forward_call<kKP>(nullptr, nullptr, feats, idx, mask, proj, bias, w, live, out, scratch, B,
                           M, N, K, 1, 1, Q, C, O, L, chunk, splits, use_bf16, act, kp, stream_ptr);
}
