// K1: out = x + softmax(q k^T / sqrt(hd)) v @ W_proj^T + b_proj
// B9: out = x + proj(attn(qkv(LN1 x)))
//
// K1 replaces the Pallas kernel vsc22_tpu/ops/pallas_attn_proj.py
// `attn_proj_residual_fused` (its pallas_call at :165): q|k|v packed in
// qkv [B, L, 3C] (head h at columns h*hd of each third), probabilities and
// the attention output rounded to the working dtype, the residual added
// in f32.
//
// B9 replaces `ln_attn_proj_residual_fused` (its pallas_call at :329,
// kernel `_make_half_block_kernel` :189): LN1 with two-pass statistics
// (accumulated in f64, rounded to f32), its output rounded to the working
// dtype; the QKV product accumulated in f32 with the f32 bias added and q,
// k, v each rounded to the working dtype; logits scaled by 1/sqrt(hd)
// after the product; then K1's attention, projection and residual.
//
// What bounds them on the H100: at the main-path shapes (ViT L=145, CLIP
// L=257, hd=64) the attention core (attn_core.cuh) runs on tensor cores in
// bf16 and on CUDA-core dot products in f32; the projection (and B9's QKV
// product, 3x its FLOPs) is a dense [B*L, C] x [C, n*C] product, bound by
// the bf16 tensor-core rate in bf16 and the FMA rate in f32.
//
// Design: K1 is two launches, B9 three:
//  0. (B9) the FFMA tiled GEMM (gemm_nt.cuh) with LN1 fused into its
//     A-tile load and the QKV bias in its epilogue -> qkv [B, L, 3C] in the
//     working dtype (a scratch in device memory);
//  1. the shared attention core, one block per (query tile, head, frame),
//     reading q, k and v from the packed rows (stride 3C) -> attn [B, L, C];
//  2. the projection with a bias + f32 residual epilogue:
//     out = T(x + (attn W^T + b)). In bf16 it takes the tensor-core loop
//     `gemm_mma_kernel` where `gemm_is_mma` allows it (C % 8 == 0 and an
//     aligned W; attn is the wrapper's own buffer): its sums feed only the
//     output rounding, after the f32 residual. Else the FFMA tile.
// B9's QKV stays on the FFMA tile: its sums are rounded to bf16 as q, k
// and v, early in the block, where a summation order other than the plain
// version's flips many outputs (ROADMAP, "Order of summation"). Later
// work: keep P.V on chip into the projection.
#include "attn_core.cuh"

namespace vsc22 {

template <typename T>
int attn_proj_residual(const void* x, const void* qkv, const void* proj_w, const float* proj_b,
                       void* attn, void* out, int B, int L, int C, int H,
                       cudaStream_t stream) {
  const int hd = C / H;
  const T* q = static_cast<const T*>(qkv);
  int err = launch_attn_core<T>(q, q + C, q + 2 * C, 3 * C, static_cast<T*>(attn), C, B, L, H, hd,
                                1.0f / sqrtf((float)hd), stream);
  if (err != 0) return err;
  const T* a = static_cast<const T*>(attn);
  const T* w = static_cast<const T*>(proj_w);
  const T* xt = static_cast<const T*>(x);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (gemm_is_mma(C, a, w))
      return launch_gemm_mma<kActNone, T, true>(a, w, proj_b, static_cast<T*>(out), B * L, C, C,
                                                stream, xt);
  }
  launch_gemm<T, kActNone, false>(a, w, proj_b, xt, static_cast<T*>(out), B * L, C, C, nullptr,
                                  nullptr, 0.0f, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int ln_attn_proj_residual(const void* x, const float* ln_g, const float* ln_b,
                          const void* qkv_w, const float* qkv_b, const void* proj_w,
                          const float* proj_b, void* qkv, void* attn, void* out, int B, int L,
                          int C, int H, float eps, cudaStream_t stream) {
  launch_gemm<T, kActNone, true>(static_cast<const T*>(x), static_cast<const T*>(qkv_w), qkv_b,
                                 nullptr, static_cast<T*>(qkv), B * L, 3 * C, C, ln_g, ln_b, eps,
                                 stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return attn_proj_residual<T>(x, qkv, proj_w, proj_b, attn, out, B, L, C, H, stream);
}

}  // namespace vsc22

// x, out, attn (scratch): [B, L, C]; qkv: [B, L, 3C]; proj_w: [C, C] in
// Linear layout (out, in); proj_b: f32 [C]. All contiguous, on one device.
extern "C" int vsc22_attn_proj_residual(const void* x, const void* qkv, const void* proj_w,
                                        const float* proj_b, void* attn, void* out, int B,
                                        int L, int C, int H, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::attn_proj_residual<__nv_bfloat16>(x, qkv, proj_w, proj_b, attn, out, B, L,
                                                    C, H, s);
  return vsc22::attn_proj_residual<float>(x, qkv, proj_w, proj_b, attn, out, B, L, C, H, s);
}

// B9. x, out, attn (scratch): [B, L, C]; qkv (scratch): [B, L, 3C]; qkv_w:
// [3C, C] and proj_w: [C, C] in Linear layout; ln_g, ln_b, proj_b: f32
// [C]; qkv_b: f32 [3C].
extern "C" int vsc22_ln_attn_proj_residual(const void* x, const float* ln_g, const float* ln_b,
                                           const void* qkv_w, const float* qkv_b,
                                           const void* proj_w, const float* proj_b, void* qkv,
                                           void* attn, void* out, int B, int L, int C, int H,
                                           float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::ln_attn_proj_residual<__nv_bfloat16>(x, ln_g, ln_b, qkv_w, qkv_b, proj_w,
                                                       proj_b, qkv, attn, out, B, L, C, H, eps,
                                                       s);
  return vsc22::ln_attn_proj_residual<float>(x, ln_g, ln_b, qkv_w, qkv_b, proj_w, proj_b, qkv,
                                             attn, out, B, L, C, H, eps, s);
}
