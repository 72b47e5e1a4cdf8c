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
// Design: K1 is two launches (`attn_proj_residual`, attn_proj.cuh):
//  1. the shared attention core, one block per (query tile, head, frame),
//     reading q, k and v from the packed rows (stride 3C) -> attn [B, L, C];
//  2. the projection with a bias + f32 residual epilogue:
//     out = T(x + (attn W^T + b)). In bf16 it takes the tensor-core loop
//     `gemm_mma_kernel` where `gemm_is_mma` allows it (C % 8 == 0 and an
//     aligned W; attn is the wrapper's own buffer): its sums feed only the
//     output rounding, after the f32 residual. Else the FFMA tile.
// B9 puts `ln_qkv` (attn_proj.cuh) before them. In bf16 that is two
// launches, so B9 is four:
//  (a) K2's `ln_rows_kernel`: LN1(x) rounded to bf16 -> a scratch ln
//      [B, L, C], bit for bit the plain LN;
//  (b) QKV on the 128x128 FFMA tile (`gemm128_bias_kernel`), the f32 bias
//      added and q, k, v rounded once -> qkv [B, L, 3C] (a scratch);
//  (c, d) K1 as above.
// (b) keeps the plain version's order of summation: its sums are rounded
// to bf16 as q, k and v early in the block, where another order is
// carried into many outputs (ROADMAP, "Order of summation"). On the
// tensor-core loop B9's QKV moved 2.0026% of its CLIP-width bf16 outputs
// (limit 2%), in order 0.1311% (scripts/torch_gemm_probe.py --steps,
// PERF.md); in order, B9's bf16 outputs are bit for bit those it gave on
// the 64x64 tile with the LN in its A-tile load, in 1.8x the time. f32
// takes that tile, then K1: three launches. Later work: the LN in an
// ldmatrix-fed tile, P.V kept on chip into the projection.
#include "attn_proj.cuh"

namespace vsc22 {

template <typename T>
int k1(const void* x, const void* qkv, const void* proj_w, const float* proj_b, void* attn,
       void* out, int B, int L, int C, int H, cudaStream_t stream) {
  return attn_proj_residual<T>(static_cast<const T*>(x), static_cast<const T*>(qkv),
                               static_cast<const T*>(proj_w), proj_b, static_cast<T*>(attn),
                               static_cast<T*>(out), B, L, C, H, 1.0f / sqrtf((float)(C / H)),
                               stream);
}

template <typename T>
int b9(const void* x, const float* ln_g, const float* ln_b, const void* qkv_w,
       const float* qkv_b, const void* proj_w, const float* proj_b, void* ln, void* qkv,
       void* attn, void* out, int B, int L, int C, int H, float eps, cudaStream_t stream) {
  const int rc = ln_qkv<T, false>(
      static_cast<const T*>(x), ln_g, ln_b, static_cast<const T*>(qkv_w), qkv_b,
      static_cast<T*>(ln), static_cast<T*>(qkv), B * L, C, eps, 1.0f, stream);
  if (rc != 0) return rc;
  return k1<T>(x, qkv, proj_w, proj_b, attn, out, B, L, C, H, stream);
}

}  // namespace vsc22

// x, out, attn (scratch): [B, L, C]; qkv: [B, L, 3C]; proj_w: [C, C] in
// Linear layout (out, in); proj_b: f32 [C]. All contiguous, on one device.
extern "C" int vsc22_attn_proj_residual(const void* x, const void* qkv, const void* proj_w,
                                        const float* proj_b, void* attn, void* out, int B,
                                        int L, int C, int H, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::k1<__nv_bfloat16>(x, qkv, proj_w, proj_b, attn, out, B, L, C, H, s);
  return vsc22::k1<float>(x, qkv, proj_w, proj_b, attn, out, B, L, C, H, s);
}

// B9. x, out, attn (scratch): [B, L, C]; ln (scratch, bf16 only): [B, L, C];
// qkv (scratch): [B, L, 3C]; qkv_w: [3C, C] and proj_w: [C, C] in Linear
// layout; ln_g, ln_b, proj_b: f32 [C]; qkv_b: f32 [3C].
extern "C" int vsc22_ln_attn_proj_residual(const void* x, const float* ln_g, const float* ln_b,
                                           const void* qkv_w, const float* qkv_b,
                                           const void* proj_w, const float* proj_b, void* ln,
                                           void* qkv, void* attn, void* out, int B, int L, int C,
                                           int H, float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::b9<__nv_bfloat16>(x, ln_g, ln_b, qkv_w, qkv_b, proj_w, proj_b, ln, qkv, attn,
                                    out, B, L, C, H, eps, s);
  return vsc22::b9<float>(x, ln_g, ln_b, qkv_w, qkv_b, proj_w, proj_b, ln, qkv, attn, out, B, L,
                          C, H, eps, s);
}
