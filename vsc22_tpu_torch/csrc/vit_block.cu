// B10: one whole pre-LN transformer block (ViT / CLIP)
//
//   x1  = x + proj(attn(LN1 x))
//   out = x1 + fc2(act(fc1(LN2 x1)))
//
// Replaces the Pallas kernel vsc22_tpu/ops/pallas_vit_block.py
// `vit_block_fused` (its pallas_call at :215; dispatcher `vit_block` :291,
// oracle `vit_block_reference` :258). Its rounding points, copied here:
// LN1 and LN2 with two-pass statistics (accumulated in f64, rounded to
// f32), rounded to the working dtype;
// the QKV product accumulated in f32 with the f32 bias added, q scaled by
// 1/sqrt(hd) in f32 and then rounded, k and v rounded (the TPU kernel keeps
// q and k in f32 and rounds them at the logits product: the same values);
// probabilities and the attention output rounded; the residual x1 rounded
// to the working dtype inside the block; the hidden rounded after the
// activation (exact GELU or QuickGELU); the output residual added in f32.
//
// What bounds it on the H100: the four dense products (QKV, proj, fc1,
// fc2: 2*rows*(4C^2 + 2CF) FLOPs, 828 GFLOP at a 128-frame CLIP chunk), so
// the bf16 tensor-core rate in bf16 and the FMA rate in f32; then the
// attention core (attn_core.cuh: tensor cores in bf16, CUDA-core dot
// products in f32).
//
// Design: the TPU kernel kept a frame's whole block in VMEM (~100 MB); an
// SM has 227 KB, so the block is the stages that B9 and K2 run, composed,
// and its intermediates (ln, qkv, attention output, x1, hidden) go through
// device memory in the working dtype. In bf16, seven launches:
//  (a, b) `ln_qkv` (attn_proj.cuh): K2's LN-rows kernel, LN1(x) -> ln
//      [M, C]; QKV on the 128x128 FFMA tile (`gemm128_bias_kernel`) with
//      q's columns (acc + b) * hd^-0.5 in f32, then q, k and v rounded
//      once -> qkv [M, 3C];
//  (c, d) K1's `attn_proj_residual` (attn_proj.cuh): the attention core
//      with scale 1 -> attn [M, C], then proj + bias + the f32 residual x
//      on the 128x128 FFMA tile -> x1 [M, C];
//  (e-g) K2's `ln_fc1` and `fc2_residual` (ln_mlp.cuh) on x1: LN2 rows ->
//      ln, fc1 + bias + activation on the tensor-core loop where
//      `gemm_is_mma` allows it -> hidden [M, F], fc2 + bias + the f32
//      residual x1 on it -> out.
// QKV and proj keep the plain version's order of summation: their sums
// are rounded to bf16 as q, k and v, and as x1, which LN2 reads, so
// another order is carried into many outputs (ROADMAP, "Order of
// summation"). On the tensor-core loop QKV moved 18.6% of the CLIP-width
// bf16 outputs (limit 2%), and proj 2.03% with QKV in order; with both in
// order 1.85% (scripts/torch_gemm_probe.py --steps, PERF.md). f32 takes
// the 64x64 FFMA tile for all four, with LN1 and LN2 fused into the A-tile
// loads of QKV and fc1: five launches. Later work: the LN in an
// ldmatrix-fed tile, the hidden kept on chip, wgmma.
#include "attn_proj.cuh"

namespace vsc22 {

template <typename T>
int vit_block(const T* x, const float* ln1_g, const float* ln1_b, const T* qkv_w,
              const float* qkv_b, const T* proj_w, const float* proj_b, const float* ln2_g,
              const float* ln2_b, const T* fc1_w, const float* fc1_b, const T* fc2_w,
              const float* fc2_b, T* ln, T* qkv, T* attn, T* x1, T* hidden, T* out, int B, int L,
              int C, int H, int F, int act, float eps, cudaStream_t stream) {
  const int M = B * L;
  int rc = ln_qkv<T, true>(x, ln1_g, ln1_b, qkv_w, qkv_b, ln, qkv, M, C, eps,
                           1.0f / sqrtf((float)(C / H)), stream);
  if (rc != 0) return rc;
  rc = attn_proj_residual<T, true>(x, qkv, proj_w, proj_b, attn, x1, B, L, C, H, 1.0f, stream);
  if (rc != 0) return rc;
  rc = act == kActQuickGelu
           ? ln_fc1<T, kActQuickGelu>(x1, ln2_g, ln2_b, fc1_w, fc1_b, ln, hidden, M, C, F, eps,
                                      stream)
           : ln_fc1<T, kActGelu>(x1, ln2_g, ln2_b, fc1_w, fc1_b, ln, hidden, M, C, F, eps,
                                 stream);
  if (rc != 0) return rc;
  return fc2_residual<T>(hidden, fc2_w, fc2_b, x1, out, M, C, F, stream);
}

template <typename T>
int b10(const void* x, const float* ln1_g, const float* ln1_b, const void* qkv_w,
        const float* qkv_b, const void* proj_w, const float* proj_b, const float* ln2_g,
        const float* ln2_b, const void* fc1_w, const float* fc1_b, const void* fc2_w,
        const float* fc2_b, void* ln, void* qkv, void* attn, void* x1, void* hidden, void* out,
        int B, int L, int C, int H, int F, int act, float eps, cudaStream_t stream) {
  return vit_block<T>(static_cast<const T*>(x), ln1_g, ln1_b, static_cast<const T*>(qkv_w),
                      qkv_b, static_cast<const T*>(proj_w), proj_b, ln2_g, ln2_b,
                      static_cast<const T*>(fc1_w), fc1_b, static_cast<const T*>(fc2_w), fc2_b,
                      static_cast<T*>(ln), static_cast<T*>(qkv), static_cast<T*>(attn),
                      static_cast<T*>(x1), static_cast<T*>(hidden), static_cast<T*>(out), B, L,
                      C, H, F, act, eps, stream);
}

}  // namespace vsc22

// x, out and the scratches attn, x1: [B, L, C]; ln (scratch, bf16 only):
// [B, L, C]; qkv (scratch): [B, L, 3C]; hidden (scratch): [B, L, F]; qkv_w
// [3C, C], proj_w [C, C], fc1_w [F, C], fc2_w [C, F] in Linear layout (out,
// in); LN params and biases f32. act: 1 GELU, 2 QuickGELU.
extern "C" int vsc22_vit_block(const void* x, const float* ln1_g, const float* ln1_b,
                               const void* qkv_w, const float* qkv_b, const void* proj_w,
                               const float* proj_b, const float* ln2_g, const float* ln2_b,
                               const void* fc1_w, const float* fc1_b, const void* fc2_w,
                               const float* fc2_b, void* ln, void* qkv, void* attn, void* x1,
                               void* hidden, void* out, int B, int L, int C, int H, int F,
                               int act, float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto run = dtype == vsc22::kBF16 ? vsc22::b10<__nv_bfloat16> : vsc22::b10<float>;
  return run(x, ln1_g, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_g, ln2_b, fc1_w, fc1_b, fc2_w,
             fc2_b, ln, qkv, attn, x1, hidden, out, B, L, C, H, F, act, eps, s);
}
