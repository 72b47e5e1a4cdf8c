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
// fc2: 2*rows*(4C^2 + 2CF) FLOPs) on CUDA-core FFMA in this version; the
// attention core (attn_core.cuh) runs on tensor cores in bf16 and on
// CUDA-core dot products in f32.
//
// Design: the TPU kernel kept a frame's whole block in VMEM (~100 MB);
// an SM has 227 KB, so this first version is five launches whose
// intermediates (qkv, attention output, x1, hidden) go through device
// memory in the working dtype:
//  1. the shared tiled GEMM (gemm_nt.cuh) with LN1 fused into its A-tile
//     load; epilogue + bias, q's columns times the scale -> qkv [M, 3C];
//  2. the shared attention core with scale 1 -> attn [M, C];
//  3. the GEMM with the proj bias + f32 residual epilogue -> x1 [M, C];
//  4. the GEMM with LN2 fused into its A-tile load, fc1 bias and the
//     activation -> hidden [M, F];
//  5. the GEMM with the fc2 bias + f32 residual epilogue -> out [M, C].
// Later work: keep the block on chip, and tensor cores for the GEMMs.
#include "attn_core.cuh"

namespace vsc22 {

template <typename T>
int vit_block(const T* x, const float* ln1_g, const float* ln1_b, const T* qkv_w,
              const float* qkv_b, const T* proj_w, const float* proj_b, const float* ln2_g,
              const float* ln2_b, const T* fc1_w, const float* fc1_b, const T* fc2_w,
              const float* fc2_b, T* qkv, T* attn, T* x1, T* hidden, T* out, int B, int L, int C,
              int H, int F, int act, float eps, cudaStream_t stream) {
  const int M = B * L, hd = C / H;
  launch_gemm<T, kActNone, true>(x, qkv_w, qkv_b, nullptr, qkv, M, 3 * C, C, ln1_g, ln1_b, eps,
                                 stream, C, 1.0f / sqrtf((float)hd));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = launch_attn_core<T>(qkv, qkv + C, qkv + 2 * C, 3 * C, attn, C, B, L, H, hd, 1.0f,
                                     stream);
  if (rc != 0) return rc;
  launch_gemm<T, kActNone, false>(attn, proj_w, proj_b, x, x1, M, C, C, nullptr, nullptr, 0.0f,
                                  stream);
  if (act == kActQuickGelu)
    launch_gemm<T, kActQuickGelu, true>(x1, fc1_w, fc1_b, nullptr, hidden, M, F, C, ln2_g, ln2_b,
                                        eps, stream);
  else
    launch_gemm<T, kActGelu, true>(x1, fc1_w, fc1_b, nullptr, hidden, M, F, C, ln2_g, ln2_b, eps,
                                   stream);
  launch_gemm<T, kActNone, false>(hidden, fc2_w, fc2_b, x1, out, M, C, F, nullptr, nullptr, 0.0f,
                                  stream);
  return (int)cudaGetLastError();
}

}  // namespace vsc22

// x, out and the scratches attn, x1: [B, L, C]; qkv (scratch): [B, L, 3C];
// hidden (scratch): [B, L, F]; qkv_w [3C, C], proj_w [C, C], fc1_w [F, C],
// fc2_w [C, F] in Linear layout (out, in); LN params and biases f32.
// act: 1 GELU, 2 QuickGELU.
extern "C" int vsc22_vit_block(const void* x, const float* ln1_g, const float* ln1_b,
                               const void* qkv_w, const float* qkv_b, const void* proj_w,
                               const float* proj_b, const float* ln2_g, const float* ln2_b,
                               const void* fc1_w, const float* fc1_b, const void* fc2_w,
                               const float* fc2_b, void* qkv, void* attn, void* x1, void* hidden,
                               void* out, int B, int L, int C, int H, int F, int act, float eps,
                               int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16) {
    using T = __nv_bfloat16;
    return vsc22::vit_block<T>(
        static_cast<const T*>(x), ln1_g, ln1_b, static_cast<const T*>(qkv_w), qkv_b,
        static_cast<const T*>(proj_w), proj_b, ln2_g, ln2_b, static_cast<const T*>(fc1_w), fc1_b,
        static_cast<const T*>(fc2_w), fc2_b, static_cast<T*>(qkv), static_cast<T*>(attn),
        static_cast<T*>(x1), static_cast<T*>(hidden), static_cast<T*>(out), B, L, C, H, F, act,
        eps, s);
  }
  using T = float;
  return vsc22::vit_block<T>(
      static_cast<const T*>(x), ln1_g, ln1_b, static_cast<const T*>(qkv_w), qkv_b,
      static_cast<const T*>(proj_w), proj_b, ln2_g, ln2_b, static_cast<const T*>(fc1_w), fc1_b,
      static_cast<const T*>(fc2_w), fc2_b, static_cast<T*>(qkv), static_cast<T*>(attn),
      static_cast<T*>(x1), static_cast<T*>(hidden), static_cast<T*>(out), B, L, C, H, F, act, eps,
      s);
}
