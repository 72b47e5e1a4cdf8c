// The attention half of a pre-LN block, as stages that B9 (attn_proj.cu)
// and B10 (vit_block.cu) both run, and K1 is the last two of:
//  `ln_qkv`              qkv = T(LN1(x) W^T + b), q's columns optionally
//                        scaled in f32 before the rounding (B10's folded
//                        softmax scale);
//  `attn_proj_residual`  the attention core at `scale` from the packed qkv,
//                        then out = T(x + attn W_proj^T + b_proj) (K1).
// attn_proj.cu has the design.
#pragma once

#include <type_traits>

#include "attn_core.cuh"
#include "ln_mlp.cuh"

namespace vsc22 {

// qkv [M, 3C] = T(LN(x) W^T + bias), with the columns n < C times q_scale in
// f32 first under SCALE_Q. In bf16: K2's LN-rows kernel into the scratch
// `ln` [M, C], then the product on the 128x128 FFMA tile, in the plain
// version's order of summation (q, k and v are rounded from these sums
// early in the block, where another order is carried into many outputs:
// attn_proj.cu, vit_block.cu). In f32 the 64x64 FFMA tile with the LN
// fused into its A-tile load.
template <typename T, bool SCALE_Q>
int ln_qkv(const T* x, const float* ln_g, const float* ln_b, const T* w, const float* bias,
           T* ln, T* qkv, int M, int C, float eps, float q_scale, cudaStream_t stream) {
  const int scaled_cols = SCALE_Q ? C : 0;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const int rc = launch_ln_rows(x, ln_g, ln_b, ln, M, C, eps, stream);
    if (rc != 0) return rc;
    return launch_gemm128_bias<T, T, false, SCALE_Q>(ln, w, bias, qkv, M, 3 * C, C, stream,
                                                     nullptr, scaled_cols, q_scale);
  }
  launch_gemm<T, kActNone, true>(x, w, bias, nullptr, qkv, M, 3 * C, C, ln_g, ln_b, eps, stream,
                                 scaled_cols, q_scale);
  return (int)cudaGetLastError();
}

// K1: the core softmax(scale q k^T) v of the packed qkv [B, L, 3C] into the
// scratch attn [B, L, C], then out = T(x + (attn W^T + b)). In bf16 the
// projection takes the tensor-core loop where `gemm_is_mma` allows it (attn
// is the wrapper's own buffer), or under PROJ_IN_ORDER (B10) always the
// 128x128 FFMA tile; else the 64x64 FFMA tile.
template <typename T, bool PROJ_IN_ORDER = false>
int attn_proj_residual(const T* x, const T* qkv, const T* proj_w, const float* proj_b, T* attn,
                       T* out, int B, int L, int C, int H, float scale, cudaStream_t stream) {
  const int rc = launch_attn_core<T>(qkv, qkv + C, qkv + 2 * C, 3 * C, attn, C, B, L, H, C / H,
                                     scale, stream);
  if (rc != 0) return rc;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if constexpr (PROJ_IN_ORDER)
      return launch_gemm128_bias<T, T, true>(attn, proj_w, proj_b, out, B * L, C, C, stream, x);
    if (gemm_is_mma(C, attn, proj_w))
      return launch_gemm_mma<kActNone, T, true>(attn, proj_w, proj_b, out, B * L, C, C, stream,
                                                x);
  }
  launch_gemm<T, kActNone, false>(attn, proj_w, proj_b, x, out, B * L, C, C, nullptr, nullptr,
                                  0.0f, stream);
  return (int)cudaGetLastError();
}

}  // namespace vsc22
