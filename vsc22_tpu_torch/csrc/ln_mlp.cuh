// K2's stages, shared with B10 (vit_block.cu), which runs them on its x1:
//  `launch_ln_rows`  LN(x) rounded to T into a scratch, one warp per row;
//  `ln_fc1`          hidden = T(act(LN(x) W1^T + b1)): the LN rows, then fc1
//                    on the tensor-core loop where `gemm_is_mma` allows it in
//                    bf16, else the FFMA tile with the LN in its A-tile load;
//  `fc2_residual`    out = T(x + hidden W2^T + b2), on the same rule.
// ln_mlp.cu has the design.
#pragma once

#include <type_traits>

#include "gemm_nt.cuh"

namespace vsc22 {

constexpr int kLnRowWarps = 8;

// out[m] = T(LN(x[m])) over rows of C: one warp per row.
template <typename T>
__global__ void __launch_bounds__(kLnRowWarps * 32)
    ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, T* __restrict__ out, int M, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * kLnRowWarps + threadIdx.x / 32;
  if (row >= (size_t)M) return;
  const T* xr = x + row * C;
  float mean, rstd;
  ln_row_stats(xr, C, eps, lane, mean, rstd);
  T* orow = out + row * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = from_f32<T>(ln_apply(to_f32(xr[c]), mean, rstd, g[c], b[c]));
}

template <typename T>
int launch_ln_rows(const T* x, const float* g, const float* b, T* out, int M, int C, float eps,
                   cudaStream_t stream) {
  const int blocks = (M + kLnRowWarps - 1) / kLnRowWarps;
  ln_rows_kernel<T><<<blocks, kLnRowWarps * 32, 0, stream>>>(x, g, b, out, M, C, eps);
  return (int)cudaGetLastError();
}

// hidden = T(act(LN(x) W1^T + b1)): (a) and (b) above where `gemm_is_mma`
// allows it in bf16, else the FFMA tile with the LN fused into its A-tile
// load. `ln` is a scratch [M, C] in T (bf16 only).
template <typename T, int ACT>
int ln_fc1(const T* x, const float* ln_g, const float* ln_b, const T* w1, const float* b1, T* ln,
           T* hidden, int M, int C, int Hd, float eps, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (gemm_is_mma(C, ln, w1)) {
      const int rc = launch_ln_rows(x, ln_g, ln_b, ln, M, C, eps, stream);
      if (rc != 0) return rc;
      return launch_gemm_mma<ACT, T>(ln, w1, b1, hidden, M, Hd, C, stream);
    }
  }
  launch_gemm<T, ACT, true>(x, w1, b1, nullptr, hidden, M, Hd, C, ln_g, ln_b, eps, stream);
  return (int)cudaGetLastError();
}

// out = T(x + hidden W2^T + b2), on the mma loop where `gemm_is_mma` allows
// it in bf16, else the FFMA tile.
template <typename T>
int fc2_residual(const T* hidden, const T* w2, const float* b2, const T* x, T* out, int M, int C,
                 int Hd, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (gemm_is_mma(Hd, hidden, w2))
      return launch_gemm_mma<kActNone, T, true>(hidden, w2, b2, out, M, C, Hd, stream, x);
  }
  launch_gemm<T, kActNone, false>(hidden, w2, b2, x, out, M, C, Hd, nullptr, nullptr, 0.0f,
                                  stream);
  return (int)cudaGetLastError();
}

}  // namespace vsc22
