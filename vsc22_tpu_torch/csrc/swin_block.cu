// B1: one whole SwinV2 res-post-norm block over windows.
//
//   a   = proj(cosine_window_attention(qkv(x)))
//   x1  = T(x + LN1(a))
//   out = T(x1 + LN2(fc2(gelu(fc1(x1)))))
//
// Replaces the Pallas kernel vsc22_tpu/ops/pallas_swin_block.py
// `swin_block_fused` (:387; kernels `_make_kernel` and `_make_kernel_batched`,
// dispatcher `swin_block` :599), with its rounding points (:113-214): q and k
// stay f32 after the QKV product, v is rounded; q̂, k̂, the probabilities and
// the attention output are rounded; proj and fc2 are followed by an f32
// LayerNorm with two-pass statistics over C (eps 1e-6) and an f32 residual
// add, then rounded; the GELU hidden is rounded. GELU is exact, with erff
// (the Pallas kernel's A&S polynomial erf differs by at most 1.5e-7).
//
// What bounds it on the H100: the four dense products, 24*M*C^2 FLOPs for
// M = windows * N tokens (stage 3 of SwinV2-Base at a 128-frame chunk:
// 206 GFLOP of its 223), so the bf16 tensor-core rate; what bounds this
// design is the half of those FLOPs that runs on FFMA (below).
//
// Design: the TPU kernel keeps a group of windows, all weights and every
// intermediate in ~48 MB of VMEM; an SM has 227 KB of shared memory. This
// version is seven launches, and the intermediates make round trips
// through device memory:
//  1. QKV: the product of gemm_nt.cuh with an f32 bias, f32 out [M, 3C];
//  2. the attention core of window_attn.cuh (ROUND_QK) reading q, k, v in
//     place from that [M, 3C] buffer, out [M, C] in T;
//  3. proj: the product + bias, f32 out [M, C];
//  4. ln_residual: x1 = T(x + LN1(proj)), one warp per row;
//  5. fc1: the product + bias + GELU, hidden [M, F] in T;
//  6. fc2: the product + bias, f32 out [M, C];
//  7. ln_residual: out = T(x1 + LN2(fc2)).
// The products, in bf16: proj, fc1 and fc2 take the tensor-core loop
// (`gemm_mma_kernel`) where `gemm_is_mma` allows it (K % 8 == 0,
// 16-byte-aligned operands), else the FFMA tile; QKV takes the 128x128
// FFMA tile (`gemm128_bias_kernel`), whose f32 sums are FMA chains over k
// in order, as the plain version's (cuBLAS's f32 GEMM) are, so that they
// agree bit for bit. Why: the QKV sums are rounded to bf16 as q̂, k̂ and v,
// and each such rounding that goes the other way is carried by every
// later rounding of the block (attention, x1, the hidden, the output)
// into many outputs; the attention core sums P V in order for B1 for the
// same reason (window_attn.cuh). With all four products and P V on tensor
// cores, 6.4840% and 8.8011% of the bf16 outputs at the stage 3 and 4
// shapes differed from the plain version (limit 2%), while each step
// alone moved under 0.05% (scripts/torch_swin_probe.py --steps, NVIDIA
// H100 80GB HBM3, 700.00 W); PERF.md has the shares of this design. f32
// keeps the 64x64 FFMA tile for all four. The attention core takes
// tensor cores at every SwinV2-Base stage (window_attn.cuh).
// Later work: the LNs as GEMM epilogues over whole rows, the hidden kept
// on chip, one launch instead of seven, wgmma with TMA.
#include "window_attn.cuh"

namespace vsc22 {

constexpr int kRowWarps = 8;

// out[m] = T(res[m] + LN(y[m]) * g + b) over rows of C, f32 two-pass stats.
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_residual_kernel(const T* __restrict__ res, const float* __restrict__ y,
                       const float* __restrict__ g, const float* __restrict__ b,
                       T* __restrict__ out, int M, int C, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * kRowWarps + warp;
  if (row >= (size_t)M) return;
  const float* yr = y + row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += yr[c];
  const float mean = warp_sum(s) / (float)C;
  float sq = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = yr[c] - mean;
    sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);
  const T* rr = res + row * C;
  T* orow = out + row * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = from_f32<T>(to_f32(rr[c]) + ((yr[c] - mean) * rstd * g[c] + b[c]));
}

template <typename T>
int launch_ln_residual(const T* res, const float* y, const float* g, const float* b, T* out,
                       int M, int C, cudaStream_t stream) {
  const int blocks = (M + kRowWarps - 1) / kRowWarps;
  ln_residual_kernel<T><<<blocks, kRowWarps * 32, 0, stream>>>(res, y, g, b, out, M, C, 1e-6f);
  return (int)cudaGetLastError();
}

// out = TO(act(A W^T + bias)): the bf16 tensor-core product where
// `gemm_is_mma` allows it, the FFMA tile otherwise.
template <typename T, int ACT, typename TO>
int product(const T* A, const T* W, const float* bias, TO* out, int M, int N, int K,
            cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (gemm_is_mma(K, A, W)) return launch_gemm_mma<ACT, TO>(A, W, bias, out, M, N, K, stream);
  }
  launch_gemm<T, ACT, false, TO>(A, W, bias, nullptr, out, M, N, K, nullptr, nullptr, 0.0f,
                                 stream);
  return (int)cudaGetLastError();
}

// out = A W^T + bias in f32, each sum an FMA chain over k in order, as the
// plain version's f32 product sums: the 128x128 FFMA tile in bf16, the
// 64x64 one in f32.
template <typename T>
int sequential_product(const T* A, const T* W, const float* bias, float* out, int M, int N,
                       int K, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return launch_gemm128_bias<T>(A, W, bias, out, M, N, K, stream);
  launch_gemm<T, kActNone, false, float>(A, W, bias, nullptr, out, M, N, K, nullptr, nullptr,
                                         0.0f, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int swin_block(const void* x_, const void* qkv_w, const float* qkv_b, const void* proj_w,
               const float* proj_b, const float* ln1_s, const float* ln1_b, const void* fc1_w,
               const float* fc1_b, const void* fc2_w, const float* fc2_b, const float* ln2_s,
               const float* ln2_b, const float* rpb, const float* scale, const float* mask,
               float* qkv, void* attn_, float* y, void* x1_, void* hidden_, void* out_, int W,
               int N, int C, int H, int F, int nW, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  T* attn = static_cast<T*>(attn_);
  T* x1 = static_cast<T*>(x1_);
  T* hidden = static_cast<T*>(hidden_);
  T* out = static_cast<T*>(out_);
  const int M = W * N, hd = C / H;
  int rc;

  if ((rc = sequential_product<T>(x, static_cast<const T*>(qkv_w), qkv_b, qkv, M, 3 * C, C,
                                   stream)) != 0)
    return rc;

  const WinLayout in{(long long)N * 3 * C, hd, 3LL * C};
  const WinLayout ol{(long long)N * C, hd, C};
  rc = launch_window_attn<float, T, true>(qkv, qkv + C, qkv + 2 * C, in, attn, ol, rpb, scale,
                                          nW > 1 ? mask : nullptr, W, H, nW, N, hd, stream);
  if (rc != 0) return rc;

  if ((rc = product<T, kActNone, float>(attn, static_cast<const T*>(proj_w), proj_b, y, M, C, C,
                                        stream)) != 0)
    return rc;
  if ((rc = launch_ln_residual<T>(x, y, ln1_s, ln1_b, x1, M, C, stream)) != 0) return rc;

  if ((rc = product<T, kActGelu, T>(x1, static_cast<const T*>(fc1_w), fc1_b, hidden, M, F, C,
                                     stream)) != 0)
    return rc;
  if ((rc = product<T, kActNone, float>(hidden, static_cast<const T*>(fc2_w), fc2_b, y, M, C, F,
                                         stream)) != 0)
    return rc;
  return launch_ln_residual<T>(x1, y, ln2_s, ln2_b, out, M, C, stream);
}

}  // namespace vsc22

// x, out, x1 and attn (scratch): [W*N, C] in the working dtype; qkv_w
// [3C, C], proj_w [C, C], fc1_w [F, C], fc2_w [C, F] in Linear layout (out,
// in), same dtype; biases, LN params, rpb [H, N, N], scale [H] and mask
// [nW, N, N] f32 (mask read only when nW > 1); scratch qkv f32 [W*N, 3C],
// y f32 [W*N, C], hidden [W*N, F] in the working dtype. All contiguous.
extern "C" int vsc22_swin_block(const void* x, const void* qkv_w, const float* qkv_b,
                                const void* proj_w, const float* proj_b, const float* ln1_s,
                                const float* ln1_b, const void* fc1_w, const float* fc1_b,
                                const void* fc2_w, const float* fc2_b, const float* ln2_s,
                                const float* ln2_b, const float* rpb, const float* scale,
                                const float* mask, float* qkv, void* attn, float* y, void* x1,
                                void* hidden, void* out, int W, int N, int C, int H, int F,
                                int nW, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::swin_block<__nv_bfloat16>(x, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, fc1_w,
                                            fc1_b, fc2_w, fc2_b, ln2_s, ln2_b, rpb, scale, mask,
                                            qkv, attn, y, x1, hidden, out, W, N, C, H, F, nW, s);
  return vsc22::swin_block<float>(x, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, fc1_w, fc1_b,
                                  fc2_w, fc2_b, ln2_s, ln2_b, rpb, scale, mask, qkv, attn, y, x1,
                                  hidden, out, W, N, C, H, F, nW, s);
}
