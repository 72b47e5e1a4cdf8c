// K2: out = x + fc2(act(fc1(LN(x))))   and   B7: out = fc2(gelu(fc1(x)))
//
// B7 replaces the Pallas kernel vsc22_tpu/ops/pallas_mlp.py `_forward` (its
// pallas_call at :77; dispatcher `fused_mlp` :242): K2 below with exact
// GELU, without the LN and without the residual, the output rounded to the
// working dtype. It is the same two launches of the shared GEMM, and bound
// the same way.
//
// K2 replaces the Pallas kernel vsc22_tpu/ops/pallas_mlp.py `_ln_forward`
// (its pallas_call at :155; dispatcher `ln_mlp_residual` :195): LayerNorm
// statistics accumulated in f64 and rounded to f32, LN output rounded to
// the working dtype, hidden and output accumulated in f32, hidden rounded
// to the working dtype after the activation, residual added in f32. act is exact GELU (erff; the oracle
// is `_xla_ln_mlp`, not the TPU kernel's polynomial erf) or QuickGELU
// x * sigmoid(1.702 x).
//
// What bounds it on the H100: two dense products of 2*rows*C*hidden FLOPs
// each (ViT: C=768, hidden=3072; CLIP: C=1024, hidden=4096). In this
// version they run on CUDA cores with FFMA, so FMA throughput bounds it, not
// memory.
//
// Design: the TPU kernel kept a row tile's whole hidden (up to 4096 wide,
// f32) in VMEM; 227 KB of shared memory cannot hold that for a useful row
// tile, so this first version is two launches of the shared tiled GEMM
// (gemm_nt.cuh) and the hidden makes one round trip through device memory
// in the working dtype:
//  (a) LN fused into the A-tile load (per-block two-pass row stats)
//      + fc1 + b1 + activation -> hidden [rows, hidden];
//  (b) fc2 + b2 + f32 residual -> out [rows, C].
// Keeping the hidden on chip (split-K over hidden tiles with the fc2
// accumulator in registers) is later work. Any C, hidden and rows are
// taken: ragged tiles are masked.
#include "gemm_nt.cuh"

namespace vsc22 {

template <typename T>
int ln_mlp_residual(const void* x, const float* ln_g, const float* ln_b, const void* w1,
                    const float* b1, const void* w2, const float* b2, void* hidden, void* out,
                    int M, int C, int Hd, int act, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ht = static_cast<T*>(hidden);
  if (act == kActQuickGelu)
    launch_gemm<T, kActQuickGelu, true>(xt, static_cast<const T*>(w1), b1, nullptr, ht, M, Hd,
                                        C, ln_g, ln_b, eps, stream);
  else
    launch_gemm<T, kActGelu, true>(xt, static_cast<const T*>(w1), b1, nullptr, ht, M, Hd, C,
                                   ln_g, ln_b, eps, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_gemm<T, kActNone, false>(ht, static_cast<const T*>(w2), b2, xt, static_cast<T*>(out),
                                  M, C, Hd, nullptr, nullptr, 0.0f, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_mlp(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
              void* hidden, void* out, int M, int C, int Hd, cudaStream_t stream) {
  T* ht = static_cast<T*>(hidden);
  launch_gemm<T, kActGelu, false>(static_cast<const T*>(x), static_cast<const T*>(w1), b1,
                                  nullptr, ht, M, Hd, C, nullptr, nullptr, 0.0f, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_gemm<T, kActNone, false>(ht, static_cast<const T*>(w2), b2, nullptr,
                                  static_cast<T*>(out), M, C, Hd, nullptr, nullptr, 0.0f, stream);
  return (int)cudaGetLastError();
}

}  // namespace vsc22

// x, out: [M, C]; w1: [Hd, C] and w2: [C, Hd] in Linear layout (out, in);
// ln_g, ln_b, b1, b2: f32; hidden: scratch [M, Hd]. act: 1 GELU, 2 QuickGELU.
extern "C" int vsc22_ln_mlp_residual(const void* x, const float* ln_g, const float* ln_b,
                                     const void* w1, const float* b1, const void* w2,
                                     const float* b2, void* hidden, void* out, int M, int C,
                                     int Hd, int act, float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::ln_mlp_residual<__nv_bfloat16>(x, ln_g, ln_b, w1, b1, w2, b2, hidden, out, M,
                                                 C, Hd, act, eps, s);
  return vsc22::ln_mlp_residual<float>(x, ln_g, ln_b, w1, b1, w2, b2, hidden, out, M, C, Hd,
                                       act, eps, s);
}

// B7. x, out: [M, C]; w1: [Hd, C] and w2: [C, Hd] in Linear layout; b1, b2:
// f32; hidden: scratch [M, Hd].
extern "C" int vsc22_fused_mlp(const void* x, const void* w1, const float* b1, const void* w2,
                               const float* b2, void* hidden, void* out, int M, int C, int Hd,
                               int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::fused_mlp<__nv_bfloat16>(x, w1, b1, w2, b2, hidden, out, M, C, Hd, s);
  return vsc22::fused_mlp<float>(x, w1, b1, w2, b2, hidden, out, M, C, Hd, s);
}
