// K2: out = x + fc2(act(fc1(LN(x))))   and   B7: out = fc2(gelu(fc1(x)))
//
// B7 replaces the Pallas kernel vsc22_tpu/ops/pallas_mlp.py `_forward` (its
// pallas_call at :77; dispatcher `fused_mlp` :242): K2 below with exact
// GELU, without the LN and without the residual, the output rounded to the
// working dtype.
//
// K2 replaces the Pallas kernel vsc22_tpu/ops/pallas_mlp.py `_ln_forward`
// (its pallas_call at :155; dispatcher `ln_mlp_residual` :195): LayerNorm
// statistics accumulated in f64 and rounded to f32, LN output rounded to
// the working dtype, hidden and output accumulated in f32, hidden rounded
// to the working dtype after the activation, residual added in f32. act is
// exact GELU (erff; the oracle is `_xla_ln_mlp`, not the TPU kernel's
// polynomial erf) or QuickGELU x * sigmoid(1.702 x).
//
// What bounds them on the H100: two dense products of 2*rows*C*hidden
// FLOPs each (ViT: C=768, hidden=3072; CLIP: C=1024, hidden=4096; SwinV2
// stages: C=128..1024, hidden=4C), so the bf16 tensor-core rate in bf16.
// In f32 K2 runs at the FMA rate (67 TFLOP/s), B7 at the 3xTF32 rate (495
// / 3). At B7's stage-1 width (C 128) the hidden's round trip through
// device memory is most of the bytes, which bound bf16 B7 there.
//
// Design: the TPU kernel kept a row tile's whole hidden (up to 4096 wide,
// f32) in VMEM; 227 KB of shared memory cannot hold that for a useful row
// tile, so the hidden makes one round trip through device memory in the
// working dtype, between two product launches (gemm_nt.cuh). In bf16, where
// `gemm_is_mma` allows it (K % 8 == 0, aligned operands), both products run
// on the tensor-core loop `gemm_mma_kernel`, which streams raw bf16 tiles
// and has no LN prologue, so K2 is three launches:
//  (a) `ln_rows_kernel`: LN(x) rounded to bf16 -> a scratch ln [rows, C],
//      one warp per row, the statistics of `ln_row_stats` (f64, rounded to
//      f32) and `ln_apply`, as the FFMA tile's LN prologue computes them;
//  (b) fc1 + b1 + activation on the mma loop -> hidden [rows, hidden];
//  (c) fc2 + b2 + the f32 residual x on the mma loop -> out [rows, C].
// Both sums feed one rounding each: fc1's the hidden, after which no LN
// follows inside K2; fc2's the output, after the f32 residual (B1's fc2
// holds the bf16 bar on the same loop). Otherwise (f32, or a bf16 product
// off the rule) a K2 product keeps the 64x64 FFMA tile, with LN fused into
// fc1's A-tile load (per-block two-pass row stats).
// B7 is fc1 + b1 + GELU -> hidden, then fc2 + b2 -> out, each on the loop
// `mlp_product` picks:
//  - bf16: `gemm_mma_kernel` by `gemm_is_mma` (K2's fc1 instance; fc2
//    without a residual), each sum feeding one rounding, as K2's.
//  - f32: `gemm_tf32x3_kernel` by `gemm_is_tf32x3` (K % 4 == 0, aligned
//    operands), after `split_tf32_kernel` has split W into its tf32 big
//    and small parts in the wrapper's scratch: 3xTF32 on wgmma, about f32
//    accuracy, bound by three tf32 products per f32 one where the FFMA
//    tile is bound by 67 TFLOP/s (gemm_nt.cuh has its design). Only B7
//    takes that loop: the f32 products of K1, K2, B1, B9 and B10 keep
//    their FFMA sums, pinned bit for bit.
//  - off both rules: the 64x64 FFMA tile.
// Fusing the LN into an ldmatrix-fed tile and keeping the hidden on chip
// are later work. Any C, hidden and rows are taken: ragged tiles are
// masked.
#include "ln_mlp.cuh"

namespace vsc22 {

template <typename T>
int ln_mlp_residual(const void* x, const float* ln_g, const float* ln_b, const void* w1,
                    const float* b1, const void* w2, const float* b2, void* ln, void* hidden,
                    void* out, int M, int C, int Hd, int act, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* w1t = static_cast<const T*>(w1);
  T* lt = static_cast<T*>(ln);
  T* ht = static_cast<T*>(hidden);
  const int rc =
      act == kActQuickGelu
          ? ln_fc1<T, kActQuickGelu>(xt, ln_g, ln_b, w1t, b1, lt, ht, M, C, Hd, eps, stream)
          : ln_fc1<T, kActGelu>(xt, ln_g, ln_b, w1t, b1, lt, ht, M, C, Hd, eps, stream);
  if (rc != 0) return rc;
  return fc2_residual<T>(ht, static_cast<const T*>(w2), b2, xt, static_cast<T*>(out), M, C, Hd,
                         stream);
}

// big, small = W split (`split_tf32_fast`), four elements a thread (n %
// 4 == 0, all 16-byte aligned): the 3xTF32 loop's W operands, made once
// per product since every row-block reads the same W.
__global__ void split_tf32_kernel(const uint4* __restrict__ w, uint4* __restrict__ big,
                                  uint4* __restrict__ small, size_t n4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint4 v = w[i];
    uint4 b, s;
    split_tf32_fast(v.x, b.x, s.x);
    split_tf32_fast(v.y, b.y, s.y);
    split_tf32_fast(v.z, b.z, s.z);
    split_tf32_fast(v.w, b.w, s.w);
    big[i] = b;
    small[i] = s;
  }
}

// One product of B7, out = T(act(A W^T + bias)), on the loop its route
// names (ops/mlp.py `fused_mlp_routes`): bf16 tensor cores, f32 3xTF32
// tensor cores (W split into `wsplit`, 2 N K floats, first), else the
// 64x64 FFMA tile.
template <typename T, int ACT>
int mlp_product(const T* a, const T* w, const float* bias, T* out, int M, int N, int K,
                float* wsplit, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (gemm_is_mma(K, a, w)) return launch_gemm_mma<ACT, T>(a, w, bias, out, M, N, K, stream);
  } else {
    if (gemm_is_tf32x3(K, a, w)) {
      const size_t n4 = (size_t)N * K / 4;
      uint4* big = reinterpret_cast<uint4*>(wsplit);
      const int blocks = (int)((n4 + 255) / 256 < 1056 ? (n4 + 255) / 256 : 1056);
      split_tf32_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const uint4*>(w), big,
                                                    big + n4, n4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      return launch_gemm_tf32x3<ACT>(a, wsplit, wsplit + 4 * n4, bias, out, M, N, K, stream);
    }
  }
  launch_gemm<T, ACT, false>(a, w, bias, nullptr, out, M, N, K, nullptr, nullptr, 0.0f, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int fused_mlp(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
              void* hidden, void* out, float* wsplit, int M, int C, int Hd,
              cudaStream_t stream) {
  T* ht = static_cast<T*>(hidden);
  const int rc = mlp_product<T, kActGelu>(static_cast<const T*>(x), static_cast<const T*>(w1),
                                          b1, ht, M, Hd, C, wsplit, stream);
  if (rc != 0) return rc;
  return mlp_product<T, kActNone>(ht, static_cast<const T*>(w2), b2, static_cast<T*>(out), M, C,
                                  Hd, wsplit, stream);
}

}  // namespace vsc22

// x, out: [M, C]; w1: [Hd, C] and w2: [C, Hd] in Linear layout (out, in);
// ln_g, ln_b, b1, b2: f32; ln: scratch [M, C] (bf16; unused in f32);
// hidden: scratch [M, Hd]. act: 1 GELU, 2 QuickGELU.
extern "C" int vsc22_ln_mlp_residual(const void* x, const float* ln_g, const float* ln_b,
                                     const void* w1, const float* b1, const void* w2,
                                     const float* b2, void* ln, void* hidden, void* out, int M,
                                     int C, int Hd, int act, float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::ln_mlp_residual<__nv_bfloat16>(x, ln_g, ln_b, w1, b1, w2, b2, ln, hidden, out,
                                                 M, C, Hd, act, eps, s);
  return vsc22::ln_mlp_residual<float>(x, ln_g, ln_b, w1, b1, w2, b2, ln, hidden, out, M, C, Hd,
                                       act, eps, s);
}

// K2's LN-rows kernel alone: out = T(LN(x)) over rows of C. x, out [M, C];
// g, b f32 [C].
extern "C" int vsc22_ln_rows(const void* x, const float* g, const float* b, void* out, int M,
                             int C, float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::launch_ln_rows(static_cast<const __nv_bfloat16*>(x), g, b,
                                 static_cast<__nv_bfloat16*>(out), M, C, eps, s);
  return vsc22::launch_ln_rows(static_cast<const float*>(x), g, b, static_cast<float*>(out), M, C,
                               eps, s);
}

// B7. x, out: [M, C]; w1: [Hd, C] and w2: [C, Hd] in Linear layout; b1, b2:
// f32; hidden: scratch [M, Hd]; wsplit: f32 scratch of 2 Hd C floats for
// the 3xTF32 route's split of w1, then of w2 (unused in bf16).
extern "C" int vsc22_fused_mlp(const void* x, const void* w1, const float* b1, const void* w2,
                               const float* b2, void* hidden, void* out, float* wsplit, int M,
                               int C, int Hd, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::fused_mlp<__nv_bfloat16>(x, w1, b1, w2, b2, hidden, out, wsplit, M, C, Hd, s);
  return vsc22::fused_mlp<float>(x, w1, b1, w2, b2, hidden, out, wsplit, M, C, Hd, s);
}
