// Shared building blocks of the port's hand-written Hopper kernels.
//
// `mainloop` is a tiled "NT" product, C[m][n] = sum_k A[m][k] * B[n][k],
// with both operands K-contiguous: activations [rows, K] and weights in
// PyTorch's Linear layout [out, in]. A block of 256 threads owns a 64x64
// output tile, stages 16-deep K slices of both operands in shared memory
// as f32, and each thread accumulates a 4x4 micro-tile in f32 registers
// with FFMA. Operands are read through loader functors, so a prologue
// (LayerNorm, f16 rounding) is fused into the tile load. Ragged M, N and K
// are masked with zero fill.
//
// `mainloop128` is the same product over a 128x128 tile with an 8x8
// micro-tile per thread, for plain row-major operands: about 1.9x the
// FFMA rate of `mainloop` on the H100 (B5 runs on it; `mainloop`'s users
// are to move to it).
//
// Both are CUDA-core FFMA loops, exact f32 products, no cp.async/TMA
// pipelining.
//
// `gemm128_bias_kernel` puts an epilogue on `mainloop128` (f32 bias,
// optional bf16 residual added in f32, optional scale of the first
// columns, output in bf16 or f32); the bf16 products whose f32 sums must
// keep the plain version's order take it: B1's QKV (swin_block.cu), B9's
// QKV (attn_proj.cu), B10's QKV with q's scale and its proj with the
// residual (vit_block.cu).
//
// `gemm_mma_kernel` is the same NT product for bf16 operands on the tensor
// cores, with the epilogues of `gemm_bias_act_kernel` (f32 bias, optional
// activation, optional bf16 residual added in f32, output in bf16 or f32).
// B1's proj, fc1 and fc2 (swin_block.cu), K1's projection (attn_proj.cu,
// and so B9's), K2's fc1 and fc2 (ln_mlp.cu, and so B10's) and B7's bf16
// fc1 and fc2 launch it, by the rule of `gemm_is_mma` (mirrored in
// ops/gemm.py `gemm_route`): bf16, K % 8 == 0 and 16-byte-aligned A and W.
// Every other bf16 shape and every f32 product but B7's keep `mainloop`.
// B7's f32 products take `gemm_tf32x3_kernel` (below, after the bf16
// loop) by the rule of `gemm_is_tf32x3`. Design: a 128x128 block
// tile over 8 warps (2 x 4, each 64 x 32), K in 32-deep slices through a
// ring of 3 shared-memory stages filled by 16-byte cp.async (ragged M, N
// and K zero-filled: no byte is read there), rows at a pitch of 40 bf16
// so that ldmatrix is free of bank conflicts, mma.sync m16n8k16 with f32
// accumulators. As in attn_core.cuh, each mma starts from zero and its
// 16-term partial sum joins the f32 sums by a round-to-nearest add: the
// tensor core's own accumulate does not round to nearest, and chained
// over K it drifts from the plain version's f32 sums (B1's x1 is rounded
// inside the block and feeds LN2, as B10's is, PERF.md). wgmma with a TMA
// ring is later work.
//
// Its loop is `mma_nt_tile<T>`, one 128x128 tile into accumulator
// fragments, for bf16 or f16 operands. The retrieval kernels run it in f16
// with epilogues of their own that reduce each row on the fly: B5's top-e
// per block (extract_topk.cu) and K3's row max (row_max.cu). f16 x f16
// products are exact in f32, so with the round-to-nearest add above their
// sums differ from an f32 FFMA chain's only by the order of the adds.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace vsc22 {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output cols per block
constexpr int kBK = 16;       // K slice staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4x4 outputs each
constexpr int kPad = 4;       // smem row padding against bank conflicts

enum DType { kF32 = 0, kBF16 = 1 };
enum Act { kActNone = 0, kActGelu = 1, kActQuickGelu = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Round an f32 value to T and back: where the JAX code casts to the
// working dtype mid-computation.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int ACT> __device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == kActGelu) {
    return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
  } else if constexpr (ACT == kActQuickGelu) {
    return v * (1.0f / (1.0f + expf(-1.702f * v)));
  } else {
    return v;
  }
}

// Plain row-major operand [rows, k_dim].
template <typename T> struct RowLoader {
  const T* p;
  int k_dim;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return to_f32(p[(size_t)r * k_dim + k]);
  }
};

// The LayerNorm statistics of one row of K elements, by one warp: the mean
// and the two-pass variance accumulated in f64 and rounded to f32 (so they
// are the correctly rounded values, whatever the summation order; the
// plain versions compute them so too), rstd = rsqrtf(var + eps). Every
// lane gets both.
template <typename T>
__device__ __forceinline__ void ln_row_stats(const T* __restrict__ row, int K, float eps,
                                             int lane, float& mean, float& rstd) {
  double sum = 0.0;
  for (int k = lane; k < K; k += 32) sum += (double)to_f32(row[k]);
  mean = (float)(warp_sum(sum) / K);
  double sq = 0.0;
  for (int k = lane; k < K; k += 32) {
    const double d = (double)(to_f32(row[k]) - mean);
    sq += d * d;
  }
  const float var = (float)(warp_sum(sq) / K);
  rstd = rsqrtf(var + eps);
}

// ((v - mean) * rstd) * g + b with one f32 rounding per operation (no
// contraction), as the plain versions' separate tensor operations round.
__device__ __forceinline__ float ln_apply(float v, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(v - mean, rstd), g), b);
}

// LayerNorm(x) rounded to T, from per-row statistics held in shared memory
// for the block's rows m0 .. m0 + kBM.
template <typename T> struct LnLoader {
  const T* x;
  int k_dim, m0;
  const float *mean, *rstd, *g, *b;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const float v = to_f32(x[(size_t)r * k_dim + k]);
    return round_to<T>(ln_apply(v, mean[r - m0], rstd[r - m0], g[k], b[k]));
  }
};

struct TileSmem {
  float a[kBK][kBM + kPad];
  float b[kBK][kBN + kPad];
};

// acc[i][j] accumulates C[m0 + ty + 16 i][n0 + tx + 16 j],
// tx = threadIdx.x % 16, ty = threadIdx.x / 16.
template <typename LA, typename LB>
__device__ __forceinline__ void mainloop(const LA& la, const LB& lb, int m0, int n0, int M,
                                         int N, int K, TileSmem& s, float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / kBK, kk = e % kBK;
      const int gk = k0 + kk;
      const int gm = m0 + row, gn = n0 + row;
      s.a[kk][row] = (gm < M && gk < K) ? la(gm, gk) : 0.0f;
      s.b[kk][row] = (gn < N && gk < K) ? lb(gn, gk) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// --- the 128x128 tile --------------------------------------------------------
//
// 256 threads, each accumulating an 8x8 micro-tile in f32 registers from
// f32 slices staged 8 deep in two shared buffers: one barrier per slice,
// and 128-bit shared loads (64 FFMA per 4 loads, where `mainloop` has 16
// per 8). Each thread fetches 4 consecutive K of one row of each operand
// per slice, in one 8- or 16-byte load where K % 4 == 0 and the base is
// aligned. Ragged M, N and K are zero-filled.

constexpr int kT128 = 128;     // output rows and cols of the tile
constexpr int kT128Depth = 8;  // K slice staged per step

struct Tile128Smem {
  float a[2][kT128Depth][kT128 + kPad];  // A slice, k-major
  float b[2][kT128Depth][kT128 + kPad];  // B slice, k-major
};

// The tile row (or column) that accumulator index i of thread coordinate
// t holds: 4t .. 4t + 3, then 64 + 4t .. 64 + 4t + 3.
__device__ __forceinline__ int tile128_index(int t, int i) {
  return (i < 4 ? 4 * t : 64 + 4 * t - 4) + i;
}

// Four consecutive elements as f32: one 8- or 16-byte load.
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  v[0] = raw.x;
  v[1] = raw.y;
  v[2] = raw.z;
  v[3] = raw.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// Row `row` (< rows), k .. k + 3 of a [rows, K] operand, zero past K. With
// K % 4 == 0 and an aligned base every such group is aligned and whole, and
// takes one load.
template <typename T>
__device__ __forceinline__ void load_row4(const T* __restrict__ p, int row, int rows, int k,
                                          int K, float (&v)[4]) {
  const bool whole = K % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  if (whole && row < rows && k < K) {
    load4(p + (size_t)row * K + k, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = (row < rows && k + i < K) ? to_f32(p[(size_t)row * K + k + i]) : 0.0f;
  }
}

// Thread t loads 4 consecutive k of row t / 2 of both operands' slices.
template <typename T>
__device__ __forceinline__ void load_slice128(const T* __restrict__ a, const T* __restrict__ b,
                                              int m0, int n0, int k0, int M, int N, int K,
                                              float (&ra)[4], float (&rb)[4]) {
  const int row = threadIdx.x / 2, k = k0 + (threadIdx.x % 2) * 4;
  load_row4(a, m0 + row, M, k, K, ra);
  load_row4(b, n0 + row, N, k, K, rb);
}

__device__ __forceinline__ void store_slice128(Tile128Smem& s, int buf, const float (&ra)[4],
                                               const float (&rb)[4]) {
  const int row = threadIdx.x / 2, k = (threadIdx.x % 2) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.a[buf][k + i][row] = ra[i];
    s.b[buf][k + i][row] = rb[i];
  }
}

// acc[i][j] accumulates C[m0 + tile128_index(ty, i)][n0 + tile128_index(tx, j)],
// tx = threadIdx.x % 16, ty = threadIdx.x / 16, for row-major A [M, K] and
// B [N, K] (f32 or f16), K >= 1. Ends past a barrier, so `s` may be reused.
template <typename T>
__device__ __forceinline__ void mainloop128(const T* __restrict__ a, const T* __restrict__ b,
                                            int m0, int n0, int M, int N, int K,
                                            Tile128Smem& s, float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float ra[4], rb[4];
  load_slice128(a, b, m0, n0, 0, M, N, K, ra, rb);
  store_slice128(s, 0, ra, rb);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kT128Depth) {
    const bool more = k0 + kT128Depth < K;
    if (more) load_slice128(a, b, m0, n0, k0 + kT128Depth, M, N, K, ra, rb);
#pragma unroll
    for (int kk = 0; kk < kT128Depth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[buf][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) store_slice128(s, buf ^ 1, ra, rb);
    __syncthreads();
    buf ^= 1;
  }
}

// out[m][n] = TO( res[m][n] + act(sum_k A'[m][k] W[n][k] + bias[n]) ), where
// A' is A, or LayerNorm(A) rounded to T when LN (`ln_row_stats`, then
// LnLoader). The residual
// is optional (res == nullptr). The output type TO is T, or float where a
// caller keeps the f32 sum for an epilogue of its own. Columns n <
// scaled_cols are multiplied by col_scale in f32 before the rounding (B10
// folds the softmax scale into q there).
template <typename T, int ACT, bool LN, typename TO = T>
__global__ void __launch_bounds__(kThreads)
    gemm_bias_act_kernel(const T* __restrict__ A, const T* __restrict__ W,
                         const float* __restrict__ bias, const TO* __restrict__ res,
                         TO* __restrict__ out, int M, int N, int K,
                         const float* __restrict__ ln_g, const float* __restrict__ ln_b,
                         float eps, int scaled_cols, float col_scale) {
  __shared__ TileSmem s;
  __shared__ float mean_s[kBM], rstd_s[kBM];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4];
  RowLoader<T> lw{W, K};
  if constexpr (LN) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kBM; r += kThreads / 32) {
      const int gm = m0 + r;
      float mean = 0.0f, rstd = 0.0f;
      if (gm < M) ln_row_stats(A + (size_t)gm * K, K, eps, lane, mean, rstd);
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    }
    __syncthreads();
    LnLoader<T> la{A, K, m0, mean_s, rstd_s, ln_g, ln_b};
    mainloop(la, lw, m0, n0, M, N, K, s, acc);
  } else {
    RowLoader<T> la{A, K};
    mainloop(la, lw, m0, n0, M, N, K, s, acc);
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = activate<ACT>(acc[i][j] + bias[n]);
      if (n < scaled_cols) v *= col_scale;
      const size_t o = (size_t)m * N + n;
      if (res != nullptr) v = to_f32(res[o]) + v;
      out[o] = from_f32<TO>(v);
    }
  }
}

// The residual's type is taken from `out` (res may be nullptr).
template <typename X> struct same_type { using type = X; };

template <typename T, int ACT, bool LN, typename TO = T>
inline void launch_gemm(const T* A, const T* W, const float* bias,
                        const typename same_type<TO>::type* res, TO* out,
                        int M, int N, int K, const float* ln_g, const float* ln_b, float eps,
                        cudaStream_t stream, int scaled_cols = 0, float col_scale = 1.0f) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  gemm_bias_act_kernel<T, ACT, LN, TO><<<grid, kThreads, 0, stream>>>(
      A, W, bias, res, out, M, N, K, ln_g, ln_b, eps, scaled_cols, col_scale);
}

// out[m][n] = TO(res[m][n] + (sum_k A[m][k] W[n][k] + bias[n]) * s) on
// `mainloop128`, each sum an FMA chain over k in order from 0, as the
// plain version's f32 product sums, then one f32 rounding per operation as
// in `gemm_bias_act_kernel`. The residual is added under RES only; s is
// col_scale for the columns n < scaled_cols under QSCALE (B10 folds the
// softmax scale into q there), else the step is left out. B1's QKV (f32
// out), B9's and B10's QKV and B10's proj (bf16 out) take it.
template <typename T, typename TO = float, bool RES = false, bool QSCALE = false>
__global__ void __launch_bounds__(kThreads)
    gemm128_bias_kernel(const T* __restrict__ A, const T* __restrict__ W,
                        const float* __restrict__ bias, TO* __restrict__ out, int M, int N,
                        int K, const T* __restrict__ res, int scaled_cols, float col_scale) {
  __shared__ Tile128Smem s;
  const int m0 = blockIdx.x * kT128, n0 = blockIdx.y * kT128;
  float acc[8][8];
  mainloop128(A, W, m0, n0, M, N, K, s, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tile128_index(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile128_index(tx, j);
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      float v = acc[i][j] + bias[n];
      if constexpr (QSCALE) {
        if (n < scaled_cols) v *= col_scale;
      }
      if constexpr (RES) v = to_f32(res[o]) + v;
      out[o] = from_f32<TO>(v);
    }
  }
}

// `res` is read only with RES (then [M, N], row-major), the scale only with
// QSCALE.
template <typename T, typename TO = float, bool RES = false, bool QSCALE = false>
inline int launch_gemm128_bias(const T* A, const T* W, const float* bias, TO* out, int M, int N,
                               int K, cudaStream_t stream, const T* res = nullptr,
                               int scaled_cols = 0, float col_scale = 1.0f) {
  const dim3 grid((M + kT128 - 1) / kT128, (N + kT128 - 1) / kT128);
  gemm128_bias_kernel<T, TO, RES, QSCALE><<<grid, kThreads, 0, stream>>>(
      A, W, bias, out, M, N, K, res, scaled_cols, col_scale);
  return (int)cudaGetLastError();
}

// ---- the bf16 tensor-core product ------------------------------------------

constexpr int kMmaBM = 128;      // output rows per block
constexpr int kMmaBN = 128;      // output cols per block
constexpr int kMmaBK = 32;       // K slice per stage
constexpr int kMmaStages = 3;    // cp.async ring depth
constexpr int kMmaPitch = kMmaBK + 8;  // smem row pitch, bf16 elements (80 bytes)
constexpr int kMmaThreads = 256;
constexpr size_t kGemmMmaSmem =
    (size_t)kMmaStages * (kMmaBM + kMmaBN) * kMmaPitch * sizeof(__nv_bfloat16);

// Which product a bf16 launch takes (ops/gemm.py `gemm_route`).
inline bool gemm_is_mma(int K, const void* a, const void* w) {
  return K % 8 == 0 && aligned16(a) && aligned16(w);
}

// One stage: rows m0.. of A and n0.. of W, k0 .. k0 + 32, as 16-byte
// chunks (K % 8 == 0, so a chunk is all inside K or all outside).
template <typename T>
__device__ __forceinline__ void gemm_mma_load(T* sa, T* sb, const T* __restrict__ A,
                                              const T* __restrict__ W, int m0, int n0, int k0,
                                              int M, int N, int K) {
#pragma unroll
  for (int e = threadIdx.x; e < kMmaBM * kMmaBK / 8; e += kMmaThreads) {
    const int r = e / (kMmaBK / 8), c = (e % (kMmaBK / 8)) * 8;
    const int gk = k0 + c;
    const bool a_in = gk < K && m0 + r < M;
    const bool b_in = gk < K && n0 + r < N;
    cp_async16_zfill(sa + r * kMmaPitch + c, a_in ? A + (size_t)(m0 + r) * K + gk : A, a_in);
    cp_async16_zfill(sb + r * kMmaPitch + c, b_in ? W + (size_t)(n0 + r) * K + gk : W, b_in);
  }
}

// acc = the 128x128 tile at (m0, n0) of sum_k A[m][k] W[n][k], for A [M, K]
// and W [N, K] of T (bf16 or f16), row-major, 16-byte aligned, K % 8 == 0;
// rows past M or N are zero-filled and never read. `ring` is the block's
// kGemmMmaSmem bytes. Warp w holds rows (w / 4) * 64 .. + 64 and columns
// (w % 4) * 32 .. + 32 of the tile: acc[mt][nt] is the m16n8 accumulator
// tile at row offset mt * 16 and column offset nt * 8 (mma.cuh's fragment
// layout). Ends past a barrier, so `ring` may be reused at once.
template <typename T>
__device__ __forceinline__ void mma_nt_tile(const T* __restrict__ A, const T* __restrict__ W,
                                            int m0, int n0, int M, int N, int K, T* ring,
                                            float (&acc)[4][4][4]) {
  T* sa = ring;                                          // [stages][BM][pitch]
  T* sb = ring + (size_t)kMmaStages * kMmaBM * kMmaPitch;  // [stages][BN][pitch]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int ktiles = (K + kMmaBK - 1) / kMmaBK;

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < ktiles)
      gemm_mma_load(sa + (size_t)st * kMmaBM * kMmaPitch, sb + (size_t)st * kMmaBN * kMmaPitch,
                    A, W, m0, n0, st * kMmaBK, M, N, K);
    cp_async_commit();
  }
  // ldmatrix rows: A (rows 0-15, k 0-7 | 8-15) -> a0..a3 of an m16 tile;
  // W (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
  // -> b0, b1 of two n8 tiles.
  const int mi = lane >> 3;
  const int a_off = (wm + (lane & 15)) * kMmaPitch + (lane >> 4) * 8;
  const int b_off = (wn + (mi >> 1) * 8 + (lane & 7)) * kMmaPitch + (mi & 1) * 8;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is read out
    const int next = kt + kMmaStages - 1;
    if (next < ktiles) {
      const int st = next % kMmaStages;
      gemm_mma_load(sa + (size_t)st * kMmaBM * kMmaPitch, sb + (size_t)st * kMmaBN * kMmaPitch,
                    A, W, m0, n0, next * kMmaBK, M, N, K);
    }
    cp_async_commit();
    const T* a = sa + (size_t)(kt % kMmaStages) * kMmaBM * kMmaPitch + a_off;
    const T* b = sb + (size_t)(kt % kMmaStages) * kMmaBN * kMmaPitch + b_off;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(af[mt], a + mt * 16 * kMmaPitch + kk * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldmatrix_x4(bfr[np], b + np * 16 * kMmaPitch + kk * 16);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float t[4] = {};
          mma_16x8x16(t, af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1],
                      T{});
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], t[i]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// out[m][n] = TO(act(sum_k A[m][k] W[n][k] + bias[n])), A [M, K] and W
// [N, K] bf16, row-major, 16-byte aligned, K % 8 == 0. With RES, the bf16
// residual res[m][n] is added in f32 before the rounding to TO, as in
// `gemm_bias_act_kernel`: out = TO(res + act(sum + bias)).
template <int ACT, typename TO, bool RES = false>
__global__ void __launch_bounds__(kMmaThreads)
    gemm_mma_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                    TO* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.x * kMmaBM, n0 = blockIdx.y * kMmaBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  float acc[4][4][4];
  mma_nt_tile(A, W, m0, n0, M, N, K, reinterpret_cast<__nv_bfloat16*>(smem_raw), acc);

  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int n = n0 + wn + nt * 8 + c2 + u;
          if (n >= N) continue;
          const size_t o = (size_t)m * N + n;
          float v = activate<ACT>(acc[mt][nt][2 * half + u] + bias[n]);
          if constexpr (RES) v = to_f32(res[o]) + v;
          out[o] = from_f32<TO>(v);
        }
    }
}

// `res` is read only with RES (then [M, N] bf16, row-major).
template <int ACT, typename TO, bool RES = false>
inline int launch_gemm_mma(const __nv_bfloat16* A, const __nv_bfloat16* W, const float* bias,
                           TO* out, int M, int N, int K, cudaStream_t stream,
                           const __nv_bfloat16* res = nullptr) {
  auto kernel = gemm_mma_kernel<ACT, TO, RES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGemmMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kMmaBM - 1) / kMmaBM, (N + kMmaBN - 1) / kMmaBN);
  kernel<<<grid, kMmaThreads, kGemmMmaSmem, stream>>>(A, W, bias, res, out, M, N, K);
  return (int)cudaGetLastError();
}

// ---- the f32 3xTF32 tensor-core product (B7) ---------------------------------
//
// An f32 NT product on the tensor cores at about f32 accuracy ("3xTF32"):
// each operand element x = big + small (`split_tf32_fast`), and each 8-deep
// step of the sum runs small*big, big*small and big*big as tf32 products;
// the dropped small*small is below 2^-22 of a product. The twelve products
// of a 32-deep slice chain into a partial that starts from zero, and the
// partial joins the f32 sum by a round-to-nearest add: the tensor core's
// own accumulate does not round to nearest, and chained over all of K it
// drifts (1.3e-4 against 1.1e-5 at B7's stage 4, PERF.md).
//
// What bounds it: three tf32 products per f32 one, so 495 / 3 TFLOP/s.
// mma.sync reaches about 320 TFLOP/s in tf32 on the H100 and a tile of it
// ran B7 at stage 4 in 2.4 ms; wgmma reaches about 470 (PERF.md).
// So this tile is wgmma's: two warpgroups, each 64 rows x 128 columns of
// the 128x128 block tile, wgmma.m64n128k8.tf32 with A's fragments in
// registers and W's in shared memory. Each wgmma reads its W tile from
// shared memory, 96 KB a 32-deep slice for the block's 24, so shared
// memory's bandwidth is what the rest of the loop competes for:
//  - W is split once per call into big and small operands in device
//    memory (ln_mlp.cu `split_tf32_kernel`; every row-block reads the same
//    W), and each slice of both lands by 16-byte cp.async in wgmma's
//    K-major 128-byte swizzle (`wgmma_desc_sw128`): no thread reads or
//    writes W in shared memory.
//  - A's slice lands raw by cp.async, rows at a pitch of 36 floats (144
//    bytes); each warp reads its 16 rows with ldmatrix.x4 (on f32 data it
//    hands each lane the element (row g, column t) of four 8x4 matrices:
//    the tf32 m16n8k8 A fragment, which is wgmma's register A layout;
//    eight rows 144 bytes apart fall on distinct banks) and splits them in
//    registers.
//  - A ring of 4 stages; a warp cannot queue more than about one wgmma
//    ahead, so the next slice's A fragments are loaded between this
//    slice's k8 steps, while their wgmmas run.
// Ragged M, N and K are zero-filled, so K % 4 == 0 and 16-byte-aligned
// operands (`gemm_is_tf32x3`). 128 accumulators a thread (sum and partial)
// hold one block per SM. The grid walks N fastest, so the blocks in flight
// share A rows and read W (16 MB at most for B7) from L2.

constexpr int kX3BM = 128;           // output rows per block (two warpgroups)
constexpr int kX3BN = 128;           // output cols per block
constexpr int kX3BK = 32;            // K slice per stage, f32 (one 128-byte row)
constexpr int kX3Stages = 4;         // cp.async ring depth
constexpr int kX3Pitch = kX3BK + 4;  // A's smem row pitch, f32 (144 bytes)
constexpr int kX3Threads = 256;
constexpr int kX3WPart = kX3BN * kX3BK;      // floats of W's big (or small) slice
constexpr int kX3ARaw = kX3BM * kX3Pitch;    // floats of A's raw slice
constexpr int kX3Stage = 2 * kX3WPart + kX3ARaw;  // W big, W small, A: 50 KB
constexpr size_t kGemmX3Smem = (size_t)kX3Stages * kX3Stage * sizeof(float) + 1024;

// Which loop an f32 product of B7 takes (ops/gemm.py `gemm_route` with
// tf32x3=True): this one, else `mainloop`.
inline bool gemm_is_tf32x3(int K, const void* a, const void* w) {
  return K % 4 == 0 && aligned16(a) && aligned16(w);
}

// x = big + small, from x's f32 bits: big is x rounded to tf32 (to
// nearest, ties away from zero, as cvt.rna gives it for finite x) by an
// integer add and mask; small = x - big exactly, |small| <= 2^-11 |x|,
// handed to the tensor core as it stands: it reads the top 19 bits, a
// truncation within 2^-10 |small|. (CUTLASS's fast 3xTF32 splits so.)
__device__ __forceinline__ void split_tf32_fast(uint32_t x, uint32_t& big, uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
}

// One slice of the ring: A's rows m0 .. m0 + 127 raw at kX3Pitch, and W's
// big and small rows n0 .. n0 + 127 in the 128-byte swizzle (row n's
// 16-byte chunk c at byte n * 128 + (c ^ n % 8) * 16), k0 .. k0 + 31, as
// 16-byte cp.async copies; eight neighbouring threads copy one 128-byte row
// (K % 4 == 0, so a copy is all inside K or all outside; rows past an
// operand's end are zero-filled and never read).
__device__ __forceinline__ void x3_load(float* stage, const float* __restrict__ A,
                                        const float* __restrict__ wbig,
                                        const float* __restrict__ wsmall, int m0, int n0, int M,
                                        int N, int k0, int K) {
  const int c = threadIdx.x % 8, row0 = threadIdx.x / 8;
  const bool k_in = k0 + 4 * c < K;
#pragma unroll
  for (int i = 0; i < kX3BN / 32; ++i) {
    const int n = row0 + 32 * i;
    const bool in = k_in && n0 + n < N;
    const size_t g = (size_t)(n0 + n) * K + k0 + 4 * c;
    const int at = n * kX3BK + (c ^ (n & 7)) * 4;
    cp_async16_zfill(stage + at, in ? wbig + g : wbig, in);
    cp_async16_zfill(stage + kX3WPart + at, in ? wsmall + g : wsmall, in);
  }
  float* a = stage + 2 * kX3WPart;
#pragma unroll
  for (int i = 0; i < kX3BM / 32; ++i) {
    const int r = row0 + 32 * i;
    const bool in = k_in && m0 + r < M;
    cp_async16_zfill(a + r * kX3Pitch + 4 * c, in ? A + (size_t)(m0 + r) * K + k0 + 4 * c : A,
                     in);
  }
}

// This warp's A fragment of k8 step kk from a stage (its 16 rows through
// ldmatrix.x4: rows 0-7 | 8-15, k 0-3 | 4-7 -> a0..a3), split.
__device__ __forceinline__ void x3_fragment(const float* stage, int kk, uint32_t (&ab)[4],
                                            uint32_t (&as)[4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* a = stage + 2 * kX3WPart + (warp * 16 + (lane & 15)) * kX3Pitch + (lane >> 4) * 4;
  uint32_t r[4];
  ldmatrix_x4(r, a + kk * 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32_fast(r[i], ab[i], as[i]);
}

// acc = this warpgroup's 64 x 128 part of the 128x128 tile at (m0, n0) of
// sum_k A[m][k] W[n][k], for f32 A [M, K] and W [N, K] (given as its
// split, `split_tf32_kernel`), row-major, 16-byte aligned, K % 4 == 0:
// warpgroup h holds rows 64 h .. 64 h + 63, its warp w rows 64 h + 16 w +
// (g, g + 8), acc[4 j ..] the n8 tile j (`wgmma_tf32_m64n128k8`). `smem` is
// the block's kGemmX3Smem bytes.
__device__ __forceinline__ void tf32x3_nt_tile(const float* __restrict__ A,
                                               const float* __restrict__ wbig,
                                               const float* __restrict__ wsmall, int m0, int n0,
                                               int M, int N, int K, float* smem,
                                               float (&acc)[64]) {
  float* ring = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem) + 1023) &
                                         ~(uintptr_t)1023);  // the swizzle's alignment
  const int ktiles = (K + kX3BK - 1) / kX3BK;
  auto stage = [&](int t) { return ring + (size_t)(t % kX3Stages) * kX3Stage; };
  auto load = [&](int t) {  // one cp.async group a call, empty past K
    if (t < ktiles) x3_load(stage(t), A, wbig, wsmall, m0, n0, M, N, t * kX3BK, K);
    cp_async_commit();
  };
  uint32_t ab[2][kX3BK / 8][4], as[2][kX3BK / 8][4];
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;

  for (int t = 0; t < kX3Stages - 1; ++t) load(t);
  cp_async_wait<kX3Stages - 2>();
  __syncthreads();  // slice 0 landed
#pragma unroll
  for (int kk = 0; kk < kX3BK / 8; ++kk) x3_fragment(stage(0), kk, ab[0][kk], as[0][kk]);
#pragma unroll 1
  for (int kt = 0; kt < ktiles; kt += 2) {
    // Two slices an iteration, so that the fragments' index is a constant.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = kt + u;
      if (t < ktiles) {
        const bool more = t + 1 < ktiles;
        if (more) cp_async_wait<kX3Stages - 3>();
        fence_proxy_async();  // this thread's copies, to wgmma's reads
        // Slices t and t + 1 landed; slice t - 1's wgmmas are done and its
        // A fragments read, so its stage is free.
        __syncthreads();
        load(t + kX3Stages - 1);
        const float* w = stage(t);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kX3BK / 8; ++kk) {
          // the k8 step's two 16-byte chunks start 32 kk bytes into each row;
          // a partial starts from zero
          const uint64_t db = wgmma_desc_sw128(w + kk * 8);
          const uint64_t ds = wgmma_desc_sw128(w + kX3WPart + kk * 8);
          wgmma_tf32_m64n128k8(part, as[u][kk], db, kk > 0);
          wgmma_tf32_m64n128k8(part, ab[u][kk], ds, 1);
          wgmma_tf32_m64n128k8(part, ab[u][kk], db, 1);
          if (more) x3_fragment(stage(t + 1), kk, ab[1 - u][kk], as[1 - u][kk]);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          fence_operand(part[i]);
          acc[i] = __fadd_rn(acc[i], part[i]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// out[m][n] = act(sum_k A[m][k] W[n][k] + bias[n]), all f32, on 3xTF32,
// W given as its split: B7's fc1 (ACT = GELU) and fc2. blockIdx.x walks N,
// blockIdx.y M.
template <int ACT>
__global__ void __launch_bounds__(kX3Threads, 1)
    gemm_tf32x3_kernel(const float* __restrict__ A, const float* __restrict__ wbig,
                       const float* __restrict__ wsmall, const float* __restrict__ bias,
                       float* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * kX3BN, m0 = blockIdx.y * kX3BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[64];
  tf32x3_nt_tile(A, wbig, wsmall, m0, n0, M, N, K, reinterpret_cast<float*>(smem_raw), acc);

  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + warp * 16 + g + 8 * half;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kX3BN / 8; ++j) {
      const int n = n0 + j * 8 + c2;
      if (n >= N) continue;
      const float v0 = activate<ACT>(acc[4 * j + 2 * half] + bias[n]);
      float* o = out + (size_t)m * N + n;
      if (N % 2 == 0) {  // n is even, so n + 1 < N and o is 8-byte aligned
        const float v1 = activate<ACT>(acc[4 * j + 2 * half + 1] + bias[n + 1]);
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (n + 1 < N) o[1] = activate<ACT>(acc[4 * j + 2 * half + 1] + bias[n + 1]);
      }
    }
  }
}

// W [N, K] given as its split, `wbig` and `wsmall` (each N K floats,
// 16-byte aligned).
template <int ACT>
inline int launch_gemm_tf32x3(const float* A, const float* wbig, const float* wsmall,
                              const float* bias, float* out, int M, int N, int K,
                              cudaStream_t stream) {
  auto kernel = gemm_tf32x3_kernel<ACT>;
  const dim3 grid((N + kX3BN - 1) / kX3BN, (M + kX3BM - 1) / kX3BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGemmX3Smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kX3Threads, kGemmX3Smem, stream>>>(A, wbig, wsmall, bias, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace vsc22

extern "C" const char* vsc22_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
