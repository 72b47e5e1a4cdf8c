// The SwinV2 cosine window-attention core, shared by B6 (window_attn.cu)
// and B1 (swin_block.cu):
//
//   out[w,h,i,:] = sum_j p_ij v[w,h,j,:],
//   p_i = softmax_j( (q̂_i . k̂_j) * scale[h] + rpb[h,i,j] (+ mask[w % nW, i, j]) )
//
// with q̂ = q * rsqrt(|q|^2 + 1e-12) and k̂ likewise, in f32. The template
// flag ROUND_QK picks the rounding of the Pallas kernel being replaced:
//  - B1 (`pallas_swin_block.py:143-181`): q, k and v arrive as f32 QKV sums;
//    q̂ and k̂ are rounded to the working dtype T before the logits, v is
//    rounded to T, the mask is added only when the caller passes one (nW > 1);
//  - B6 (`pallas_window_attn.py:43-62`): q, k, v arrive in T; q̂ and k̂ stay
//    f32; the caller always passes the mask.
// In both, the softmax is f32, the probabilities are rounded to T, P.V
// accumulates in f32 and the output is rounded to T.
//
// What bounds it on the H100: per (window, head) it does 2*N*N*hd FMAs on
// operands that fit one SM's shared memory (N = 256, hd = 32 at
// SwinV2-Base), so the CUDA-core dot products out of shared memory bound
// it, not device memory.
//
// Design: one block of 8 warps per (window, head, 64-query tile). The
// TPU kernel packed 4 heads block-diagonally into a 128-deep MXU
// contraction; here the head's k̂ (transposed, row stride N + 1 against
// bank conflicts) and v sit in dynamic shared memory as f32 (64 KB at
// N = 256, hd = 32). One warp per query row: lanes own keys for the logits
// and the softmax (warp-reduced max and sum), then head dims for P.V.
// Later work: tensor cores (mma) for both products, and one block per
// window across heads.
#pragma once

#include "gemm_nt.cuh"

namespace vsc22 {

constexpr int kWinThreads = 256;
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kWinQueryTile = 64;

// Element strides of window, head and token; the head dim is contiguous.
struct WinLayout {
  long long w, h, n;
};

template <typename TIN, typename T, bool ROUND_QK>
__global__ void __launch_bounds__(kWinThreads)
    window_attn_kernel(const TIN* __restrict__ q, const TIN* __restrict__ k,
                       const TIN* __restrict__ v, WinLayout in, T* __restrict__ out,
                       WinLayout ol, const float* __restrict__ rpb,
                       const float* __restrict__ scale, const float* __restrict__ mask, int nW,
                       int N, int hd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = N + 1;
  float* kt = reinterpret_cast<float*>(smem_raw);  // [hd][N + 1]  k̂ transposed
  float* vs = kt + (size_t)hd * ldk;                // [N][hd]
  float* qbuf = vs + (size_t)N * hd;                // [warps][hd]
  float* pbuf = qbuf + kWinWarps * hd;              // [warps][N]

  const int w = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)w * in.w + (size_t)h * in.h;

  // k̂ and v of this (window, head): one warp per key row.
  for (int j = warp; j < N; j += kWinWarps) {
    const TIN* krow = k + base + (size_t)j * in.n;
    const TIN* vrow = v + base + (size_t)j * in.n;
    float ss = 0.0f;
    for (int d = lane; d < hd; d += 32) {
      const float kv = to_f32(krow[d]);
      ss = fmaf(kv, kv, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) + 1e-12f);
    for (int d = lane; d < hd; d += 32) {
      float kn = to_f32(krow[d]) * inv;
      if constexpr (ROUND_QK) kn = round_to<T>(kn);
      kt[(size_t)d * ldk + j] = kn;
      vs[(size_t)j * hd + d] = round_to<T>(to_f32(vrow[d]));
    }
  }
  __syncthreads();

  const float sc = scale[h];
  const float* rpb_h = rpb + (size_t)h * N * N;
  const float* mask_w = mask != nullptr ? mask + (size_t)(w % nW) * N * N : nullptr;
  float* qv = qbuf + warp * hd;
  float* p = pbuf + (size_t)warp * N;
  const int i_end = min(N, (int)(blockIdx.z + 1) * kWinQueryTile);
  for (int i = blockIdx.z * kWinQueryTile + warp; i < i_end; i += kWinWarps) {
    const TIN* qrow = q + base + (size_t)i * in.n;
    float ss = 0.0f;
    for (int d = lane; d < hd; d += 32) {
      const float qx = to_f32(qrow[d]);
      qv[d] = qx;
      ss = fmaf(qx, qx, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) + 1e-12f);
    for (int d = lane; d < hd; d += 32) {
      float qn = qv[d] * inv;
      if constexpr (ROUND_QK) qn = round_to<T>(qn);
      qv[d] = qn;
    }
    __syncwarp();

    const float* rrow = rpb_h + (size_t)i * N;
    const float* mrow = mask_w != nullptr ? mask_w + (size_t)i * N : nullptr;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s = fmaf(qv[d], kt[(size_t)d * ldk + j], s);
      s = s * sc + rrow[j];
      if (mrow != nullptr) s += mrow[j];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < N; j += 32) {
      const float ex = expf(p[j] - mx);
      p[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) p[j] = round_to<T>(p[j] / sum);
    __syncwarp();

    T* orow = out + (size_t)w * ol.w + (size_t)h * ol.h + (size_t)i * ol.n;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < N; ++j) acc = fmaf(p[j], vs[(size_t)j * hd + d], acc);
      orow[d] = from_f32<T>(acc);
    }
    __syncwarp();
  }
}

inline size_t window_attn_smem_bytes(int N, int hd) {
  return ((size_t)hd * (N + 1) + (size_t)N * hd + (size_t)kWinWarps * (hd + N)) * sizeof(float);
}

// Launch over W windows x H heads; `mask` == nullptr adds no mask. Returns a
// cudaError_t (a shape past the shared-memory limit fails at the attribute).
template <typename TIN, typename T, bool ROUND_QK>
int launch_window_attn(const TIN* q, const TIN* k, const TIN* v, WinLayout in, T* out,
                       WinLayout ol, const float* rpb, const float* scale, const float* mask,
                       int W, int H, int nW, int N, int hd, cudaStream_t stream) {
  auto kernel = window_attn_kernel<TIN, T, ROUND_QK>;
  const size_t smem = window_attn_smem_bytes(N, hd);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(W, H, (N + kWinQueryTile - 1) / kWinQueryTile);
  kernel<<<grid, kWinThreads, smem, stream>>>(q, k, v, in, out, ol, rpb, scale, mask, nW, N,
                                              hd);
  return (int)cudaGetLastError();
}

}  // namespace vsc22
