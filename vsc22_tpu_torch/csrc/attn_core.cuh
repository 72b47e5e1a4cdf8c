// The attention core shared by K1, B8, B9 and B10:
//
//   out[b, i, h] = round_T( sum_j round_T(softmax_j(scale * q[b,i,h] . k[b,j,h])) v[b,j,h] )
//
// over rows of L tokens per frame, where head h of token j of frame b sits
// at columns h*hd .. h*hd + hd of row b*L + j, and the rows of q, k and v
// are `stride` elements apart (3C inside a packed qkv, C for separate
// [B, L, H, hd] tensors); out rows are `out_stride` apart. Logits,
// maximum and sum in f32 (over exactly L keys: the loop bound replaces the
// TPU kernels' -1e9 pad mask), probabilities rounded to the working dtype
// T, P.V accumulated in f32 and rounded to T.
//
// What bounds it on the H100: ~2*L*hd FMAs per query row on operands that
// sit in one SM's shared memory, so shared-memory bandwidth of CUDA-core
// dot products; no tensor cores in this version.
//
// Design: one block per (query tile of 64 rows, head, frame). K^T and V of
// that head for all L tokens sit in dynamic shared memory (L*hd*2 values:
// 66 KB bf16 / 132 KB f32 at CLIP's L=257, hence the raised dynamic-smem
// limit; a shape past the 227 KB a block can have is refused at launch).
// One warp per query row: lanes own keys for the logits, warp-reduced max
// and sum, then lanes own head dims for P.V.
#pragma once

#include "gemm_nt.cuh"

namespace vsc22 {

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kQueryTile = 64;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    attn_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, int stride, T* __restrict__ out, int out_stride,
                     int L, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kt = reinterpret_cast<T*>(smem_raw);  // [hd][L]
  T* vs = kt + (size_t)hd * L;             // [L][hd]
  float* qbuf = reinterpret_cast<float*>(vs + (size_t)L * hd);  // [warps][hd]
  float* pbuf = qbuf + kAttnWarps * hd;                          // [warps][L]

  const int b = blockIdx.z, h = blockIdx.y;
  const size_t head = (size_t)b * L * stride + (size_t)h * hd;
  const T* kbase = k + head;
  const T* vbase = v + head;

  for (int e = threadIdx.x; e < L * hd; e += kAttnThreads) {
    const int j = e / hd, d = e % hd;
    const size_t at = (size_t)j * stride + d;
    kt[(size_t)d * L + j] = kbase[at];
    vs[(size_t)j * hd + d] = vbase[at];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = qbuf + warp * hd;
  float* p = pbuf + warp * L;
  const int i_end = min(L, (int)(blockIdx.x + 1) * kQueryTile);
  for (int i = blockIdx.x * kQueryTile + warp; i < i_end; i += kAttnWarps) {
    const T* qrow = q + head + (size_t)i * stride;
    for (int d = lane; d < hd; d += 32) qw[d] = to_f32(qrow[d]);
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float s = 0.0f;
      for (int d = 0; d < hd; ++d) s = fmaf(qw[d], to_f32(kt[(size_t)d * L + j]), s);
      s *= scale;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float ex = expf(p[j] - mx);
      p[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) p[j] = round_to<T>(p[j] / sum);
    __syncwarp();

    T* orow = out + ((size_t)b * L + i) * out_stride + (size_t)h * hd;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) acc = fmaf(p[j], to_f32(vs[(size_t)j * hd + d]), acc);
      orow[d] = from_f32<T>(acc);
    }
    __syncwarp();
  }
}

// Dynamic shared memory of one block (ops/attn.py `attn_smem_bytes` mirrors it).
inline size_t attn_smem_bytes(int L, int hd, size_t elem) {
  return 2 * (size_t)L * hd * elem + (size_t)kAttnWarps * (hd + L) * sizeof(float);
}

// The core over B frames of H heads; returns cudaGetLastError().
template <typename T>
int launch_attn_core(const T* q, const T* k, const T* v, int stride, T* out, int out_stride,
                     int B, int L, int H, int hd, float scale, cudaStream_t stream) {
  const size_t smem = attn_smem_bytes(L, hd, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kQueryTile - 1) / kQueryTile, H, B);
  attn_core_kernel<T><<<grid, kAttnThreads, smem, stream>>>(q, k, v, stride, out, out_stride, L,
                                                             hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace vsc22
