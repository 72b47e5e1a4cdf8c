// The attention core shared by K1, B8, B9 and B10:
//
//   out[b, i, h] = round_T( sum_j round_T(softmax_j(scale * q[b,i,h] . k[b,j,h])) v[b,j,h] )
//
// over rows of L tokens per frame, where head h of token j of frame b sits
// at columns h*hd .. h*hd + hd of row b*L + j, and the rows of q, k and v
// are `stride` elements apart (3C inside a packed qkv, C for separate
// [B, L, H, hd] tensors); out rows are `out_stride` apart. Logits,
// maximum and sum in f32 (over exactly L keys: the loop bound or a -inf
// mask replaces the TPU kernels' -1e9 pad mask), probabilities normalised
// and then rounded to the working dtype T, P.V accumulated in f32 and
// rounded to T.
//
// Two cores compute it; `attn_core_is_mma` picks one, and ops/attn.py
// `attn_core` mirrors the rule:
//
// * The tensor-core core (`attn_core_mma_kernel`) takes bf16 with hd a
//   multiple of 16 up to 128. What bounds the function on the H100 at the
//   main-path shapes (CLIP [128,257,16,64], ViT [128,145,12,64]) is bytes
//   (q, k, v in and out once: ~4 L hd bytes against ~4 L^2 hd FLOPs per
//   head); what bounds this design is the warp-level tensor-core rate
//   (mma.sync m16n8k16, bf16 in, f32 accumulate) and the f32 softmax
//   (two expf per logit).
//   Design: one block per (query tile, head, frame), each warp owning 16
//   query rows; the ceil(L/16) row tiles of a head are spread evenly over
//   the fewest blocks of at most 8 warps (`attn_mma_warps`: at L 257, 3
//   blocks of 6 warps for 17 tiles; at L 145, 2 of 5 for 10). One block
//   per head would leave 7 of 8 warps idle through a third round at L
//   257; fixed 64-row tiles would waste 3 of 20 warp tiles, run 4 warps a
//   block (2 blocks fit an SM's shared memory, so 8 warps an SM: too few
//   to hide the latency of mma.sync and expf) and read a head's K and V
//   five times. K, V and the block's Q rows go into shared memory once,
//   by 16-byte cp.async (V in a second group that lands during pass 1), at
//   a row pitch of hd + 8 elements so that ldmatrix is free of bank
//   conflicts; the rows from L up to the next multiple of 16 are zeroed
//   (0 * NaN would be NaN in P.V). The softmax keeps the TPU kernel's
//   rounding point: pass 1 runs S = Q K^T on tensor cores over 64-key
//   chunks with an online row maximum and sum; pass 2 recomputes S and
//   forms p = round_bf16(expf(s - m) * (1 / l)) in registers, which the
//   m16n8 accumulator layout hands to P.V as its A operand without a trip
//   through shared memory (V through ldmatrix.trans). FlashAttention's
//   deferred normalisation would round the unnormalised exp instead. Each
//   mma's partial sum is added to the f32 sums with round-to-nearest (see
//   `logits_tile`), which keeps the outputs close to the plain version's.
//   Logit columns >= L are -inf. The pointers must be 16-byte aligned and
//   the row stride a multiple of 8 elements, or the launch returns
//   cudaErrorMisalignedAddress.
//
// * The FFMA core (`attn_core_kernel`) takes f32 (TF32 cannot hold the f32
//   bars) and every other hd: one block per (query tile of 64 rows, head,
//   frame), K^T and V of the head in shared memory (L*hd*2 values: 132 KB
//   in f32 at CLIP's L=257), one warp per query row -- lanes own keys for
//   the logits, warp-reduced max and sum, then lanes own head dims for P.V.
//   Shared-memory bandwidth of CUDA-core dot products bounds it.
//
// A shape past the 227 KB of shared memory a block can have is refused at
// launch (and by the wrappers first, with the size).
#pragma once

#include <type_traits>

#include "gemm_nt.cuh"
#include "mma.cuh"

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

// Dynamic shared memory of one block of the FFMA core (ops/attn.py
// `attn_smem_bytes` mirrors it).
inline size_t attn_smem_bytes(int L, int hd, size_t elem) {
  return 2 * (size_t)L * hd * elem + (size_t)kAttnWarps * (hd + L) * sizeof(float);
}

// ---- the bf16 tensor-core core ----------------------------------------------

constexpr int kMmaMaxWarps = 8;   // warps of 16 query rows per block, at most
constexpr int kMmaKeyChunk = 64;  // keys per step of pass 1
constexpr int kMmaMaxHd = 128;

// Which core a launch takes (ops/attn.py `attn_core` mirrors it).
inline bool attn_core_is_mma(bool bf16, int hd) {
  return bf16 && hd >= 16 && hd <= kMmaMaxHd && hd % 16 == 0;
}

// Warps per block of the tensor-core core: the ceil(L / 16) row tiles of a
// head spread evenly over the fewest blocks of at most 8 warps (L 257:
// 3 blocks of 6 warps for 17 tiles; L 145: 2 of 5 for 10).
inline int attn_mma_warps(int L) {
  const int tiles = (L + 15) / 16;
  const int blocks = (tiles + kMmaMaxWarps - 1) / kMmaMaxWarps;
  return (tiles + blocks - 1) / blocks;
}

// Dynamic shared memory of one block of the tensor-core core: K, V (L
// rounded up to 16 rows) and the block's Q rows at a pitch of hd + 8 bf16
// (ops/attn.py `attn_smem_bytes` mirrors it).
inline size_t attn_mma_smem_bytes(int L, int hd) {
  const size_t lp = (size_t)(L + 15) / 16 * 16;
  return (2 * lp + 16 * attn_mma_warps(L)) * (hd + 8) * sizeof(__nv_bfloat16);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t. A thread holds
// accumulator rows g and g + 8 at columns 2t and 2t + 1 of each 8-column
// tile: s[0], s[1] on row g, s[2], s[3] on row g + 8.

// S = scale * Q K^T for one 16-key tile (two 8-key accumulator tiles) of a
// warp's 16 query rows; columns >= L set to -inf.
//
// Here and in P.V each mma starts from zero accumulators, and its 16-term
// partial sum joins the running f32 sum by an ordinary (round-to-nearest)
// add: the tensor core's own accumulate does not round to nearest, and
// chaining it over a row moved the results further from the plain
// version's sequential f32 sums (at CLIP's shape on the H100, the share of
// bf16 B10 outputs that differ from the plain version's: 2.20% chained,
// 1.49% split; of B8's: 0.056% and 0.040%).
template <int HD>
__device__ __forceinline__ void logits_tile(float (&s)[2][4], const uint32_t (&qf)[HD / 16][4],
                                            const __nv_bfloat16* ks, int key0, int L,
                                            float scale, int lane) {
  constexpr int P = HD + 8;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
  // ldmatrix matrices: (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15,
  // d 0-7), (keys 8-15, d 8-15) -> b0, b1 of key tile 0, b0, b1 of tile 1.
  const int mi = lane >> 3;
  const __nv_bfloat16* row = ks + (size_t)(key0 + (mi >> 1) * 8 + (lane & 7)) * P + (mi & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, row + kk * 16);
    float t[2][4] = {};
    mma_bf16(t[0], qf[kk], b[0], b[1]);
    mma_bf16(t[1], qf[kk], b[2], b[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] += t[n][i];
  }
  const int col = key0 + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = s[n][i] * scale;
      s[n][i] = col + 8 * n + (i & 1) < L ? v : -INFINITY;
    }
}

template <int HD>
__global__ void __launch_bounds__(32 * kMmaMaxWarps)
    attn_core_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, int stride,
                         __nv_bfloat16* __restrict__ out, int out_stride, int L, float scale) {
  constexpr int P = HD + 8;    // shared-memory row pitch, elements
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KT = kMmaKeyChunk / 16;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = (L + 15) & ~15;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [lp][P]
  bf16* vs = ks + (size_t)lp * P;                 // [lp][P]
  bf16* qs = vs + (size_t)lp * P;                 // [16 * warps][P]

  const int threads = blockDim.x, rows = threads / 2;  // 16 query rows per warp
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * rows;
  const size_t head = (size_t)b * L * stride + (size_t)h * HD;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Group 0: the block's Q rows and K; group 1: V.
  for (int e = threadIdx.x; e < rows * CH; e += threads) {
    const int r = e / CH, c = (e % CH) * 8;
    bf16* dst = qs + r * P + c;
    if (q0 + r < L)
      cp_async16(dst, q + head + (size_t)(q0 + r) * stride + c);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  for (int e = threadIdx.x; e < lp * CH; e += threads) {
    const int r = e / CH, c = (e % CH) * 8;
    bf16* dst = ks + (size_t)r * P + c;
    if (r < L)
      cp_async16(dst, k + head + (size_t)r * stride + c);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  cp_async_commit();
  for (int e = threadIdx.x; e < lp * CH; e += threads) {
    const int r = e / CH, c = (e % CH) * 8;
    bf16* dst = vs + (size_t)r * P + c;
    if (r < L)
      cp_async16(dst, v + head + (size_t)r * stride + c);
    else
      *reinterpret_cast<uint4*>(dst) = zero;
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp;
  const bool active = row0 < L;

  // Q fragments of the warp's 16 rows: matrices (rows 0-7, d 0-7), (rows
  // 8-15, d 0-7), (rows 0-7, d 8-15), (rows 8-15, d 8-15) = a0..a3.
  uint32_t qf[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  if (active) {
    const bf16* qrow = qs + (size_t)(16 * warp + (lane & 15)) * P + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);

    // Pass 1: row maximum and sum of exp(s - max), online over key chunks.
    for (int kb = 0; kb < lp; kb += kMmaKeyChunk) {
      float s[KT][2][4];
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (kb + 16 * t < lp) {
          logits_tile<HD>(s[t], qf, ks, kb + 16 * t, L, scale, lane);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) cmax[i >> 1] = fmaxf(cmax[i >> 1], s[t][n][i]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 1));
        cmax[r] = fmaxf(cmax[r], __shfl_xor_sync(0xffffffffu, cmax[r], 2));
        const float mn = fmaxf(m[r], cmax[r]);  // finite: every chunk has a key < L
        l[r] *= expf(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (kb + 16 * t < lp) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) l[i >> 1] += expf(s[t][n][i] - m[i >> 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.0f / l[r];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  // Pass 2: p = round(expf(s - m) / l), straight into the A operand of P.V.
  // (l holds 1 / sum now: the product rounds as the quotient does but for
  // a one-ulp f32 difference, rarer than one from the order of the sum,
  // and the quotient costs time.)
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
  // ldmatrix.trans matrices of V: (keys 0-7, d 0-7), (keys 8-15, d 0-7),
  // (keys 0-7, d 8-15), (keys 8-15, d 8-15) -> b0, b1 of d tile 0, of tile 1.
  const int mi = lane >> 3;
  const bf16* vrow = vs + (size_t)((mi & 1) * 8 + (lane & 7)) * P + (mi >> 1) * 8;
  for (int key0 = 0; key0 < lp; key0 += 16) {
    float s[2][4];
    logits_tile<HD>(s, qf, ks, key0, L, scale, lane);
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      pa[2 * n] = pack_bf16(expf(s[n][0] - m[0]) * l[0], expf(s[n][1] - m[0]) * l[0]);
      pa[2 * n + 1] = pack_bf16(expf(s[n][2] - m[1]) * l[1], expf(s[n][3] - m[1]) * l[1]);
    }
#pragma unroll
    for (int dd = 0; dd < HD / 16; ++dd) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vrow + (size_t)key0 * P + dd * 16);
      float t[2][4] = {};
      mma_bf16(t[0], pa, bv[0], bv[1]);
      mma_bf16(t[1], pa, bv[2], bv[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * dd][i] += t[0][i];
        o[2 * dd + 1][i] += t[1][i];
      }
    }
  }

  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row0 + g + 8 * half;
    if (i >= L) continue;
    bf16* orow = out + ((size_t)b * L + i) * out_stride + (size_t)h * HD + c2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
  }
}

template <int HD>
int launch_attn_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                    int stride, __nv_bfloat16* out, int out_stride, int B, int L, int H,
                    float scale, cudaStream_t stream) {
  const size_t smem = attn_mma_smem_bytes(L, HD);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int warps = attn_mma_warps(L), rows = 16 * warps;
  const dim3 grid((L + rows - 1) / rows, H, B);
  attn_core_mma_kernel<HD><<<grid, 32 * warps, smem, stream>>>(q, k, v, stride, out,
                                                                out_stride, L, scale);
  return (int)cudaGetLastError();
}

// The tensor-core core over B frames of H heads.
inline int launch_attn_core_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, int stride, __nv_bfloat16* out,
                                int out_stride, int B, int L, int H, int hd, float scale,
                                cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || stride % 8 != 0 || out_stride % 2 != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (hd) {
    case 16: return launch_attn_mma<16>(q, k, v, stride, out, out_stride, B, L, H, scale, stream);
    case 32: return launch_attn_mma<32>(q, k, v, stride, out, out_stride, B, L, H, scale, stream);
    case 48: return launch_attn_mma<48>(q, k, v, stride, out, out_stride, B, L, H, scale, stream);
    case 64: return launch_attn_mma<64>(q, k, v, stride, out, out_stride, B, L, H, scale, stream);
    case 80: return launch_attn_mma<80>(q, k, v, stride, out, out_stride, B, L, H, scale, stream);
    case 96: return launch_attn_mma<96>(q, k, v, stride, out, out_stride, B, L, H, scale, stream);
    case 112:
      return launch_attn_mma<112>(q, k, v, stride, out, out_stride, B, L, H, scale, stream);
    case 128:
      return launch_attn_mma<128>(q, k, v, stride, out, out_stride, B, L, H, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The core over B frames of H heads; returns cudaGetLastError(), or
// cudaErrorMisalignedAddress where the tensor-core core cannot take the
// operands.
template <typename T>
int launch_attn_core(const T* q, const T* k, const T* v, int stride, T* out, int out_stride,
                     int B, int L, int H, int hd, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (attn_core_is_mma(true, hd))
      return launch_attn_core_mma(q, k, v, stride, out, out_stride, B, L, H, hd, scale, stream);
  }
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
