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
// Two cores compute it; `window_core_is_mma` picks one before the launch,
// and ops/window_attn.py `window_core` mirrors the rule: the tensor-core
// core at hd 16 or 32 and N <= 256 (every SwinV2-Base stage: hd 32, N 256
// or 64), the FFMA core at every other shape.
//
// * The tensor-core core (`window_attn_mma_kernel`). What bounds the
//   function on the H100: per (window, head) 4 N^2 hd flops on 4 N hd
//   inputs and outputs, so bytes at hd 32 (B6 bf16 stage 1 [2048,4,256,32]:
//   0.537 GB of q, k, v and out, 0.16 ms at 3.35 TB/s, against 0.034 ms of
//   bf16 tensor-core flops). What bounded the FFMA core was the two
//   shared-memory loads of each of its 2 N^2 hd FMAs; here the products
//   are warp-level mma.sync, and what is left per logit is the bias
//   (rpb[h] + mask[w % nW], f32 [N, N] each: 8 bytes a logit, 4.3 GB from
//   L2 at stage 1 if read for every window), one expf and the f32 softmax.
//   Design:
//   - One block per (16 * warps query rows, head h, window class j =
//     w % nW, group of items): the windows j, j + nW, j + 2 nW, ... share
//     rpb[h] + mask[j], so the block sums that [rows, N] tile into shared
//     memory once and walks its group of windows over it. Groups are sized
//     for ~4 blocks an SM: at B6's stage 1 (640 blocks of 8 warps, 26
//     windows each) the tiles take 2 x 128 KB a block, 0.17 GB in all,
//     where reading the bias for every logit would take 4.3 GB. Folding the mask
//     into the tile adds rpb + mask before the logit, where the plain
//     version adds them to it one after the other: the two differ by one
//     f32 rounding, and only where the mask is -100, whose probabilities
//     are below e^-80 of the row's largest.
//   - Per window, k̂ (normalised on the way into shared memory) and v, zero
//     rows from N up to the next multiple of 16, at row pitches of hd + 8
//     (bf16) or hd + 4 (f32) elements, so ldmatrix and the f32 fragment
//     loads are free of bank conflicts; every load of a window is issued
//     before the first is used. B6 in bf16 keeps k raw (below), so its k
//     and v go by 16-byte cp.async into two buffers, the next window's
//     filling while this one's is read. Each warp owns 16 query rows; it
//     loads and normalises its q rows straight into mma fragments (the
//     four lanes of a row sum its squares with two shuffles).
//   - N <= 256, so a warp keeps its whole [16, N] logit tile in registers
//     (128 a thread at N 256): one QK^T, one expf per logit, and p =
//     expf(s - max) * (1 / sum) rounded to T (as the TPU kernel rounds p
//     after normalising) straight from the accumulators into the A
//     operand of the P.V mma, or into B1's FMA chains.
//   - The operands of each product, by caller:
//     B1 in bf16 (ROUND_QK): q̂ and k̂ rounded to bf16, so Q̂K̂^T is an exact
//     bf16 mma.m16n8k16 with f32 accumulation. Its P.V (PV_SEQ) is an FMA
//     chain over the keys in order for each output, from v held in f32,
//     the four lanes of a quad passing each other the rounded p of their
//     keys by shuffle: the plain version's f32 product sums in exactly
//     that order, and B1 carries any attention output that rounds the
//     other way through x1, the hidden and the output. Summed in 16-key
//     mma partials instead, 0.0126-0.0132% of the attention outputs round
//     otherwise (scripts/torch_swin_probe.py --orders, NVIDIA H100 80GB
//     HBM3, 700.00 W), which B1 carries to about twice its share of
//     differing outputs at stages 3 and 4 (PERF.md). The chains cost more
//     than the mma: their 16 FMAs a key and thread alone take 0.6 ms of
//     B1's core at stage 1.
//     B6 keeps q̂ and k̂ f32 in both dtypes, and an mma on them rounded to
//     bf16 would be B1's function, not B6's. In bf16 its q and k arrive in
//     bf16, so q̂ . k̂ = (q . k) / (|q| |k|) takes the exact bf16 mma on the
//     raw q and k, and each logit is then multiplied by the two f32
//     reciprocal norms (QK_RAW): one bf16 mma per 16 x 8 x 16 where a
//     split of f32 operands takes three, and q̂ and k̂ are never rounded.
//     In f32 (B6 and B1 alike) both products take "3xTF32": each f32
//     operand split into a tf32 big part and a tf32 remainder
//     (`split_tf32`), and big*big + big*small + small*big on
//     mma.m16n8k8.tf32 carries each product to about 2^-22 of its size
//     (plain TF32, ~2^-11, cannot hold the f32 bars; a bf16 hi + lo split
//     of 3 mmas keeps ~2^-16). P.V in bf16 is an exact bf16 mma; in f32
//     the keys of each 8-key tile are permuted (mma k-index t <-> key 2t,
//     t + 4 <-> 2t + 1) so that the logit accumulators are the A
//     fragments as they stand.
//   - As in attn_core.cuh, each big (or bf16) mma starts from zero and its
//     partial sum joins the f32 sums by a round-to-nearest add; the small
//     3xTF32 terms chain on the tensor core's own accumulate.
//   The bases must be 16-byte aligned (the core reads 16- and 8-byte
//   vectors), or the launch returns cudaErrorMisalignedAddress.
//
// * The FFMA core (`window_attn_kernel`), for every other shape: one block
//   of 8 warps per (window, head, 64-query tile); k̂ (transposed, row
//   stride N + 1 against bank conflicts) and v in dynamic shared memory as
//   f32 (64 KB at N 256, hd 32); one warp per query row: lanes own keys
//   for the logits and the softmax, then head dims for P.V. CUDA-core dot
//   products out of shared memory bound it. A shape past the 227 KB a
//   block can have is refused (by the wrappers first, with its size).
#pragma once

#include <type_traits>

#include "gemm_nt.cuh"
#include "mma.cuh"

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

// Dynamic shared memory of one block of the FFMA core (ops/window_attn.py
// `window_smem_bytes` mirrors it).
inline size_t window_attn_smem_bytes(int N, int hd) {
  return ((size_t)hd * (N + 1) + (size_t)N * hd + (size_t)kWinWarps * (hd + N)) * sizeof(float);
}

// ---- the tensor-core core ---------------------------------------------------

constexpr int kWinMmaMaxWarps = 8;  // warps of 16 query rows per block, at most
constexpr int kWinMmaMaxN = 256;    // a warp's [16, N] logits stay in registers
constexpr int kWinBlocksPerSm = 4;  // blocks a launch aims at per SM (item groups)

// Which core a launch takes (ops/window_attn.py `window_core` mirrors it).
inline bool window_core_is_mma(int N, int hd) {
  return (hd == 16 || hd == 32) && N >= 1 && N <= kWinMmaMaxN;
}

// Warps per block: the ceil(N / 16) row tiles of a window spread evenly
// over the fewest blocks of at most 8 warps (N 256: 2 blocks of 8; N 64: 1
// of 4; N 36: 1 of 3).
inline int window_mma_warps(int N) {
  const int tiles = (N + 15) / 16;
  const int blocks = (tiles + kWinMmaMaxWarps - 1) / kWinMmaMaxWarps;
  return (tiles + blocks - 1) / blocks;
}

// Row pitch (floats) of the bias tile: N rounded up to 32, plus 8, so the
// float2 reads of a half-warp (rows g, columns 2t) hit distinct banks.
__host__ __device__ inline int window_bias_pitch(int N) { return (N + 31) / 32 * 32 + 8; }

// Dynamic shared memory of one block of the tensor-core core: the bias
// tile [16 * warps, pitch] f32; k̂ (or raw k) and v of one window at N
// rounded up to 16 rows, bf16 at a pitch of hd + 8 where its product is an
// exact bf16 mma, f32 at hd + 4 where it is 3xTF32; with raw k, two such
// buffers and the f32 norms (ops/window_attn.py `window_smem_bytes`
// mirrors it).
inline size_t window_mma_smem_bytes(int N, int hd, bool qk_bf16, bool v_bf16, bool qk_raw) {
  const size_t np = (size_t)(N + 15) / 16 * 16;
  const size_t rows = (size_t)16 * window_mma_warps(N);
  const size_t bias = rows * window_bias_pitch(N) * sizeof(float);
  const size_t bf16_rows = (size_t)(hd + 8) * sizeof(__nv_bfloat16);
  const size_t f32_rows = (size_t)(hd + 4) * sizeof(float);
  const size_t kv = np * (qk_bf16 ? bf16_rows : f32_rows) + np * (v_bf16 ? bf16_rows : f32_rows);
  return bias + (qk_raw ? 2 * kv + np * sizeof(float) : kv);
}

// D (4 or 8) consecutive bf16 values as f32: one 8- or 16-byte load.
template <int D>
__device__ __forceinline__ void load_bf16_row(const __nv_bfloat16* p, float (&v)[D]) {
  uint32_t w[D / 2];
  if constexpr (D == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    w[0] = raw.x, w[1] = raw.y;
  }
#pragma unroll
  for (int u = 0; u < D / 2; ++u) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[u]));
    v[2 * u] = f.x;
    v[2 * u + 1] = f.y;
  }
}

// Four f32 values stored as T: bf16 as one 8-byte store, f32 as 16 bytes.
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 raw;
  raw.x = pack_bf16(v[0], v[1]);
  raw.y = pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Two f32 values of one output row stored as T (columns c, c + 1).
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// x += y, elementwise, with round-to-nearest adds.
__device__ __forceinline__ void add4(float (&x)[4], const float (&y)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __fadd_rn(x[i], y[i]);
}

// One block: `rows` = 16 * warps query rows from blockIdx.x * rows, head
// h and window class j from blockIdx.y = h * nWm + j, and the windows
// w = item * nWm + j for the items of group blockIdx.z (`per_block` each).
// nWm is nW where a mask is given, else 1. NKT is the largest number of
// 8-key tiles the instance holds in registers (N <= 8 * NKT); FULL says
// N == 8 * NKT (every SwinV2-Base shape), so that no loop over the tiles
// needs a bound check: without it B1 took 8.492 ms at stage 1 where it
// takes 7.166 (PERF.md).
template <typename TIN, typename T, bool ROUND_QK, int HD, int NKT, bool FULL>
__global__ void __launch_bounds__(32 * kWinMmaMaxWarps)
    window_attn_mma_kernel(const TIN* __restrict__ q, const TIN* __restrict__ k,
                           const TIN* __restrict__ v, WinLayout in, T* __restrict__ out,
                           WinLayout ol, const float* __restrict__ rpb,
                           const float* __restrict__ scale, const float* __restrict__ mask,
                           int nWm, int items, int per_block, int N) {
  using bf16 = __nv_bfloat16;
  constexpr bool PV_BF16 = std::is_same_v<T, bf16>;
  // Q K^T as an exact bf16 mma: on q̂, k̂ rounded to bf16 (B1, ROUND_QK),
  // or on the raw bf16 q, k with the f32 norms applied to each logit after
  // (B6 in bf16, QK_RAW: q̂ and k̂ are never rounded). Else 3xTF32 on q̂, k̂.
  constexpr bool QK_RAW = !ROUND_QK && std::is_same_v<TIN, bf16>;
  constexpr bool QK_BF16 = (ROUND_QK && PV_BF16) || QK_RAW;
  // P V as FMA chains over the keys (B1 in bf16; see the note at the top),
  // from v held in f32 (bf16 values) in shared memory.
  constexpr bool PV_SEQ = ROUND_QK && PV_BF16;
  constexpr bool V_BF16 = PV_BF16 && !PV_SEQ;
  constexpr int PB = HD + 8;  // bf16 row pitch, elements
  constexpr int PF = HD + 4;  // f32 row pitch, elements
  constexpr int LPR = HD / 4; // threads per k or v row when loading (4 elements each)
  // Rows a thread loads at most: tiles of 16 rows spread over at most 2
  // blocks (N <= 256) give a block >= tiles / 2 warps, so np * LPR <=
  // 16 * tiles * 8 <= 8 * blockDim.x.
  constexpr int PASSES = 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32, rows = 16 * warps;
  const int np = (N + 15) & ~15, nkt = np / 8;
  const int bp = window_bias_pitch(N);
  float* bias_s = reinterpret_cast<float*>(smem_raw);  // [rows][bp]
  unsigned char* kv_raw = smem_raw + (size_t)rows * bp * sizeof(float);
  // k̂ (or raw k) and v: [np][PB] bf16 or [np][PF] f32 each; with raw k two
  // buffers of each, one filling by cp.async while the other is read.
  const size_t k_bytes = (size_t)np * (QK_BF16 ? PB * sizeof(bf16) : PF * sizeof(float));
  const size_t v_bytes = (size_t)np * (V_BF16 ? PB * sizeof(bf16) : PF * sizeof(float));
  float* inv_k = reinterpret_cast<float*>(kv_raw + (QK_RAW ? 2 : 1) * (k_bytes + v_bytes));

  const int q0 = blockIdx.x * rows;
  const int h = blockIdx.y / nWm, j = blockIdx.y % nWm;
  const int item1 = min(items, (int)(blockIdx.z + 1) * per_block);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;

  // The bias tile: rpb[h] + mask[j] at the block's rows (0 past N), -inf
  // at the keys from N up to np.
  {
    const float* rpb_h = rpb + (size_t)h * N * N;
    const float* mask_j = mask != nullptr ? mask + (size_t)j * N * N : nullptr;
    for (int e = threadIdx.x; e < rows * np; e += blockDim.x) {
      const int r = e / np, c = e % np, i = q0 + r;
      float b = -INFINITY;
      if (c < N) {
        b = 0.0f;
        if (i < N) {
          b = rpb_h[(size_t)i * N + c];
          if (mask_j != nullptr) b = __fadd_rn(b, mask_j[(size_t)i * N + c]);
        }
      }
      bias_s[(size_t)r * bp + c] = b;
    }
  }
  const float sc = scale[h];
  const int r0 = 16 * warp + g;  // the thread's two rows in the tile: r0, r0 + 8
  const int i0 = q0 + r0, i1 = i0 + 8;

  // Raw bf16 k and v of window `it_w` into buffer `buf`, 16 bytes a copy,
  // zero rows past N.
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  auto copy_kv = [&](int it_w, int buf) {
    const size_t b0 = (size_t)(it_w * nWm + j) * in.w + (size_t)h * in.h;
    unsigned char* kb = kv_raw + buf * (k_bytes + v_bytes);
    bf16* kd = reinterpret_cast<bf16*>(kb);
    bf16* vd = reinterpret_cast<bf16*>(kb + k_bytes);
    for (int e = threadIdx.x; e < np * CH; e += blockDim.x) {
      const int r = e / CH, c = (e % CH) * 8;
      const size_t src = b0 + (size_t)min(r, N - 1) * in.n + c;
      cp_async16_zfill(kd + (size_t)r * PB + c, k + src, r < N);
      cp_async16_zfill(vd + (size_t)r * PB + c, v + src, r < N);
    }
  };
  if constexpr (QK_RAW) {
    copy_kv(blockIdx.z * per_block, 0);
    cp_async_commit();
  }

  for (int item = blockIdx.z * per_block, it = 0; item < item1; ++item, ++it) {
    const int w = item * nWm + j;
    const size_t base = (size_t)w * in.w + (size_t)h * in.h;
    void* ks = kv_raw + (QK_RAW ? (it & 1) * (k_bytes + v_bytes) : 0);
    void* vs = static_cast<unsigned char*>(ks) + k_bytes;

    // The warp's q rows i0, i1: per k-step kk of the product, bf16 k16
    // steps hold columns 16kk + 2t + {0, 1, 8, 9}, tf32 k8 steps columns
    // 8kk + t + {0, 4}. All of this window's loads are issued before any
    // is used, so their latencies overlap.
    constexpr int STEPS = QK_BF16 ? HD / 16 : HD / 8;
    constexpr int PER = QK_BF16 ? 4 : 2;
    float x0[STEPS][PER], x1[STEPS][PER];
    {
      const TIN* qr0 = q + base + (size_t)min(i0, N - 1) * in.n;
      const TIN* qr1 = q + base + (size_t)min(i1, N - 1) * in.n;
      const float keep0 = i0 < N ? 1.0f : 0.0f, keep1 = i1 < N ? 1.0f : 0.0f;
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int col = QK_BF16 ? 16 * kk + 2 * t + (u & 1) + 8 * (u >> 1) : 8 * kk + t + 4 * u;
          x0[kk][u] = to_f32(qr0[col]) * keep0;
          x1[kk][u] = to_f32(qr1[col]) * keep1;
        }
    }
    if constexpr (QK_RAW) {
      __syncthreads();  // the previous window's buffer is read out
      if (item + 1 < item1) copy_kv(item + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // this window's k and v have landed
      // The f32 reciprocal norms of the raw k rows, LPR threads a row.
      for (int r = threadIdx.x / LPR; r < np; r += blockDim.x / LPR) {
        const int c = (threadIdx.x % LPR) * 4;
        float kx[4];
        load4(static_cast<const bf16*>(ks) + (size_t)r * PB + c, kx);
        float ss = 0.0f;
#pragma unroll
        for (int u = 0; u < 4; ++u) ss = fmaf(kx[u], kx[u], ss);
#pragma unroll
        for (int off = 1; off < LPR; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        if (c == 0) inv_k[r] = rsqrtf(ss + 1e-12f);
      }
    } else {
    // k and v of this (window, head): LPR threads a row, zero rows past N.
    const int rpp = blockDim.x / LPR;
    float kx[PASSES][4], vx[PASSES][4];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = threadIdx.x / LPR + p * rpp, c = (threadIdx.x % LPR) * 4;
#pragma unroll
      for (int u = 0; u < 4; ++u) kx[p][u] = vx[p][u] = 0.0f;
      if (r < N) {
        load4(k + base + (size_t)r * in.n + c, kx[p]);
        load4(v + base + (size_t)r * in.n + c, vx[p]);
      }
    }
    __syncthreads();  // the previous window's k̂ and v are read out
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = threadIdx.x / LPR + p * rpp, c = (threadIdx.x % LPR) * 4;
      if (r < np) {  // whole warps: a warp's rows are 32 / LPR consecutive ones
        float ss = 0.0f;
#pragma unroll
        for (int u = 0; u < 4; ++u) ss = fmaf(kx[p][u], kx[p][u], ss);
#pragma unroll
        for (int off = 1; off < LPR; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        const float inv = rsqrtf(ss + 1e-12f);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          kx[p][u] *= inv;
          vx[p][u] = round_to<T>(vx[p][u]);
        }
        if constexpr (QK_BF16)
          store4(static_cast<bf16*>(ks) + (size_t)r * PB + c, kx[p]);
        else
          store4(static_cast<float*>(ks) + (size_t)r * PF + c, kx[p]);
        if constexpr (V_BF16)
          store4(static_cast<bf16*>(vs) + (size_t)r * PB + c, vx[p]);
        else
          store4(static_cast<float*>(vs) + (size_t)r * PF + c, vx[p]);
      }
    }
    }

    // q̂ (or raw q) of rows i0, i1 as A fragments; the four lanes of a row
    // sum its squares with two shuffles.
    uint32_t qa[HD / 8][4], qlo[QK_BF16 ? 1 : HD / 8][4];
    float qinv0, qinv1;
    {
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          s0 = fmaf(x0[kk][u], x0[kk][u], s0);
          s1 = fmaf(x1[kk][u], x1[kk][u], s1);
        }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      qinv0 = rsqrtf(s0 + 1e-12f);
      qinv1 = rsqrtf(s1 + 1e-12f);
      const float f0 = QK_RAW ? 1.0f : qinv0, f1 = QK_RAW ? 1.0f : qinv1;
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
        if constexpr (QK_BF16) {
          qa[kk][0] = pack_bf16(x0[kk][0] * f0, x0[kk][1] * f0);
          qa[kk][1] = pack_bf16(x1[kk][0] * f1, x1[kk][1] * f1);
          qa[kk][2] = pack_bf16(x0[kk][2] * f0, x0[kk][3] * f0);
          qa[kk][3] = pack_bf16(x1[kk][2] * f1, x1[kk][3] * f1);
        } else {
          split_tf32(x0[kk][0] * f0, qa[kk][0], qlo[kk][0]);
          split_tf32(x1[kk][0] * f1, qa[kk][1], qlo[kk][1]);
          split_tf32(x0[kk][1] * f0, qa[kk][2], qlo[kk][2]);
          split_tf32(x1[kk][1] * f1, qa[kk][3], qlo[kk][3]);
        }
      }
    }
    __syncthreads();  // k̂ and v (and the norms of raw k) are in shared memory

    // S = q̂ k̂^T * scale + bias over all np keys, in registers.
    float s[NKT][4];
    if constexpr (QK_BF16) {
      // ldmatrix: (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7),
      // (keys 8-15, d 8-15) -> b0, b1 of key tile 0, b0, b1 of tile 1.
      const int mi = lane >> 3;
      const bf16* krow =
          static_cast<const bf16*>(ks) + (size_t)((mi >> 1) * 8 + (lane & 7)) * PB + (mi & 1) * 8;
#pragma unroll
      for (int u = 0; u < NKT / 2; ++u) {
        if (FULL || 2 * u < nkt) {
          float acc[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t b[4];
            ldmatrix_x4(b, krow + (size_t)16 * u * PB + kk * 16);
            float t0[4] = {}, t1[4] = {};
            mma_bf16(t0, qa[kk], b[0], b[1]);
            mma_bf16(t1, qa[kk], b[2], b[3]);
            add4(acc[0], t0);
            add4(acc[1], t1);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[2 * u][i] = acc[0][i];
            s[2 * u + 1][i] = acc[1][i];
          }
        }
      }
    } else {
      const float* krow = static_cast<const float*>(ks) + (size_t)g * PF + t;
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        if (FULL || kt < nkt) {
          float big[4] = {}, small[4] = {};
#pragma unroll
          for (int kk = 0; kk < HD / 8; ++kk) {
            const float* kp = krow + (size_t)8 * kt * PF + 8 * kk;
            uint32_t b0, b0s, b1, b1s;
            split_tf32(kp[0], b0, b0s);
            split_tf32(kp[4], b1, b1s);
            float tb[4] = {};
            mma_tf32(tb, qa[kk], b0, b1);
            add4(big, tb);
            mma_tf32(small, qa[kk], b0s, b1s);
            mma_tf32(small, qlo[kk], b0, b1);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) s[kt][i] = __fadd_rn(big[i], small[i]);
        }
      }
    }

    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) {
      if (FULL || kt < nkt) {
        const float2 b0 = *reinterpret_cast<const float2*>(bias_s + (size_t)r0 * bp + 8 * kt + 2 * t);
        const float2 b1 =
            *reinterpret_cast<const float2*>(bias_s + (size_t)(r0 + 8) * bp + 8 * kt + 2 * t);
        if constexpr (QK_RAW) {  // q̂ . k̂ = (q . k) * (1 / |q|) * (1 / |k|)
          const float2 ik = *reinterpret_cast<const float2*>(inv_k + 8 * kt + 2 * t);
          s[kt][0] = __fmul_rn(__fmul_rn(s[kt][0], qinv0), ik.x);
          s[kt][1] = __fmul_rn(__fmul_rn(s[kt][1], qinv0), ik.y);
          s[kt][2] = __fmul_rn(__fmul_rn(s[kt][2], qinv1), ik.x);
          s[kt][3] = __fmul_rn(__fmul_rn(s[kt][3], qinv1), ik.y);
        }
        s[kt][0] = __fadd_rn(__fmul_rn(s[kt][0], sc), b0.x);
        s[kt][1] = __fadd_rn(__fmul_rn(s[kt][1], sc), b0.y);
        s[kt][2] = __fadd_rn(__fmul_rn(s[kt][2], sc), b1.x);
        s[kt][3] = __fadd_rn(__fmul_rn(s[kt][3], sc), b1.y);
        m0 = fmaxf(m0, fmaxf(s[kt][0], s[kt][1]));
        m1 = fmaxf(m1, fmaxf(s[kt][2], s[kt][3]));
      }
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) {
      if (FULL || kt < nkt) {
        s[kt][0] = expf(s[kt][0] - m0);
        s[kt][1] = expf(s[kt][1] - m0);
        s[kt][2] = expf(s[kt][2] - m1);
        s[kt][3] = expf(s[kt][3] - m1);
        l0 += s[kt][0] + s[kt][1];
        l1 += s[kt][2] + s[kt][3];
      }
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    // p = e * (1 / l): rounds as e / l does but for a one-ulp f32
    // difference (attn_core.cuh), rarer than one from the order of the sum.
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;

    // out = P V.
    if constexpr (PV_SEQ) {
      // B1 in bf16: an FMA chain over the keys in order per output, as the
      // plain version sums P V. Lane t of a quad owns head dims DPT t ..
      // DPT t + DPT - 1 of rows g and g + 8; the quad's lanes pass each
      // other their two keys' probabilities of each row, packed in bf16.
      constexpr int DPT = HD / 4;
      // The row's probabilities rounded to bf16 first, two keys a register,
      // so that the logits' registers are free during the chains.
      uint32_t pg[NKT], pg8[NKT];
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        if (FULL || kt < nkt) {
          pg[kt] = pack_bf16(s[kt][0] * inv0, s[kt][1] * inv0);
          pg8[kt] = pack_bf16(s[kt][2] * inv1, s[kt][3] * inv1);
        }
      }
      float acc0[DPT] = {}, acc1[DPT] = {};
      const float* vcol = static_cast<const float*>(vs) + DPT * t;
      const int quad = lane & ~3;
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        if (FULL || kt < nkt) {
#pragma unroll
          for (int tp = 0; tp < 4; ++tp) {
            const uint32_t a0 = __shfl_sync(0xffffffffu, pg[kt], quad | tp);
            const uint32_t a1 = __shfl_sync(0xffffffffu, pg8[kt], quad | tp);
            const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a0));
            const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a1));
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float* vr = vcol + (size_t)(8 * kt + 2 * tp + e) * PF;
              const float pa = e == 0 ? p0.x : p0.y, pb = e == 0 ? p1.x : p1.y;
#pragma unroll
              for (int d4 = 0; d4 < DPT; d4 += 4) {
                const float4 v4 = *reinterpret_cast<const float4*>(vr + d4);
                const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  acc0[d4 + u] = fmaf(pa, vv[u], acc0[d4 + u]);
                  acc1[d4 + u] = fmaf(pb, vv[u], acc1[d4 + u]);
                }
              }
            }
          }
        }
      }
      T* orow = out + (size_t)w * ol.w + (size_t)h * ol.h + DPT * t;
#pragma unroll
      for (int d = 0; d < DPT; d += 2) {
        if (i0 < N) store2(orow + (size_t)i0 * ol.n + d, acc0[d], acc0[d + 1]);
        if (i1 < N) store2(orow + (size_t)i1 * ol.n + d, acc1[d], acc1[d + 1]);
      }
      continue;
    }
    float o[HD / 8][4] = {};
    if constexpr (PV_BF16) {
      // ldmatrix.trans of V: (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys
      // 0-7, d 8-15), (keys 8-15, d 8-15) -> b0, b1 of d tile 0, of tile 1.
      const int mi = lane >> 3;
      const bf16* vrow =
          static_cast<const bf16*>(vs) + (size_t)((mi & 1) * 8 + (lane & 7)) * PB + (mi >> 1) * 8;
#pragma unroll
      for (int u = 0; u < NKT / 2; ++u) {
        if (FULL || 2 * u < nkt) {
          uint32_t pa[4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            pa[2 * n] = pack_bf16(s[2 * u + n][0] * inv0, s[2 * u + n][1] * inv0);
            pa[2 * n + 1] = pack_bf16(s[2 * u + n][2] * inv1, s[2 * u + n][3] * inv1);
          }
#pragma unroll
          for (int dd = 0; dd < HD / 16; ++dd) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vrow + (size_t)16 * u * PB + dd * 16);
            float t0[4] = {}, t1[4] = {};
            mma_bf16(t0, pa, bv[0], bv[1]);
            mma_bf16(t1, pa, bv[2], bv[3]);
            add4(o[2 * dd], t0);
            add4(o[2 * dd + 1], t1);
          }
        }
      }
    } else {
      float osmall[HD / 8][4] = {};
      // Key k-index t <-> key 2t, t + 4 <-> 2t + 1 of each 8-key tile.
      const float* vrow = static_cast<const float*>(vs) + (size_t)(2 * t) * PF + g;
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        if (FULL || kt < nkt) {
          uint32_t pa[4], pl[4];
          split_tf32(s[kt][0] * inv0, pa[0], pl[0]);
          split_tf32(s[kt][2] * inv1, pa[1], pl[1]);
          split_tf32(s[kt][1] * inv0, pa[2], pl[2]);
          split_tf32(s[kt][3] * inv1, pa[3], pl[3]);
          const float* v0 = vrow + (size_t)8 * kt * PF;
#pragma unroll
          for (int dn = 0; dn < HD / 8; ++dn) {
            uint32_t b0, b0s, b1, b1s;
            split_tf32(v0[8 * dn], b0, b0s);
            split_tf32(v0[PF + 8 * dn], b1, b1s);
            float tb[4] = {};
            mma_tf32(tb, pa, b0, b1);
            add4(o[dn], tb);
            mma_tf32(osmall[dn], pa, b0s, b1s);
            mma_tf32(osmall[dn], pl, b0, b1);
          }
        }
      }
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) add4(o[dn], osmall[dn]);
    }

    T* obase = out + (size_t)w * ol.w + (size_t)h * ol.h + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (i0 < N) store2(obase + (size_t)i0 * ol.n + 8 * n, o[n][0], o[n][1]);
      if (i1 < N) store2(obase + (size_t)i1 * ol.n + 8 * n, o[n][2], o[n][3]);
    }
  }
}

template <typename TIN, typename T, bool ROUND_QK, int HD, int NKT>
int launch_window_mma(const TIN* q, const TIN* k, const TIN* v, WinLayout in, T* out,
                      WinLayout ol, const float* rpb, const float* scale, const float* mask,
                      int W, int H, int nW, int N, cudaStream_t stream) {
  constexpr bool pv_bf16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr bool qk_raw = !ROUND_QK && std::is_same_v<TIN, __nv_bfloat16>;
  auto kernel = N == 8 * NKT ? window_attn_mma_kernel<TIN, T, ROUND_QK, HD, NKT, true>
                             : window_attn_mma_kernel<TIN, T, ROUND_QK, HD, NKT, false>;
  const size_t smem =
      window_mma_smem_bytes(N, HD, (ROUND_QK && pv_bf16) || qk_raw, pv_bf16 && !ROUND_QK, qk_raw);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int nWm = mask != nullptr ? nW : 1;
  const int items = W / nWm;
  const int warps = window_mma_warps(N);
  const int qtiles = (N + 16 * warps - 1) / (16 * warps);
  // Item groups: enough blocks for ~kWinBlocksPerSm per SM, each walking
  // as many windows of its class over its bias tile as that leaves.
  const int base = qtiles * H * nWm;
  const int want = (kWinBlocksPerSm * sms + base - 1) / base;
  const int per_block = (items + min(items, max(1, want)) - 1) / min(items, max(1, want));
  const int groups = (items + per_block - 1) / per_block;
  const dim3 grid(qtiles, H * nWm, groups);
  kernel<<<grid, 32 * warps, smem, stream>>>(q, k, v, in, out, ol, rpb, scale, mask, nWm, items,
                                             per_block, N);
  return (int)cudaGetLastError();
}

template <typename TIN, typename T, bool ROUND_QK>
int launch_window_attn_mma(const TIN* q, const TIN* k, const TIN* v, WinLayout in, T* out,
                           WinLayout ol, const float* rpb, const float* scale,
                           const float* mask, int W, int H, int nW, int N, int hd,
                           cudaStream_t stream) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  if (hd == 16)
    return N <= 64 ? launch_window_mma<TIN, T, ROUND_QK, 16, 8>(q, k, v, in, out, ol, rpb, scale,
                                                                mask, W, H, nW, N, stream)
                   : launch_window_mma<TIN, T, ROUND_QK, 16, 32>(q, k, v, in, out, ol, rpb,
                                                                 scale, mask, W, H, nW, N, stream);
  return N <= 64 ? launch_window_mma<TIN, T, ROUND_QK, 32, 8>(q, k, v, in, out, ol, rpb, scale,
                                                              mask, W, H, nW, N, stream)
                 : launch_window_mma<TIN, T, ROUND_QK, 32, 32>(q, k, v, in, out, ol, rpb, scale,
                                                               mask, W, H, nW, N, stream);
}

// Launch over W windows x H heads; `mask` == nullptr adds no mask. Returns a
// cudaError_t: cudaErrorMisalignedAddress where the tensor-core core cannot
// take the operands, and a shape past the shared-memory limit fails at the
// attribute.
template <typename TIN, typename T, bool ROUND_QK>
int launch_window_attn(const TIN* q, const TIN* k, const TIN* v, WinLayout in, T* out,
                       WinLayout ol, const float* rpb, const float* scale, const float* mask,
                       int W, int H, int nW, int N, int hd, cudaStream_t stream) {
  if (window_core_is_mma(N, hd))
    return launch_window_attn_mma<TIN, T, ROUND_QK>(q, k, v, in, out, ol, rpb, scale, mask, W, H,
                                                    nW, N, hd, stream);
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
