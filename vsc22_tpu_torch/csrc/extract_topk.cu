// B5: for each query row and each `tile_r`-wide block of reference columns,
// the top `e` scores of q . r^T with their global column indices.
//
// Replaces the Pallas kernel vsc22_tpu/ops/pallas_topk.py `extract_topk`
// (:83; its pallas_call at :100, kernel body `_extract_kernel` :52). The
// TPU kernel splits f32 operands into bf16 hi/lo pairs because Mosaic has
// no f32 product; here the searcher's own operands, f16 (the eval's
// transfer type), bf16 (its `compute_dtype`) or f32, are read as they are
// and summed in f32, never TF32: f16 x f16 and bf16 x bf16 products are
// exact in f32 (see row_max.cu). Columns at
// or past `num_valid` score float32's lowest value, and among equal scores
// the lowest column wins, as `argmax` does in the TPU peel.
//
// What bounds it on the H100: 2 * Nq * Nr * D FLOPs over (Nq + Nr) * D
// operand bytes. At the search's shape (a 4096-row query tile against
// 1.28M refs, D 512) that is 5.4 TFLOP against 1.3 GB of f16 refs: ~5.4 ms
// at the card's f16 tensor-core peak and ~0.4 ms of HBM, so it is
// compute-bound.
//
// Two product loops, by a static rule (`topk_is_mma`, mirrored by
// ops/topk.py `topk_route`, which passes the route in): f16 or bf16
// operands with D % 8 == 0 and 16-byte-aligned bases take the tensor
// cores; f32 operands and f16 at every other D take the FFMA tile. bf16
// has no FFMA route: off the rule it is refused. Both fold each finished
// 128x128 sub-tile of scores from shared memory into per-thread top-e
// lists, so the [128, tile_r] score block never reaches HBM.
//
// The tensor-core kernel: one block of 256 threads per (128-query tile,
// ref block). It loops over the block's 128-column sub-tiles, each the
// tile of gemm_nt.cuh `mma_nt_tile<T>` (mma.sync m16n8k16, f16 or bf16
// operands through a 3-stage cp.async ring and ldmatrix, each mma's
// 16-term partial joined to the f32 sums by a round-to-nearest add). The
// finished accumulator fragments go to shared memory over the ring's own
// bytes (the ring is drained by then), and each thread folds half a row
// of them, 4 columns of every 8, into a sorted top-e list with an early
// reject against its e-th entry. The lists wait in shared memory while
// the next sub-tile's product runs, so they cost no registers there: at
// most 128 registers and 86 KB of shared memory per block let two blocks
// share an SM, one folding while the other multiplies. The query tile is
// streamed with each sub-tile, not kept resident: a resident 128 x 512 f16
// tile (133 KB) would leave room for one block per SM, and its re-reads
// come from L2 at 64 FLOP per byte.
//
// The FFMA kernel (f32 and off-rule f16): the same blocks over the
// 128x128 product of `mainloop128` (gemm_nt.cuh: an 8x8 micro-tile per
// thread, f32 slices staged 8 deep in two shared buffers, one 8- or
// 16-byte global load per 4 elements where D % 4 == 0, the ragged D and
// Nr zero-filled); each thread folds half a row of the staged sub-tile
// (84,480 bytes of shared memory per block, two blocks per SM). Its
// floor is ~80 ms at the f32 FFMA peak at the search's shape.
//
// Both: at the end the two halves of a row merge with one warp shuffle.
// Sub-tiles entirely past num_valid skip the product. The grid runs the
// query tiles of one ref block side by side, so a ref block is read from
// HBM about once and served to the other query tiles from L2. e is a
// template parameter, 1 to 8.
#include <climits>

#include "gemm_nt.cuh"

namespace vsc22 {
namespace topk {

constexpr int kTile = kT128;  // query rows and ref columns of a sub-tile
constexpr float kLowest = -3.402823466e38f;  // float32 min, the masked score

struct Smem {
  Tile128Smem t;                 // the product's staged slices
  float s[kTile][kTile + kPad];  // one finished sub-tile of scores
};

// (v1, c1) ranks before (v2, c2): higher score, then lower column.
__device__ __forceinline__ bool ranks_before(float v1, int c1, float v2, int c2) {
  return v1 > v2 || (v1 == v2 && c1 < c2);
}

// Insert (nv, nc) into a list kept sorted by ranks_before; the last entry
// drops out. Static indices only, so the list stays in registers.
template <int E>
__device__ __forceinline__ void insert(float (&v)[E], int (&c)[E], float nv, int nc) {
  if (!ranks_before(nv, nc, v[E - 1], c[E - 1])) return;
  v[E - 1] = nv;
  c[E - 1] = nc;
#pragma unroll
  for (int p = E - 1; p > 0; --p) {
    if (ranks_before(v[p], c[p], v[p - 1], c[p - 1])) {
      const float tv = v[p];
      v[p] = v[p - 1];
      v[p - 1] = tv;
      const int tc = c[p];
      c[p] = c[p - 1];
      c[p - 1] = tc;
    }
  }
}

// The 128x128 sub-tile at (m0, n0) into sm.s.
template <typename T>
__device__ __forceinline__ void product_tile(const T* __restrict__ q, const T* __restrict__ r,
                                             int m0, int n0, int Nq, int Nr, int D, Smem& sm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
  mainloop128(q, r, m0, n0, Nq, Nr, D, sm.t, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = tile128_index(ty, i);
    *reinterpret_cast<float4*>(&sm.s[row][4 * tx]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&sm.s[row][64 + 4 * tx]) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// blockIdx.x: 128-row query tile; blockIdx.y: ref block. Outputs are
// [nb, E, Nq]: out[(blk * E + p) * Nq + row].
template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 2)
    extract_topk_kernel(const T* __restrict__ q, const T* __restrict__ r,
                        float* __restrict__ out_s, int* __restrict__ out_i, int Nq, int Nr,
                        int D, int num_valid, int tile_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int m0 = blockIdx.x * kTile;
  const int col0 = blockIdx.y * tile_r, col_end = col0 + tile_r;
  // Selection: thread t folds half h of row `sel_row` of each sub-tile.
  const int sel_row = threadIdx.x / 2, h = threadIdx.x % 2;

  float v[E];
  int c[E];
#pragma unroll
  for (int p = 0; p < E; ++p) {
    v[p] = -INFINITY;  // below every real score, masked ones included
    c[p] = INT_MAX;
  }

  for (int n0 = col0; n0 < col_end; n0 += kTile) {
    // The same n0 for the whole block, so every barrier inside is reached
    // by every thread or by none.
    const bool computed = n0 < num_valid;
    if (computed) {
      product_tile(q, r, m0, n0, Nq, Nr, D, sm);
      __syncthreads();
    }
    for (int j = 0; j < kTile / 2; ++j) {
      const int col = n0 + h * (kTile / 2) + j;
      if (col >= col_end) break;
      insert<E>(v, c, (computed && col < num_valid) ? sm.s[sel_row][col - n0] : kLowest, col);
    }
    __syncthreads();  // sm.s is rewritten by the next sub-tile
  }

  // The two halves of a row are neighbouring lanes of one warp.
  float pv[E];
  int pc[E];
#pragma unroll
  for (int p = 0; p < E; ++p) {
    pv[p] = __shfl_xor_sync(0xffffffffu, v[p], 1);
    pc[p] = __shfl_xor_sync(0xffffffffu, c[p], 1);
  }
#pragma unroll
  for (int p = 0; p < E; ++p) insert<E>(v, c, pv[p], pc[p]);
  const int m = m0 + sel_row;
  if (h == 0 && m < Nq) {
#pragma unroll
    for (int p = 0; p < E; ++p) {
      const size_t o = ((size_t)blockIdx.y * E + p) * Nq + m;
      out_s[o] = v[p];
      out_i[o] = c[p];
    }
  }
}

// ---- the tensor-core kernel (f16 or bf16, D % 8 == 0, 16-byte-aligned) ----

enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };  // ops/topk.py `_DTYPE_CODE`

inline bool topk_is_mma(int dtype, int D, const void* q, const void* r) {
  return (dtype == kF16 || dtype == kBF16) && D % 8 == 0 && aligned16(q) && aligned16(r);
}

constexpr int kScorePitch = kMmaBN + 8;  // f32 scores; float2 stores free of bank conflicts
constexpr size_t kScoreBytes = sizeof(float) * kMmaBM * kScorePitch;
constexpr size_t kMmaStageBytes = kScoreBytes > kGemmMmaSmem ? kScoreBytes : kGemmMmaSmem;

// Shared memory of a block: the product's ring, then the same bytes as the
// finished sub-tile's scores, then each thread's list (thread-major, so the
// list accesses are free of bank conflicts).
template <int E>
constexpr size_t mma_smem_bytes() {
  return kMmaStageBytes + (size_t)E * kMmaThreads * (sizeof(float) + sizeof(int));
}

// SELECT false is a probe variant: the products alone (each thread sums its
// accumulators so that nothing is dead code), no staging and no selection;
// it writes nothing unless a sum is exactly -1.
template <typename T, int E, bool SELECT>
__global__ void __launch_bounds__(kMmaThreads, 2)
    extract_topk_mma_kernel(const T* __restrict__ q, const T* __restrict__ r,
                            float* __restrict__ out_s, int* __restrict__ out_i, int Nq, int Nr,
                            int D, int num_valid, int tile_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float(*sc)[kScorePitch] = reinterpret_cast<float(*)[kScorePitch]>(smem_raw);
  float* lv = reinterpret_cast<float*>(smem_raw + kMmaStageBytes);  // [E][threads]
  int* lc = reinterpret_cast<int*>(lv + E * kMmaThreads);          // [E][threads]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kMmaBM;
  const int col0 = blockIdx.y * tile_r, col_end = col0 + tile_r;
  // Selection: thread t folds half h of row `sel_row`: columns 8 j + 4 h .. + 3.
  const int sel_row = tid / 2, h = tid % 2;
  // Accumulator fragments: rows wm + 16 mt + g (+ 8), columns wn + 8 nt + c2 (+ 1).
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  float sink = 0.0f;
#pragma unroll
  for (int p = 0; p < E; ++p) {
    lv[p * kMmaThreads + tid] = -INFINITY;  // below every real score, masked ones included
    lc[p * kMmaThreads + tid] = INT_MAX;
  }

  for (int n0 = col0; n0 < col_end; n0 += kMmaBN) {
    // The same n0 for the whole block, so every barrier inside is reached
    // by every thread or by none.
    const bool computed = n0 < num_valid;
    if (computed) {
      float acc[4][4][4];
      mma_nt_tile(q, r, m0, n0, Nq, Nr, D, ring, acc);  // ends past a barrier
      if constexpr (!SELECT) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) sink += acc[mt][nt][i];
        continue;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(&sc[wm + mt * 16 + g + 8 * hf][wn + nt * 8 + c2]) =
                make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      __syncthreads();
    }
    if constexpr (SELECT) {
      float v[E];
      int c[E];
#pragma unroll
      for (int p = 0; p < E; ++p) {
        v[p] = lv[p * kMmaThreads + tid];
        c[p] = lc[p * kMmaThreads + tid];
      }
#pragma unroll 4
      for (int j = 0; j < kMmaBN / 8; ++j) {
        const int cb = 8 * j + 4 * h;
        float4 s4 = make_float4(kLowest, kLowest, kLowest, kLowest);
        if (computed) s4 = *reinterpret_cast<const float4*>(&sc[sel_row][cb]);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = n0 + cb + u;
          if (col < col_end) insert<E>(v, c, col < num_valid ? sv[u] : kLowest, col);
        }
      }
#pragma unroll
      for (int p = 0; p < E; ++p) {
        lv[p * kMmaThreads + tid] = v[p];
        lc[p * kMmaThreads + tid] = c[p];
      }
      __syncthreads();  // the scores' bytes are the next sub-tile's ring
    }
  }

  if constexpr (!SELECT) {
    if (sink == -1.0f) out_s[(size_t)blockIdx.y * Nq + blockIdx.x] = sink;
    return;
  }
  float v[E], pv[E];
  int c[E], pc[E];
#pragma unroll
  for (int p = 0; p < E; ++p) {
    v[p] = lv[p * kMmaThreads + tid];
    c[p] = lc[p * kMmaThreads + tid];
  }
  // The two halves of a row are neighbouring lanes of one warp.
#pragma unroll
  for (int p = 0; p < E; ++p) {
    pv[p] = __shfl_xor_sync(0xffffffffu, v[p], 1);
    pc[p] = __shfl_xor_sync(0xffffffffu, c[p], 1);
  }
#pragma unroll
  for (int p = 0; p < E; ++p) insert<E>(v, c, pv[p], pc[p]);
  const int m = m0 + sel_row;
  if (h == 0 && m < Nq) {
#pragma unroll
    for (int p = 0; p < E; ++p) {
      const size_t o = ((size_t)blockIdx.y * E + p) * Nq + m;
      out_s[o] = v[p];
      out_i[o] = c[p];
    }
  }
}

template <typename T, int E, bool SELECT = true>
cudaError_t launch_mma(const void* q, const void* r, float* s, int* idx, int Nq, int Nr, int D,
                       int num_valid, int tile_r, int nb, cudaStream_t stream) {
  const auto kernel = extract_topk_mma_kernel<T, E, SELECT>;
  constexpr size_t smem = mma_smem_bytes<E>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Nq + kMmaBM - 1) / kMmaBM, nb);
  kernel<<<grid, kMmaThreads, smem, stream>>>(static_cast<const T*>(q),
                                              static_cast<const T*>(r), s, idx, Nq, Nr, D,
                                              num_valid, tile_r);
  return cudaGetLastError();
}

// ---- dispatch ----------------------------------------------------------------

template <typename T, int E>
cudaError_t launch(const void* q, const void* r, float* s, int* idx, int Nq, int Nr, int D,
                   int num_valid, int tile_r, int nb, cudaStream_t stream) {
  const auto kernel = extract_topk_kernel<T, E>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Nq + kTile - 1) / kTile, nb);
  kernel<<<grid, kThreads, sizeof(Smem), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(r), s, idx, Nq, Nr, D, num_valid, tile_r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_e(int e, const void* q, const void* r, float* s, int* idx, int Nq, int Nr,
                       int D, int num_valid, int tile_r, int nb, cudaStream_t stream) {
  switch (e) {
    case 1: return launch<T, 1>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 2: return launch<T, 2>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 3: return launch<T, 3>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 4: return launch<T, 4>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 5: return launch<T, 5>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 6: return launch<T, 6>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 7: return launch<T, 7>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 8: return launch<T, 8>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_mma(int e, const void* q, const void* r, float* s, int* idx, int Nq, int Nr,
                         int D, int num_valid, int tile_r, int nb, cudaStream_t stream) {
  switch (e) {
    case 1: return launch_mma<T, 1>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 2: return launch_mma<T, 2>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 3: return launch_mma<T, 3>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 4: return launch_mma<T, 4>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 5: return launch_mma<T, 5>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 6: return launch_mma<T, 6>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 7: return launch_mma<T, 7>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    case 8: return launch_mma<T, 8>(q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace topk
}  // namespace vsc22

// q: [Nq, D], r: [Nr, D], both of `dtype` (0 f32, 1 f16, 2 bf16),
// contiguous; D >= 1; 1 <= e <= 8; tile_r >= e; 0 <= num_valid <= Nr;
// nb = ceil(Nr / tile_r) <= 65535. s: f32 [nb, e, Nq], idx: i32 [nb, e, Nq].
// mma == 1 takes the tensor-core kernel, which needs `topk_is_mma` (else
// the call fails with cudaErrorInvalidValue); mma == 0 the FFMA kernel,
// which takes f32 and f16 only.
extern "C" int vsc22_extract_topk(const void* q, const void* r, float* s, int* idx, int Nq,
                                  int Nr, int D, int num_valid, int tile_r, int e, int nb,
                                  int dtype, int mma, void* stream) {
  using namespace vsc22::topk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (!topk_is_mma(dtype, D, q, r)) return (int)cudaErrorInvalidValue;
    if (dtype == kBF16)
      return (int)dispatch_mma<__nv_bfloat16>(e, q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb,
                                              st);
    return (int)dispatch_mma<__half>(e, q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, st);
  }
  if (dtype == kF16)
    return (int)dispatch_e<__half>(e, q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, st);
  if (dtype == kF32)
    return (int)dispatch_e<float>(e, q, r, s, idx, Nq, Nr, D, num_valid, tile_r, nb, st);
  return (int)cudaErrorInvalidValue;
}

// Probe only (scripts/torch_topk_probe.py): the tensor-core kernel's
// products without the selection, on vsc22_extract_topk's grid and
// operands (f16, `topk_is_mma`); s needs nb * Nq floats and is written
// only where a thread's sum is exactly -1.
extern "C" int vsc22_extract_topk_products(const void* q, const void* r, float* s, int Nq,
                                           int Nr, int D, int num_valid, int tile_r, int nb,
                                           void* stream) {
  using namespace vsc22::topk;
  if (!topk_is_mma(kF16, D, q, r)) return (int)cudaErrorInvalidValue;
  return (int)launch_mma<__half, 1, false>(q, r, s, nullptr, Nq, Nr, D, num_valid, tile_r, nb,
                                           static_cast<cudaStream_t>(stream));
}
