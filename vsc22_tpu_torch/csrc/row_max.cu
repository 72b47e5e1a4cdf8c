// K3: out[i] = max_j q_i . r_j, without materialising [Nq, Nr].
//
// Replaces the Pallas kernel vsc22_tpu/ops/pallas_sim.py `_row_max_call`
// (its pallas_call at :63; wrapper `row_max_gemm` :78): operands rounded
// to f16 by the caller, products summed in f32. f16 x f16 products are
// exact in f32 (TF32 would not keep them: its 10-bit mantissa cannot hold
// the 22 bits of such a product).
//
// What bounds it on the H100: 2*Nq*Nr*D FLOPs over (Nq + Nr)*D*2 bytes.
// Score-norm calls it at two kinds of shape: the query pass's few query
// frames against the 2,000-frame noise corpus (27 x 2000 x 511: 55 MFLOP,
// where launch latency and a filled card matter more than either
// roofline), and the eval's 32,000 or 320,000 query frames against
// 128,000 noise frames (4.2e12 and 4.2e13 FLOP, compute-bound on the f16
// tensor cores: 4.2 and 42 ms at their peak).
//
// Design: the f16 tensor-core tile of gemm_nt.cuh (`mma_nt_tile<__half>`:
// a 128x128 block tile over 8 warps, mma.sync m16n8k16 fed by ldmatrix
// from a 3-stage cp.async ring, each mma's 16-term partial joined to the
// f32 sums by a round-to-nearest add) with a running max per row as its
// epilogue, kept in registers across the ref sub-tiles. The grid splits
// the queries into 128-row tiles and the refs into `splits` contiguous,
// non-empty, balanced chunks (ops/sim.py `row_max_grid` picks them so
// that the grid holds at least two blocks per SM: 264 one-tile splits of
// 7 or 8 refs at the query pass). The four lanes and the four warps that
// share a row then combine their maxima, and the splits' partial maxima,
// by atomicMax on an order-preserving unsigned key of the float (sign
// bit flipped for positives, all bits for negatives: -inf < ... < -0.0 <
// +0.0 < ... < +inf). A max is order-free, so the result is
// deterministic. One pass before (`pad_f16_kernel`) rounds both operands
// to f16 into copies whose D is padded with zeros to a multiple of 16
// (exact zeros in every sum; every 16-byte load whole and aligned) and
// gives every row key 0 (below every float's key); a decode pass after
// turns keys back into floats in place. At the query pass's shape the
// host's time per call (PyTorch's allocations and stream lookup, three
// launches) is as long as the card's, so the call keeps host work short:
// one scratch allocation, the shared-memory attribute set once per device.
#include "gemm_nt.cuh"

namespace vsc22 {

__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// blockIdx.x: 128-row query tile; blockIdx.y: ref split. keys: [Nq].
__global__ void __launch_bounds__(kMmaThreads, 2)
    row_max_mma_kernel(const __half* __restrict__ q, const __half* __restrict__ r,
                       unsigned* __restrict__ keys, int Nq, int Nr, int D, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __half* ring = reinterpret_cast<__half*>(smem_raw);
  const int m0 = blockIdx.x * kMmaBM;
  const int c0 = (int)((long long)blockIdx.y * Nr / splits);
  const int c1 = (int)((long long)(blockIdx.y + 1) * Nr / splits);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  // best[mt][hf]: row wm + 16 mt + g + 8 hf of the tile
  float best[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) best[mt][0] = best[mt][1] = -INFINITY;
  for (int n0 = c0; n0 < c1; n0 += kMmaBN) {
    float acc[4][4][4];
    // refs past the split's end are zero-filled, never read
    mma_nt_tile(q, r, m0, n0, Nq, c1, D, ring, acc);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (n0 + wn + nt * 8 + c2 + u >= c1) continue;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            best[mt][hf] = fmaxf(best[mt][hf], acc[mt][nt][2 * hf + u]);
      }
  }
  // The four lanes of a quad hold the same rows.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = best[mt][hf];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int m = m0 + wm + mt * 16 + g + 8 * hf;
      if ((lane & 3) == 0 && m < Nq) atomicMax(&keys[m], order_key(v));
    }
}

// Row blockIdx.x of q (rows < Nq) or of r, rounded to f16, zero past D,
// into qh / rh [rows, Dp]; keys of the q rows set to 0.
__global__ void pad_f16_kernel(const float* __restrict__ q, const float* __restrict__ r,
                               __half* __restrict__ qh, __half* __restrict__ rh,
                               unsigned* __restrict__ keys, int Nq, int D, int Dp) {
  const int row = blockIdx.x;
  const bool is_q = row < Nq;
  const size_t rr = is_q ? row : row - Nq;
  const float* src = (is_q ? q : r) + rr * D;
  __half* dst = (is_q ? qh : rh) + rr * Dp;
  for (int c = threadIdx.x; c < Dp; c += blockDim.x)
    dst[c] = __float2half_rn(c < D ? src[c] : 0.0f);
  if (is_q && threadIdx.x == 0) keys[row] = 0u;
}

__global__ void decode_keys_kernel(unsigned* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) reinterpret_cast<float*>(keys)[i] = from_order_key(keys[i]);
}

// The kernel's shared-memory attribute, set once on each device.
inline cudaError_t allow_ring_smem() {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(row_max_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGemmMmaSmem);
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

}  // namespace vsc22

// q: f32 [Nq, D], r: f32 [Nr, D] (Nr >= 1), contiguous; scratch: 16-byte
// aligned, (Nq + Nr) * Dp f16 (the padded copies of q, then of r), Dp = D
// rounded up to a multiple of 16; 1 <= splits <= Nr; out: f32 [Nq].
extern "C" int vsc22_row_max(const float* q, const float* r, void* scratch, float* out,
                             int Nq, int Nr, int D, int Dp, int splits, void* stream) {
  using namespace vsc22;
  if (Dp % 16 != 0 || Dp < D || D < 1 || !aligned16(scratch) || splits < 1 || splits > Nr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = allow_ring_smem();
  if (err != cudaSuccess) return (int)err;
  unsigned* keys = reinterpret_cast<unsigned*>(out);
  __half* qf = static_cast<__half*>(scratch);
  __half* rf = qf + (size_t)Nq * Dp;  // 16-byte aligned: Dp % 16 == 0
  pad_f16_kernel<<<Nq + Nr, 128, 0, st>>>(q, r, qf, rf, keys, Nq, D, Dp);
  const dim3 grid((Nq + kMmaBM - 1) / kMmaBM, splits);
  row_max_mma_kernel<<<grid, kMmaThreads, kGemmMmaSmem, st>>>(qf, rf, keys, Nq, Nr, Dp, splits);
  decode_keys_kernel<<<(Nq + 255) / 256, 256, 0, st>>>(keys, Nq);
  return (int)cudaGetLastError();
}
