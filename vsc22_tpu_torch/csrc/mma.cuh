// Warp-level tensor-core building blocks shared by the hand kernels
// (attn_core.cuh, window_attn.cuh, gemm_nt.cuh): shared-memory addresses,
// 16-byte cp.async copies, ldmatrix, mma.sync (bf16 and f16 m16n8k16, tf32
// m16n8k8) and the bf16 / tf32 packing of f32 values.
//
// Fragment layouts (PTX ISA, warp-level mma): lane = 4 g + t. An f32
// accumulator tile m16n8 gives a thread rows g and g + 8 at columns 2t and
// 2t + 1: d[0], d[1] on row g, d[2], d[3] on row g + 8.
//  - bf16 and f16 m16n8k16: A regs (row g, k 2t..2t+1), (g + 8, 2t..), (g, 2t+8..),
//    (g + 8, 2t+8..); B regs (k 2t..2t+1, col g), (k 2t+8.., col g).
//  - tf32 m16n8k8: A (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
//    B (k t, col g), (k t + 4, col g).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace vsc22 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// 16 bytes from gmem if `full`, else 16 zero bytes (nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool full) {
  const int src_bytes = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b: one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: one m16n8k16 tile, f16 operands, f32 accumulators.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The m16n8k16 product of the operands' type, for loops templated on it.
__device__ __forceinline__ void mma_16x8x16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1, __nv_bfloat16) {
  mma_bf16(d, a, b0, b1);
}
__device__ __forceinline__ void mma_16x8x16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1, __half) {
  mma_f16(d, a, b0, b1);
}

// d += a b: one m16n8k8 tile, tf32 operands (f32 bit patterns with the low
// 13 mantissa bits zero), f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = big + small to about 2^-22 |x|: big is x rounded to tf32 (11
// significant bits), small the remainder rounded to tf32. Three tf32
// products big*big + big*small + small*big then carry a product to about
// f32 accuracy ("3xTF32"); the dropped small*small is below 2^-22.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace vsc22
