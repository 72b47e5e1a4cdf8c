// Warp-level tensor-core building blocks shared by the hand kernels
// (attn_core.cuh, window_attn.cuh, gemm_nt.cuh): shared-memory addresses,
// 16-byte cp.async copies, ldmatrix, mma.sync (bf16 and f16 m16n8k16, tf32
// m16n8k8), wgmma (tf32 m64n128k8, A in registers) and the bf16 / tf32
// packing of f32 values.
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

// ---- wgmma (sm_90a): warpgroup products, B from shared memory ----------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of v across this point
// (a wgmma in flight owns its accumulators until wgmma_wait).
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// A K-major wgmma operand in shared memory in the 128-byte swizzle: rows
// of 128 bytes (32 tf32), eight-row groups of 1024 bytes, the 16-byte
// chunk q of row r stored at chunk q ^ (r % 8); the group base 1024-byte
// aligned. `p` is the group base plus the byte offset of the k step's
// first chunk (a multiple of 32 bytes inside the row).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fff) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d = (scale_d ? d : 0) + a b for one warpgroup, tf32 operands, f32
// accumulators: a the m64 x k8 tile in registers (warp w of the group its
// rows 16 w .. 16 w + 15, in mma.m16n8k8's A layout), b an n128 x k8
// K-major tile in shared memory (`wgmma_desc_sw128`). d[4 j .. 4 j + 3] is
// the n8 tile j in mma.m16n8's accumulator layout, rows 16 w + g and + 8.
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace vsc22
