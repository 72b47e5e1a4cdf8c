// Tensor-core ceilings of one H100 for the port's GEMM loops: the rate of
// back-to-back mma.sync (tf32 m16n8k8 and bf16 m16n8k16, operands in
// registers, independent accumulator chains) and of wgmma tf32 m64n128k8
// with A in registers and B in shared memory in the 128-byte swizzle,
// three wgmmas per k8 step and a wait every 12, as B7's 3xTF32 loop
// issues them, on zero and on random data. No memory traffic: what is
// left is the instructions' own rate.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o tc_ceiling tc_ceiling.cu
//
// (scripts/torch_mlp_probe.py --ceiling builds and runs it.)
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// CH independent accumulator chains a warp, `iters` rounds.
template <bool BF16, int CH>
__global__ void mma_sync_bench(float* out, int iters, uint32_t seed) {
  const uint32_t a[4] = {seed, seed + 1, seed + 2, seed + 3};
  const uint32_t b0 = seed * 3, b1 = seed * 5;
  float acc[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (BF16)
        mma_bf16(acc[c], a, b0, b1);
      else
        mma_tf32(acc[c], a, b0, b1);
    }
  }
  float s = 0.0f;
  for (int c = 0; c < CH; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 1.2345f) out[0] = s;  // keeps the chains
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3fff) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ float uniform(uint32_t x) {  // in [-1, 1), from a hash of x
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return (x >> 8) * (2.0f / 16777216.0f) - 1.0f;
}

// Two warpgroups a block, one block an SM: per round, each warpgroup's
// three wgmmas per k8 step over a 32-deep slice, then a wait.
template <bool RANDOM>
__global__ void __launch_bounds__(256, 1) wgmma_bench(float* out, int iters) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < 2 * 128 * 32; i += 256)
    s[i] = RANDOM ? uniform(i + blockIdx.x * 99991u) : 0.0f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[64] = {};
  uint32_t a[4][4];
  for (int k = 0; k < 4; ++k)
    for (int i = 0; i < 4; ++i)
      a[k][i] = RANDOM ? __float_as_uint(uniform(threadIdx.x * 16 + k * 4 + i)) : 0u;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(d, a[kk], desc_sw128(s + kk * 8));
      wgmma_rs(d, a[kk], desc_sw128(s + 4096 + kk * 8));
      wgmma_rs(d, a[kk], desc_sw128(s + kk * 8));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float t = 0.0f;
  for (int i = 0; i < 64; ++i) t += d[i];
  if (t == 1.2345f) out[0] = t;
}

static int sms() {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, 0);
  return n;
}

template <typename Launch>
static float timed_ms(Launch launch) {
  launch();  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  launch();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

template <bool BF16, int CH>
static void run_mma_sync(float* out, int warps) {
  const int iters = 4096, blocks = sms();
  const float ms = timed_ms([&] { mma_sync_bench<BF16, CH><<<blocks, 32 * warps>>>(out, iters, 1); });
  const double flop = (double)blocks * warps * iters * CH * (BF16 ? 4096.0 : 2048.0);
  printf("mma.sync %s, %d chains a warp, %d warps an SM: %.1f TFLOP/s (%s)\n",
         BF16 ? "bf16 m16n8k16" : "tf32 m16n8k8", CH, warps, flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}

template <bool RANDOM>
static void run_wgmma(float* out) {
  const int iters = 200000, blocks = sms(), bytes = 2 * 128 * 32 * 4;
  cudaFuncSetAttribute(wgmma_bench<RANDOM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const float ms = timed_ms([&] { wgmma_bench<RANDOM><<<blocks, 256, bytes>>>(out, iters); });
  const double flop = (double)blocks * 2 * iters * 12 * (64.0 * 128 * 8 * 2);
  printf("wgmma tf32 m64n128k8 (A in registers, 3 a k8 step, a wait every 12), %s data: "
         "%.1f TFLOP/s (%s)\n",
         RANDOM ? "random" : "zero", flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float));
  run_mma_sync<false, 16>(out, 8);
  run_mma_sync<false, 32>(out, 8);
  run_mma_sync<true, 16>(out, 8);
  run_wgmma<false>(out);
  run_wgmma<true>(out);
  cudaFree(out);
  return 0;
}
