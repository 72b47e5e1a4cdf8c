// B6: SwinV2 cosine window attention alone (the module path's attention).
//
// Replaces the Pallas kernel vsc22_tpu/ops/pallas_window_attn.py `_make_kernel`
// (its pallas_call in `_fused_call` at :115; entry `window_attention_fused`
// :125). q, k, v and out are [W, H, N, hd] in the working dtype; q̂ and k̂
// stay f32, the mask [nW, N, N] is always added at window w % nW. The core,
// what bounds it and its design are in window_attn.cuh, which B1 shares.
#include "window_attn.cuh"

namespace vsc22 {

template <typename T>
int window_attention(const void* q, const void* k, const void* v, const float* rpb,
                     const float* scale, const float* mask, void* out, int W, int H, int N,
                     int hd, int nW, cudaStream_t stream) {
  const WinLayout lay{(long long)H * N * hd, (long long)N * hd, hd};
  return launch_window_attn<T, T, false>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), lay, static_cast<T*>(out),
                                         lay, rpb, scale, mask, W, H, nW, N, hd, stream);
}

}  // namespace vsc22

// q, k, v, out: [W, H, N, hd]; rpb: f32 [H, N, N]; scale: f32 [H];
// mask: f32 [nW, N, N]. All contiguous, on one device.
extern "C" int vsc22_window_attention(const void* q, const void* k, const void* v,
                                      const float* rpb, const float* scale, const float* mask,
                                      void* out, int W, int H, int N, int hd, int nW, int dtype,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == vsc22::kBF16)
    return vsc22::window_attention<__nv_bfloat16>(q, k, v, rpb, scale, mask, out, W, H, N, hd,
                                                  nW, s);
  return vsc22::window_attention<float>(q, k, v, rpb, scale, mask, out, W, H, N, hd, nW, s);
}
