// B8: out = softmax(q k^T) v per frame and head, over [B, L, H, hd]
//
// Replaces the Pallas kernel vsc22_tpu/ops/pallas_attn.py
// `packed_attention` (its pallas_call at :106; dispatcher `attention`
// :131, oracle `_attention_xla` :122): the softmax scale is already folded
// into q by the caller (`layers.MultiHeadAttention`), logits in f32,
// probabilities and output rounded to the working dtype.
//
// What bounds it on the H100: at the main-path shapes (CLIP [128,257,16,64],
// ViT [128,145,12,64]) the function is bytes-bound on paper (q, k, v in,
// out, ~4 LC per frame against ~4 L^2 C FLOPs). In bf16 it runs the
// tensor-core core of attn_core.cuh (mma.sync), bound by the warp-level
// tensor-core rate and the f32 softmax; in f32 the FFMA core, bound by
// shared-memory bandwidth of CUDA-core dot products.
//
// Design: one launch of the shared core with row stride C = H*hd for q, k,
// v and out, and scale 1. The TPU kernel's token-lane transposes and
// block-diagonal head packing were for the MXU's 128-wide contraction and
// have no counterpart here.
#include "attn_core.cuh"

// q, k, v, out: [B, L, H, hd], contiguous, on one device.
extern "C" int vsc22_packed_attention(const void* q, const void* k, const void* v, void* out,
                                      int B, int L, int H, int hd, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int C = H * hd;
  if (dtype == vsc22::kBF16) {
    using T = __nv_bfloat16;
    return vsc22::launch_attn_core<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), C, static_cast<T*>(out), C, B,
                                      L, H, hd, 1.0f, s);
  }
  return vsc22::launch_attn_core<float>(static_cast<const float*>(q),
                                        static_cast<const float*>(k),
                                        static_cast<const float*>(v), C,
                                        static_cast<float*>(out), C, B, L, H, hd, 1.0f, s);
}
