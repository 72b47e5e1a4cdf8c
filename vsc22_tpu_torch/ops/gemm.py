"""Which GEMM loop of `csrc/gemm_nt.cuh` a product of the port's kernels
takes (B1's proj, fc1 and fc2, K1's projection, K2's fc1 and fc2, B7's
fc1 and fc2, B9's and B10's products), and the shared memory of a block of
the tensor-core loops. The rules live in C++ (`gemm_is_mma`,
`gemm_is_tf32x3`); this mirror lets the tests and `chip_smoke.py` name the
loop of each product of a call."""

from __future__ import annotations

import torch

# Shared memory of a block of the bf16 tensor-core product: 3 stages of a
# 128-row A slice and a 128-row W slice, 32 deep, at a pitch of 40 bf16.
GEMM_MMA_SMEM = 3 * (128 + 128) * 40 * 2
# Of the f32 3xTF32 product: 4 stages of W's big and small 32-deep slices
# of 128 rows and A's of 128 rows at a pitch of 36 floats, behind up to
# 1024 bytes of alignment.
GEMM_TF32X3_SMEM = 4 * (2 * 128 * 32 + 128 * 36) * 4 + 1024


def gemm_route(dtype: torch.dtype, k: int, *operands: torch.Tensor,
               tf32x3: bool = False) -> str:
    """The loop a product takes: "mma" (bf16 tensor cores) for bfloat16
    with K % 8 == 0 and 16-byte-aligned operands; with `tf32x3` (B7's
    products only), "tf32x3" (f32 on 3xTF32 tensor cores) for float32 with
    K % 4 == 0 and 16-byte-aligned operands; "ffma" (the f32 CUDA-core
    tile) otherwise. Mirrors `gemm_is_mma` and `gemm_is_tf32x3` in
    `csrc/gemm_nt.cuh`."""
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    if dtype == torch.bfloat16 and k % 8 == 0 and aligned:
        return "mma"
    if tf32x3 and dtype == torch.float32 and k % 4 == 0 and aligned:
        return "tf32x3"
    return "ffma"
