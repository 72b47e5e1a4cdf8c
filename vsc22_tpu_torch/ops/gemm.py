"""Which GEMM loop of `csrc/gemm_nt.cuh` a product of the port's kernels
takes (B1's proj, fc1 and fc2, K1's projection, K2's fc1 and fc2, B9's
and B10's products), and the shared memory of a block of the tensor-core
loop. The rule lives in C++ (`gemm_is_mma`); this mirror lets the tests
and `chip_smoke.py` name the loop of each product of a call."""

from __future__ import annotations

import torch

# Shared memory of a block of the tensor-core product: 3 stages of a 128-row
# A slice and a 128-row W slice, 32 deep, at a pitch of 40 bf16.
GEMM_MMA_SMEM = 3 * (128 + 128) * 40 * 2


def gemm_route(dtype: torch.dtype, k: int, *operands: torch.Tensor) -> str:
    """The loop a product takes: "mma" (bf16 tensor cores) for bfloat16
    with K % 8 == 0 and 16-byte-aligned operands, "ffma" (the f32
    CUDA-core tile) otherwise. Mirrors `gemm_is_mma` in
    `csrc/gemm_nt.cuh`."""
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    return "mma" if dtype == torch.bfloat16 and k % 8 == 0 and aligned else "ffma"

