"""Plain (full, non-causal) attention over [B, L, H, hd] (kernel B8).

    out = softmax(q k^T) v    per frame and head, the scale already in q

Counterpart of `vsc22_tpu/ops/pallas_attn.py` `packed_attention` and its
dispatcher `attention`; the CUDA kernel is `csrc/attn.cu`, one launch of
the attention core that K1, B9 and B10 share (`csrc/attn_core.cuh`:
tensor cores for bfloat16, CUDA-core dot products for float32, as
`attn_core` says). Logits and the softmax in f32; probabilities and the
output in q's dtype (float32 or bfloat16).
"""

from __future__ import annotations

import torch

from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.library import kernel_op
from vsc22_tpu_torch.ops.vjp import recompute_vjp

_ARGTYPES = [build.PTR] * 4 + [build.INT] * 5 + [build.PTR]

# Dynamic shared memory a block may opt in to on sm_90 (227 KB).
SMEM_PER_BLOCK = 232_448
# The tensor-core core: at most 8 warps of 16 query rows per block, head
# dims up to 128.
MMA_MAX_WARPS = 8
MMA_MAX_HD = 128


def attn_core(dtype: torch.dtype, hd: int) -> str:
    """The attention core a launch takes: "mma" (tensor cores) for bfloat16
    with hd a multiple of 16 up to 128, "ffma" (CUDA-core dot products) for
    float32 and every other hd. Mirrors `attn_core_is_mma` in
    `csrc/attn_core.cuh`."""
    mma = dtype == torch.bfloat16 and 16 <= hd <= MMA_MAX_HD and hd % 16 == 0
    return "mma" if mma else "ffma"


def attn_mma_warps(l: int) -> int:
    """Warps (of 16 query rows) per block of the tensor-core core: the
    ceil(L/16) row tiles spread evenly over the fewest blocks of at most 8.
    Mirrors `attn_mma_warps` in `csrc/attn_core.cuh`."""
    tiles = -(-l // 16)
    blocks = -(-tiles // MMA_MAX_WARPS)
    return -(-tiles // blocks)


def attn_smem_bytes(l: int, hd: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of the attention core that takes (dtype,
    hd). mma: K and V of one head (L rounded up to 16 rows) and the block's
    16 * `attn_mma_warps(L)` Q rows, bf16 at a row pitch of hd + 8; ffma:
    K^T and V of one head for all L tokens, and per-warp q and probability
    rows in f32 (8 warps). Mirrors `attn_mma_smem_bytes` and
    `attn_smem_bytes` in `csrc/attn_core.cuh`."""
    if attn_core(dtype, hd) == "mma":
        return (2 * (-(-l // 16) * 16) + 16 * attn_mma_warps(l)) * (hd + 8) * 2
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * l * hd * itemsize + 8 * (hd + l) * 4


def check_attn_smem(l: int, hd: int, dtype: torch.dtype) -> None:
    """Raise if the attention core cannot hold a head of L tokens."""
    need = attn_smem_bytes(l, hd, dtype)
    if need > SMEM_PER_BLOCK:
        raise RuntimeError(
            f"attention core ({attn_core(dtype, hd)}): L={l}, hd={hd} in {dtype} needs {need} "
            f"bytes of shared memory per block, more than the {SMEM_PER_BLOCK} a block can have"
        )


def packed_attention_reference(q, k, v):
    """Plain PyTorch version: the JAX XLA oracle `_attention_xla`."""
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs.float(), v.float()).to(q.dtype)


def packed_attention(q, k, v):
    """B8 on a CUDA tensor, the plain version on a CPU tensor; on the card
    differentiable as the JAX custom VJP (`pallas_attn.py:130-147`), the
    backward recomputed through `packed_attention_reference`."""
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v)
    build.require_cuda(q)  # before the op, whose fake takes any device
    return _packed_attention_vjp(q, k, v)


def _packed_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    device = build.require_cuda(q)
    code = build.working_dtype(q)
    b, l, h, hd = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda(name, t, device, q.dtype, (b, l, h, hd))
    check_attn_smem(l, hd, q.dtype)
    out = torch.empty_like(q)
    build.call(
        "attn", "vsc22_packed_attention", _ARGTYPES,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, l, h, hd, code,
        build.stream_ptr(device),
    )
    packed_attention.launches += 1
    return out


packed_attention.launches = 0
_packed_attention_op = kernel_op("packed_attention", _packed_attention_cuda)
_packed_attention_vjp = recompute_vjp(_packed_attention_op, packed_attention_reference, 3)


def attention(q, k, v):
    """softmax(q @ k^T) @ v over [B, L, H, hd]: the JAX dispatcher without
    its TPU term. B8 on the card, the plain version on the CPU."""
    return packed_attention(q, k, v)
