"""SwinV2 cosine window attention (kernel B6).

    out = softmax(q̂ k̂^T * scale[h] + rpb[h] + mask[w % nW]) v

per (window w, head h), with q̂ and k̂ the rows of q and k L2-normalised in
f32. Counterpart of `vsc22_tpu/ops/pallas_window_attn.py`
`window_attention_fused` (its `_fused_call`); the CUDA kernel is
`csrc/window_attn.cu`, whose attention core `csrc/window_attn.cuh` the
whole-block kernel B1 shares. The SwinV2 module path calls it.

q, k, v and out are [W, H, N, hd] in the working dtype (float32 or
bfloat16), W = batch * nW windows, window-major per item. rpb [H, N, N]
(16 * sigmoid(CPB)), scale [H] (exp(min(logit_scale, ln 100))) and mask
[nW, N, N] are float32. Rounding as the Pallas kernel: q̂ and k̂ stay f32,
the probabilities are rounded to v's dtype, the output to q's.

Two cores compute it (`window_core`): tensor cores at hd 16 or 32 and N <=
256, every SwinV2-Base stage, and CUDA-core dot products at every other
shape. On tensor cores q̂ and k̂ are never rounded: in bfloat16 q k^T is an
exact bf16 product of the raw q and k, and each logit is scaled by the two
f32 norms after; in float32 both products are 3xTF32 (each operand split
into two tf32 parts, about 2^-22 of each product kept).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.library import kernel_op
from vsc22_tpu_torch.ops.vjp import recompute_vjp

_ARGTYPES = [build.PTR] * 7 + [build.INT] * 6 + [build.PTR]

# Dynamic shared memory a block may opt in to on sm_90 (227 KB).
SMEM_PER_BLOCK = 232_448
# The tensor-core core: hd 16 or 32, at most 256 tokens a window (a warp's
# [16, N] logits stay in registers), at most 8 warps of 16 query rows a block.
MMA_HEAD_DIMS = (16, 32)
MMA_MAX_N = 256
MMA_MAX_WARPS = 8


def window_core(n: int, hd: int) -> str:
    """The core a launch of B6, or B1's attention, takes: "mma" (tensor
    cores) at hd 16 or 32 and N <= 256, "ffma" (CUDA-core dot products) at
    every other shape, in both dtypes. Mirrors `window_core_is_mma` in
    `csrc/window_attn.cuh`."""
    return "mma" if hd in MMA_HEAD_DIMS and 1 <= n <= MMA_MAX_N else "ffma"


def window_mma_warps(n: int) -> int:
    """Warps (of 16 query rows) per block of the tensor-core core: the
    ceil(N/16) row tiles spread evenly over the fewest blocks of at most 8.
    Mirrors `window_mma_warps` in `csrc/window_attn.cuh`."""
    tiles = -(-n // 16)
    blocks = -(-tiles // MMA_MAX_WARPS)
    return -(-tiles // blocks)


def window_smem_bytes(n: int, hd: int, dtype: torch.dtype, round_qk: bool = False) -> int:
    """Shared memory of one block of the core that takes (N, hd). mma: the
    f32 bias tile (16 * `window_mma_warps(N)` rows at a pitch of N rounded
    up to 32, plus 8), then k and v of one window (N rounded up to 16
    rows), each bf16 at a pitch of hd + 8 in bfloat16 (k̂ rounded for B1,
    `round_qk`; raw k for B6, beside its f32 norms) and f32 at hd + 4 in
    float32. ffma: k̂ (transposed, N + 1 columns) and v of one head, and
    per-warp q and probability rows, f32 (8 warps). Mirrors
    `window_mma_smem_bytes` and `window_attn_smem_bytes`."""
    if window_core(n, hd) == "mma":
        rows = -(-n // 16) * 16
        bias = 16 * window_mma_warps(n) * ((-(-n // 32) * 32) + 8) * 4
        bf16_row, f32_row = (hd + 8) * 2, (hd + 4) * 4
        if dtype != torch.bfloat16:
            return bias + 2 * rows * f32_row
        if round_qk:  # B1: k̂ in bf16, v (bf16 values) in f32
            return bias + rows * (bf16_row + f32_row)
        return bias + 4 * rows * bf16_row + rows * 4  # B6: two buffers of k, v; k's norms
    return (hd * (n + 1) + n * hd + 8 * (hd + n)) * 4


def check_window_smem(n: int, hd: int, dtype: torch.dtype, round_qk: bool = False) -> None:
    """Raise if the window core cannot hold a window of N tokens."""
    need = window_smem_bytes(n, hd, dtype, round_qk)
    if need > SMEM_PER_BLOCK:
        raise RuntimeError(
            f"window attention core ({window_core(n, hd)}): N={n}, hd={hd} in {dtype} needs "
            f"{need} bytes of shared memory per block, more than the {SMEM_PER_BLOCK} a block "
            "can have"
        )


def window_attention_reference(q, k, v, rpb, scale, mask, num_shift_windows: int):
    """Plain PyTorch version: the JAX `window_attention_reference`."""
    w = q.shape[0]
    qf, kf = q.float(), k.float()
    qf = qf * torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-12)
    kf = kf * torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-12)
    attn = torch.einsum("whnd,whmd->whnm", qf, kf)
    attn = attn * scale.float().reshape(1, -1, 1, 1)
    attn = attn + rpb.float()[None]
    idx = torch.arange(w, device=q.device) % num_shift_windows
    attn = attn + mask.float()[idx][:, None]
    probs = torch.softmax(attn, dim=-1).to(v.dtype).float()
    return torch.einsum("whnm,whmd->whnd", probs, v.float()).to(q.dtype)


def window_attention_chunked(q, k, v, rpb, scale, mask, num_shift_windows: int,
                             max_temp_bytes: int = 128 * 2**20):
    """The plain version with its [W, H, N, N] f32 logits bounded to chunks
    of windows, as the JAX `window_attention_chunked`: each chunk of
    `max_temp_bytes // (H N^2 4)` windows runs `window_attention_reference`,
    under `torch.utils.checkpoint` while autograd records, so that the
    forward and the backward each hold one chunk's logits (the backward
    recomputes them). One call when everything fits."""
    w, h, n, _ = q.shape
    chunk = max(1, max_temp_bytes // (h * n * n * 4))
    if chunk >= w:
        return window_attention_reference(q, k, v, rpb, scale, mask, num_shift_windows)
    if chunk % num_shift_windows:  # whole items per chunk keep mask[w % nW] aligned
        chunk = max(chunk // num_shift_windows, 1) * num_shift_windows
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, rpb, scale, mask))
    outs = []
    for s in range(0, w, chunk):
        args = (q[s:s + chunk], k[s:s + chunk], v[s:s + chunk], rpb, scale, mask,
                num_shift_windows)
        outs.append(checkpoint(window_attention_reference, *args, use_reentrant=False)
                    if record else window_attention_reference(*args))
    return torch.cat(outs)


def window_attention(q, k, v, rpb, scale, mask, num_shift_windows: int):
    """B6 on a CUDA tensor, the plain version on a CPU tensor. On the card
    it is differentiable as the JAX custom VJP (`pallas_window_attn.py:139-156`):
    the backward recomputes through `window_attention_chunked`."""
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, rpb, scale, mask, num_shift_windows)
    build.require_cuda(q)  # before the op, whose fake takes any device
    return _window_attention_vjp(q, k, v, rpb, scale, mask, num_shift_windows)


def _window_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rpb: torch.Tensor, scale: torch.Tensor, mask: torch.Tensor,
                           num_shift_windows: int) -> torch.Tensor:
    device = build.require_cuda(q)
    code = build.working_dtype(q)
    w, h, n, hd = q.shape
    nw = num_shift_windows
    if nw < 1 or w % nw:
        raise ValueError(f"{w} windows are not a whole number of {nw}-window items")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda(name, t, device, q.dtype, (w, h, n, hd))
    build.check_cuda("rpb", rpb, device, torch.float32, (h, n, n))
    build.check_cuda("scale", scale, device, torch.float32, (h,))
    build.check_cuda("mask", mask, device, torch.float32, (nw, n, n))
    check_window_smem(n, hd, q.dtype)
    out = torch.empty_like(q)
    build.call(
        "window_attn", "vsc22_window_attention", _ARGTYPES,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), scale.data_ptr(),
        mask.data_ptr(), out.data_ptr(), w, h, n, hd, nw, code, build.stream_ptr(device),
    )
    window_attention.launches += 1
    return out


window_attention.launches = 0
_window_attention_op = kernel_op("window_attention", _window_attention_cuda)
_window_attention_vjp = recompute_vjp(_window_attention_op, window_attention_chunked, 6)
