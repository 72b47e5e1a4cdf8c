"""One whole SwinV2 res-post-norm block over windows (kernel B1).

    a   = proj(cosine_window_attention(qkv(x)))
    x1  = x + LN1(a)
    out = x1 + LN2(fc2(gelu(fc1(x1))))

Counterpart of `vsc22_tpu/ops/pallas_swin_block.py` `swin_block_fused`
(dispatcher `swin_block`); the CUDA kernel is `csrc/swin_block.cu`. The
roll, window partition and window reverse stay outside, in
`models/swinv2.py`, as in the JAX model.

x [W, N, C] holds W = batch * nW windows, window-major per item (the shift
mask of window w is mask[w % nW]). Weights are in PyTorch's Linear layout
[out, in] and the working dtype of x (float32 or bfloat16): qkv_w [3C, C],
proj_w [C, C], fc1_w [F, C], fc2_w [C, F]. Biases, LN params, rpb [H, N, N],
scale [H] and mask [nW, N, N] are float32. Contract (as in JAX): the middle
(k) third of qkv_b is zero. The mask is read only when nW > 1.

Rounding points are the Pallas kernel's (`pallas_swin_block.py:113-214`):
q and k stay f32 after the QKV product, v is rounded to the dtype; q̂ and
k̂ are rounded after the L2 normalisation; softmax in f32, probabilities
and the attention output rounded; proj + LN1 in f32 (two-pass variance),
x1 rounded; the GELU hidden rounded; fc2 + LN2 in f32, the output rounded.

In bfloat16, proj, fc1 and fc2 take the tensor-core loop by `gemm_route`,
and QKV keeps the plain version's order of summation on an FFMA tile
(`routes` names the loop of each product and the attention core of
`ops/window_attn.window_core` for a call).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.gemm import gemm_route
from vsc22_tpu_torch.ops.library import kernel_op
from vsc22_tpu_torch.ops.vjp import recompute_vjp
from vsc22_tpu_torch.ops.window_attn import check_window_smem, window_core

_LN_EPS = 1e-6  # flax nn.LayerNorm default
_ARGTYPES = [build.PTR] * 22 + [build.INT] * 7 + [build.PTR]


def routes(x, qkv_w, proj_w, fc1_w, fc2_w, num_heads: int) -> dict:
    """What a B1 launch on these operands runs: the attention core and the
    loop of each product. QKV always keeps the plain version's order of
    summation, an FMA chain over k (in bf16 on the 128x128 FFMA tile,
    "ffma128"); proj, fc1 and fc2 take `gemm_route` (they read the
    wrapper's own buffers, which are aligned). Mirrors `swin_block` in
    `csrc/swin_block.cu`."""
    dt = x.dtype
    _, n, c = x.shape
    f = fc1_w.shape[0]
    return dict(
        core=window_core(n, c // num_heads), qkv="ffma128" if dt == torch.bfloat16 else "ffma",
        proj=gemm_route(dt, c, proj_w), fc1=gemm_route(dt, c, fc1_w),
        fc2=gemm_route(dt, f, fc2_w),
    )


def _layernorm_f32(x, scale, bias):
    """LayerNorm with two-pass f32 statistics over the last axis."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _LN_EPS) * scale.float() + bias.float()


def swin_block_reference(x, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, fc1_w, fc1_b,
                         fc2_w, fc2_b, ln2_s, ln2_b, rpb, scale, mask,
                         num_heads: int, num_shift_windows: int):
    """Plain PyTorch version: the JAX `swin_block_reference`, f32 math with
    the kernel's rounding points."""
    dt = x.dtype
    w, n, c = x.shape
    hd = c // num_heads
    qkv = x.float() @ qkv_w.to(dt).float().t() + qkv_b.float()
    q, k, v = qkv.reshape(w, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)  # [W, H, N, hd]
    q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
    k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
    logits = torch.einsum("whnd,whmd->whnm", q.to(dt).float(), k.to(dt).float())
    logits = logits * scale.float().reshape(1, -1, 1, 1) + rpb.float()[None]
    idx = torch.arange(w, device=x.device) % num_shift_windows
    logits = logits + mask.float()[idx][:, None]
    probs = torch.softmax(logits, dim=-1).to(dt).float()
    attn = torch.einsum("whnm,whmd->whnd", probs, v.to(dt).float())
    attn = attn.permute(0, 2, 1, 3).reshape(w, n, c).to(dt)
    proj = attn.float() @ proj_w.to(dt).float().t() + proj_b.float()
    x1 = (x.float() + _layernorm_f32(proj, ln1_s, ln1_b)).to(dt)
    hmid = F.gelu(x1.float() @ fc1_w.to(dt).float().t() + fc1_b.float()).to(dt)
    mlp = hmid.float() @ fc2_w.to(dt).float().t() + fc2_b.float()
    return (x1.float() + _layernorm_f32(mlp, ln2_s, ln2_b)).to(dt)


def swin_block(x, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, fc1_w, fc1_b,
               fc2_w, fc2_b, ln2_s, ln2_b, rpb, scale, mask,
               num_heads: int, num_shift_windows: int):
    """B1 on a CUDA tensor, the plain version on a CPU tensor. On the card
    it is differentiable as the JAX custom VJP (`pallas_swin_block.py:598-657`),
    the backward recomputed through `swin_block_reference`."""
    args = (x, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, fc1_w, fc1_b,
            fc2_w, fc2_b, ln2_s, ln2_b, rpb, scale, mask)
    if x.device.type == "cpu":
        return swin_block_reference(*args, num_heads, num_shift_windows)
    build.require_cuda(x)  # before the op, whose fake takes any device
    return _swin_block_vjp(*args, num_heads, num_shift_windows)


def _swin_block_cuda(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                     proj_w: torch.Tensor, proj_b: torch.Tensor, ln1_s: torch.Tensor,
                     ln1_b: torch.Tensor, fc1_w: torch.Tensor, fc1_b: torch.Tensor,
                     fc2_w: torch.Tensor, fc2_b: torch.Tensor, ln2_s: torch.Tensor,
                     ln2_b: torch.Tensor, rpb: torch.Tensor, scale: torch.Tensor,
                     mask: torch.Tensor, num_heads: int,
                     num_shift_windows: int) -> torch.Tensor:
    args = (x, qkv_w, qkv_b, proj_w, proj_b, ln1_s, ln1_b, fc1_w, fc1_b,
            fc2_w, fc2_b, ln2_s, ln2_b, rpb, scale, mask)
    device = build.require_cuda(x)
    code = build.working_dtype(x)
    w, n, c = x.shape
    h, nw = num_heads, num_shift_windows
    f = fc1_w.shape[0]
    if c % h:
        raise ValueError(f"width {c} is not a multiple of {h} heads")
    if nw < 1 or w % nw:
        raise ValueError(f"{w} windows are not a whole number of {nw}-window items")
    f32 = torch.float32
    for name, t, dtype, shape in (
        ("x", x, x.dtype, (w, n, c)), ("qkv_w", qkv_w, x.dtype, (3 * c, c)),
        ("qkv_b", qkv_b, f32, (3 * c,)), ("proj_w", proj_w, x.dtype, (c, c)),
        ("proj_b", proj_b, f32, (c,)), ("ln1_s", ln1_s, f32, (c,)), ("ln1_b", ln1_b, f32, (c,)),
        ("fc1_w", fc1_w, x.dtype, (f, c)), ("fc1_b", fc1_b, f32, (f,)),
        ("fc2_w", fc2_w, x.dtype, (c, f)), ("fc2_b", fc2_b, f32, (c,)),
        ("ln2_s", ln2_s, f32, (c,)), ("ln2_b", ln2_b, f32, (c,)),
        ("rpb", rpb, f32, (h, n, n)), ("scale", scale, f32, (h,)), ("mask", mask, f32, (nw, n, n)),
    ):
        build.check_cuda(name, t, device, dtype, shape)
    check_window_smem(n, c // h, x.dtype, round_qk=True)
    m = w * n
    qkv = torch.empty((m, 3 * c), dtype=f32, device=device)
    attn = torch.empty_like(x)
    y = torch.empty((m, c), dtype=f32, device=device)
    x1 = torch.empty_like(x)
    hidden = torch.empty((m, f), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    build.call(
        "swin_block", "vsc22_swin_block", _ARGTYPES,
        *(t.data_ptr() for t in args), qkv.data_ptr(), attn.data_ptr(), y.data_ptr(),
        x1.data_ptr(), hidden.data_ptr(), out.data_ptr(),
        w, n, c, h, f, nw, code, build.stream_ptr(device),
    )
    swin_block.launches += 1
    return out


swin_block.launches = 0
_swin_block_op = kernel_op("swin_block", _swin_block_cuda)
_swin_block_vjp = recompute_vjp(_swin_block_op, swin_block_reference, 16)
