"""Attention + output projection + residual (kernels K1 and B9).

    K1  attn_proj_residual:     out = x + softmax(q k^T / sqrt(hd)) v @ W_proj^T + b_proj
    B9  ln_attn_proj_residual:  out = x + proj(attn(qkv(LN1 x)))

K1 takes q|k|v packed in `qkv` [B, L, 3C] (the QKV GEMM output, bias
included); B9 computes that packed qkv itself from LN1(x) (two-pass
statistics, `mlp.ln_rows`). Counterparts of `vsc22_tpu/ops/pallas_attn_proj.py`
`attn_proj_residual` and `ln_attn_proj_residual`; both CUDA kernels are in
`csrc/attn_proj.cu`, on the attention core of `csrc/attn_core.cuh`.

`qkv_w` [3C, C] and `proj_w` [C, C] are in PyTorch's Linear layout [out,
in]; LN params and biases are f32. x, qkv and the weights share the
working dtype (float32 or bfloat16).

In bfloat16 the projection of K1, and so of B9, takes the tensor-core loop
by `gemm_route`; B9's QKV product reads LN1 from a scratch that K2's
LN-rows kernel writes first, and keeps the plain version's order of
summation on the 128x128 FFMA tile (`routes` names each loop of a call).
B9's plain version is its stages' plain versions composed: `mlp.ln_rows`,
`qkv_reference`, K1's `attn_proj_residual_reference`; B10 (ops/vit_block.py)
runs the same stages.
"""

from __future__ import annotations

import torch

from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.attn import attn_core, check_attn_smem
from vsc22_tpu_torch.ops.gemm import gemm_route
from vsc22_tpu_torch.ops.library import kernel_op
from vsc22_tpu_torch.ops.mlp import ln_rows
from vsc22_tpu_torch.ops.vjp import recompute_vjp

_ARGTYPES = [build.PTR] * 6 + [build.INT] * 5 + [build.PTR]
_LN_ARGTYPES = [build.PTR] * 11 + [build.INT] * 4 + [build.FLOAT, build.INT, build.PTR]


def attn_proj_residual_reference(x, qkv, proj_w, proj_b, num_heads: int, scale=None):
    """Plain PyTorch version: the JAX XLA oracle `_attn_proj_xla`; the
    logits are scaled by `scale`, 1/sqrt(hd) unless given (B10 passes 1:
    its q carries the scale)."""
    b, l, c = x.shape
    hd = c // num_heads
    dt = x.dtype
    r = qkv.to(dt).reshape(b, l, 3, num_heads, hd).float()
    q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    logits = torch.einsum("blhd,bmhd->bhlm", q, k) * (hd**-0.5 if scale is None else scale)
    probs = torch.softmax(logits, dim=-1).to(dt).float()
    attn = torch.einsum("bhlm,bmhd->blhd", probs, v).to(dt).reshape(b, l, c)
    proj = attn.float() @ proj_w.to(dt).float().t() + proj_b.float()
    return (x.float() + proj).to(dt)


def routes(x, proj_w, num_heads: int, half_block: bool = False) -> dict:
    """What a K1 launch on these operands runs: the attention core and the
    loop of the projection (`gemm_route`; it reads the wrapper's own
    attention buffer, which is aligned). With `half_block`, a B9 launch:
    also where LN1 is computed and the loop of QKV (`qkv_routes`). Mirrors
    `attn_proj_residual` and `ln_qkv` in `csrc/attn_proj.cuh`."""
    dt, c = x.dtype, x.shape[-1]
    r = dict(core=attn_core(dt, c // num_heads), proj=gemm_route(dt, c, proj_w))
    return {**r, **qkv_routes(dt)} if half_block else r


def qkv_routes(dtype: torch.dtype) -> dict:
    """Where B9's and B10's LN1 is computed and the loop of their QKV: in
    bfloat16 the LN-rows kernel into the wrapper's scratch ("rows"), then
    the 128x128 FFMA tile in the plain version's order of summation
    ("ffma128"), whatever the operands; in float32 the 64x64 FFMA tile with
    the LN fused into its A-tile load ("prologue", "ffma"). Mirrors
    `ln_qkv` in `csrc/attn_proj.cuh`."""
    bf16 = dtype == torch.bfloat16
    return dict(ln="rows" if bf16 else "prologue", qkv="ffma128" if bf16 else "ffma")


def _check_heads(c: int, num_heads: int) -> None:
    if c % num_heads:
        raise ValueError(f"width {c} is not a multiple of {num_heads} heads")


def attn_proj_residual(x, qkv, proj_w, proj_b, num_heads: int):
    """K1 on a CUDA tensor, the plain version on a CPU tensor. On the card
    it is differentiable as the JAX custom VJP (`pallas_attn_proj.py:461-488`):
    the forward on K1, the backward recomputed through
    `attn_proj_residual_reference` under autograd (`ops/vjp.py`)."""
    if x.device.type == "cpu":
        return attn_proj_residual_reference(x, qkv, proj_w, proj_b, num_heads)
    build.require_cuda(x)  # before the op, whose fake takes any device
    return _attn_proj_residual_vjp(x, qkv, proj_w, proj_b, num_heads)


def _attn_proj_residual_cuda(x: torch.Tensor, qkv: torch.Tensor, proj_w: torch.Tensor,
                              proj_b: torch.Tensor, num_heads: int) -> torch.Tensor:
    device = build.require_cuda(x)
    code = build.working_dtype(x)
    b, l, c = x.shape
    _check_heads(c, num_heads)
    build.check_cuda("x", x, device, x.dtype, (b, l, c))
    build.check_cuda("qkv", qkv, device, x.dtype, (b, l, 3 * c))
    build.check_cuda("proj_w", proj_w, device, x.dtype, (c, c))
    build.check_cuda("proj_b", proj_b, device, torch.float32, (c,))
    check_attn_smem(l, c // num_heads, x.dtype)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    build.call(
        "attn_proj", "vsc22_attn_proj_residual", _ARGTYPES,
        x.data_ptr(), qkv.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
        attn.data_ptr(), out.data_ptr(), b, l, c, num_heads, code,
        build.stream_ptr(device),
    )
    attn_proj_residual.launches += 1
    return out


attn_proj_residual.launches = 0
_attn_proj_residual_op = kernel_op("attn_proj_residual", _attn_proj_residual_cuda)
_attn_proj_residual_vjp = recompute_vjp(_attn_proj_residual_op, attn_proj_residual_reference, 4)


def qkv_reference(ln, qkv_w, qkv_b, q_scale=None):
    """The QKV stage of B9 and B10 in plain PyTorch: ln W^T + b in f32, the
    q columns (the first third) times `q_scale` in f32 where given (B10's
    folded scale), then rounded once to ln's dtype."""
    dt = ln.dtype
    qkv = ln.float() @ qkv_w.to(dt).float().t() + qkv_b.float()
    if q_scale is not None:
        qkv[..., : qkv.shape[-1] // 3] *= q_scale
    return qkv.to(dt)


def ln_attn_proj_residual_reference(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b,
                                    num_heads: int, eps: float = 1e-5):
    """Plain PyTorch version: the JAX XLA oracle `_ln_attn_proj_xla`,
    composed of the plain stages (LN1 rows, QKV rounded once, K1)."""
    ln = ln_rows(x.float(), ln_s, ln_b, eps).to(x.dtype)
    return attn_proj_residual_reference(x, qkv_reference(ln, qkv_w, qkv_b), proj_w, proj_b,
                                        num_heads)


def ln_attn_proj_residual(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b,
                          num_heads: int, eps: float = 1e-5):
    """B9 on a CUDA tensor, the plain version on a CPU tensor; on the card
    differentiable as the JAX custom VJP (`pallas_attn_proj.py:377-422`),
    the backward recomputed through `ln_attn_proj_residual_reference`."""
    if x.device.type == "cpu":
        return ln_attn_proj_residual_reference(
            x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, num_heads, eps)
    build.require_cuda(x)  # before the op, whose fake takes any device
    return _ln_attn_proj_residual_vjp(x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b,
                                      num_heads, eps)


def _ln_attn_proj_residual_cuda(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                                qkv_w: torch.Tensor, qkv_b: torch.Tensor, proj_w: torch.Tensor,
                                proj_b: torch.Tensor, num_heads: int,
                                eps: float) -> torch.Tensor:
    device = build.require_cuda(x)
    code = build.working_dtype(x)
    b, l, c = x.shape
    _check_heads(c, num_heads)
    build.check_cuda("x", x, device, x.dtype, (b, l, c))
    build.check_cuda("ln_s", ln_s, device, torch.float32, (c,))
    build.check_cuda("ln_b", ln_b, device, torch.float32, (c,))
    build.check_cuda("qkv_w", qkv_w, device, x.dtype, (3 * c, c))
    build.check_cuda("qkv_b", qkv_b, device, torch.float32, (3 * c,))
    build.check_cuda("proj_w", proj_w, device, x.dtype, (c, c))
    build.check_cuda("proj_b", proj_b, device, torch.float32, (c,))
    check_attn_smem(l, c // num_heads, x.dtype)
    ln = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    qkv = torch.empty((b, l, 3 * c), dtype=x.dtype, device=device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    build.call(
        "attn_proj", "vsc22_ln_attn_proj_residual", _LN_ARGTYPES,
        x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(),
        proj_w.data_ptr(), proj_b.data_ptr(), None if ln is None else ln.data_ptr(),
        qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), b, l, c, num_heads, eps, code,
        build.stream_ptr(device),
    )
    ln_attn_proj_residual.launches += 1
    return out


ln_attn_proj_residual.launches = 0
_ln_attn_proj_residual_op = kernel_op("ln_attn_proj_residual", _ln_attn_proj_residual_cuda)
_ln_attn_proj_residual_vjp = recompute_vjp(_ln_attn_proj_residual_op,
                                           ln_attn_proj_residual_reference, 7)
