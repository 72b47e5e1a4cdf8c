"""The transformer MLP kernels, over rows [M, C]:

    K2  ln_mlp_residual:  out = x + fc2(act(fc1(LN(x))))
    B7  fused_mlp:        out = fc2(gelu(fc1(x)))

Counterparts of `vsc22_tpu/ops/pallas_mlp.py` `ln_mlp_residual` (its
`_ln_forward`) and `fused_mlp` (its `_forward`); both CUDA kernels are in
`csrc/ln_mlp.cu`. act is "gelu" (exact, erf) or "quick_gelu"
(x * sigmoid(1.702 x)); B7 is only ever GELU (SwinV2's `layers.Mlp`).

`w1` [hidden, C] and `w2` [C, hidden] are in PyTorch's Linear layout
[out, in]; LN scale/bias and the fc biases are f32. x, w1 and w2 share the
working dtype (float32 or bfloat16).

In bfloat16, K2's and B7's fc1 and fc2 take the tensor-core loop by
`gemm_route`, K2's fc1 reading LN(x) from a scratch that `ln_rows_kernel`
writes first (`layernorm_rows` launches that kernel alone). In float32,
B7's products take the 3xTF32 tensor-core loop, K2's the FFMA tile. A
product off the rule (K or an operand's alignment) keeps the FFMA tile.
`routes` (K2) and `fused_mlp_routes` (B7) name the loop of each product
for a call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.gemm import gemm_route
from vsc22_tpu_torch.ops.library import kernel_op
from vsc22_tpu_torch.ops.vjp import recompute_vjp

_ACT_CODES = {"gelu": 1, "quick_gelu": 2}
_ARGTYPES = (
    [build.PTR] * 10 + [build.INT] * 4 + [build.FLOAT, build.INT, build.PTR]
)
_LN_ROWS_ARGTYPES = [build.PTR] * 4 + [build.INT] * 2 + [build.FLOAT, build.INT, build.PTR]
_MLP_ARGTYPES = [build.PTR] * 8 + [build.INT] * 4 + [build.PTR]


def _activate(h, activation: str):
    if activation == "gelu":
        return F.gelu(h)
    if activation == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    raise ValueError(f"unknown activation {activation!r}")


def ln_rows(xf, scale, bias, eps: float):
    """LayerNorm over the last axis of f32 rows, as the kernels' LN
    prologue (`gemm_nt.cuh`) computes it: the mean and the two-pass
    variance accumulated in float64 and rounded to f32 (the correctly
    rounded values, whatever the summation order; the JAX oracles' f32
    sums agree to f32 rounding), then (x - mean) * rsqrt(var + eps) *
    scale + bias in f32, one rounding per operation."""
    mean = xf.double().mean(-1, keepdim=True).float()
    d = xf - mean
    var = d.double().square().mean(-1, keepdim=True).float()
    return d * torch.rsqrt(var + eps) * scale.float() + bias.float()


def layernorm_rows(x, scale, bias, eps: float):
    """LN(x) over the last axis of [M, C] rows, rounded to x's dtype: K2's
    `ln_rows_kernel` alone on a CUDA tensor, `ln_rows` on a CPU tensor."""
    if x.device.type == "cpu":
        return ln_rows(x.float(), scale, bias, eps).to(x.dtype)
    device = build.require_cuda(x)
    code = build.working_dtype(x)
    m, c = x.shape
    build.check_cuda("x", x, device, x.dtype, (m, c))
    build.check_cuda("scale", scale, device, torch.float32, (c,))
    build.check_cuda("bias", bias, device, torch.float32, (c,))
    out = torch.empty_like(x)
    build.call("ln_mlp", "vsc22_ln_rows", _LN_ROWS_ARGTYPES, x.data_ptr(), scale.data_ptr(),
               bias.data_ptr(), out.data_ptr(), m, c, eps, code, build.stream_ptr(device))
    layernorm_rows.launches += 1
    return out


layernorm_rows.launches = 0


def routes(x, w1, w2) -> dict:
    """What a K2 launch on these operands runs: the loop of fc1 and fc2
    (`gemm_route`; fc1 reads the wrapper's own LN scratch and fc2 its own
    hidden, which are aligned) and where the LN is computed: "rows" (the
    LN-rows kernel, before fc1 on the tensor-core loop) or "prologue" (fused
    into the FFMA tile's A-tile load). Mirrors `ln_mlp_residual` in
    `csrc/ln_mlp.cu`."""
    dt = x.dtype
    c, hidden = x.shape[-1], w1.shape[0]
    fc1 = gemm_route(dt, c, w1)
    return dict(ln="rows" if fc1 == "mma" else "prologue", fc1=fc1,
                fc2=gemm_route(dt, hidden, w2))


def ln_mlp_residual_reference(x, ln_s, ln_b, w1, b1, w2, b2,
                              activation: str = "gelu", eps: float = 1e-5):
    """Plain PyTorch version: the JAX XLA oracle `_xla_ln_mlp`."""
    dt = x.dtype
    xf = x.float()
    ln = ln_rows(xf, ln_s, ln_b, eps).to(dt)
    h = ln.float() @ w1.to(dt).float().t() + b1.float()
    h = _activate(h, activation).to(dt)
    out = h.float() @ w2.to(dt).float().t() + b2.float()
    return (xf + out).to(dt)


def ln_mlp_residual(x, ln_s, ln_b, w1, b1, w2, b2,
                    activation: str = "gelu", eps: float = 1e-5):
    """K2 on a CUDA tensor, the plain version on a CPU tensor. On the card
    it is differentiable as the JAX custom VJP (`pallas_mlp.py:194-238`):
    the forward on K2, the backward recomputed through
    `ln_mlp_residual_reference` under autograd (`ops/vjp.py`)."""
    if x.device.type == "cpu":
        return ln_mlp_residual_reference(x, ln_s, ln_b, w1, b1, w2, b2, activation, eps)
    build.require_cuda(x)  # before the op, whose fake takes any device
    return _ln_mlp_residual_vjp(x, ln_s, ln_b, w1, b1, w2, b2, activation, eps)


def _ln_mlp_residual_cuda(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                          w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, activation: str, eps: float) -> torch.Tensor:
    device = build.require_cuda(x)
    code = build.working_dtype(x)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    m, c = x.shape
    hidden = w1.shape[0]
    build.check_cuda("x", x, device, x.dtype, (m, c))
    build.check_cuda("ln_s", ln_s, device, torch.float32, (c,))
    build.check_cuda("ln_b", ln_b, device, torch.float32, (c,))
    build.check_cuda("w1", w1, device, x.dtype, (hidden, c))
    build.check_cuda("b1", b1, device, torch.float32, (hidden,))
    build.check_cuda("w2", w2, device, x.dtype, (c, hidden))
    build.check_cuda("b2", b2, device, torch.float32, (c,))
    ln = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    h = torch.empty((m, hidden), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    build.call(
        "ln_mlp", "vsc22_ln_mlp_residual", _ARGTYPES,
        x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), None if ln is None else ln.data_ptr(),
        h.data_ptr(), out.data_ptr(), m, c, hidden, _ACT_CODES[activation], eps, code,
        build.stream_ptr(device),
    )
    ln_mlp_residual.launches += 1
    return out


ln_mlp_residual.launches = 0
_ln_mlp_residual_op = kernel_op("ln_mlp_residual", _ln_mlp_residual_cuda)
_ln_mlp_residual_vjp = recompute_vjp(_ln_mlp_residual_op, ln_mlp_residual_reference, 7)


def fused_mlp_reference(x, w1, b1, w2, b2):
    """Plain PyTorch version: the JAX XLA oracle `_xla_mlp` (biases added
    in f32, the hidden and the output rounded to x's dtype)."""
    dt = x.dtype
    h = F.gelu(x.float() @ w1.to(dt).float().t() + b1.float()).to(dt)
    return (h.float() @ w2.to(dt).float().t() + b2.float()).to(dt)


def fused_mlp_routes(x, w1, w2) -> dict:
    """The loop of B7's fc1 (on x and w1) and fc2 (on the wrapper's own
    hidden, which is aligned, and w2): "mma" (bf16 tensor cores),
    "tf32x3" (f32 on 3xTF32 tensor cores) or "ffma". Mirrors `fused_mlp`
    in `csrc/ln_mlp.cu`."""
    dt = x.dtype
    c, hidden = x.shape[-1], w1.shape[0]
    return dict(fc1=gemm_route(dt, c, x, w1, tf32x3=True),
                fc2=gemm_route(dt, hidden, w2, tf32x3=True))


def fused_mlp(x, w1, b1, w2, b2):
    """B7 on a CUDA tensor, the plain version on a CPU tensor. b1 and b2
    may come in any float dtype (`layers.Mlp` passes the working dtype);
    the kernel adds them in f32. On the card it is differentiable as the
    JAX custom VJP (`pallas_mlp.py:241-269`), the backward recomputed
    through `fused_mlp_reference` under autograd (`ops/vjp.py`)."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2)
    build.require_cuda(x)  # before the op, whose fake takes any device
    return _fused_mlp_vjp(x, w1, b1, w2, b2)


def _fused_mlp_cuda(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    device = build.require_cuda(x)
    code = build.working_dtype(x)
    m, c = x.shape
    hidden = w1.shape[0]
    b1, b2 = b1.float(), b2.float()
    build.check_cuda("x", x, device, x.dtype, (m, c))
    build.check_cuda("w1", w1, device, x.dtype, (hidden, c))
    build.check_cuda("b1", b1, device, torch.float32, (hidden,))
    build.check_cuda("w2", w2, device, x.dtype, (c, hidden))
    build.check_cuda("b2", b2, device, torch.float32, (c,))
    h = torch.empty((m, hidden), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    # f32: the 3xTF32 route's split of w1, then of w2 (big, small)
    wsplit = torch.empty(2 * hidden * c, device=device) if x.dtype == torch.float32 else None
    build.call(
        "ln_mlp", "vsc22_fused_mlp", _MLP_ARGTYPES,
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        h.data_ptr(), out.data_ptr(), None if wsplit is None else wsplit.data_ptr(),
        m, c, hidden, code, build.stream_ptr(device),
    )
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
_fused_mlp_op = kernel_op("fused_mlp", _fused_mlp_cuda)
_fused_mlp_vjp = recompute_vjp(_fused_mlp_op, fused_mlp_reference, 5)
