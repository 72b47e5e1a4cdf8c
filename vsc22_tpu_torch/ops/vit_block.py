"""One whole pre-LN transformer block, ViT or CLIP (kernel B10).

    x1  = x + proj(attn(LN1 x))
    out = x1 + fc2(act(fc1(LN2 x1)))

Counterpart of `vsc22_tpu/ops/pallas_vit_block.py` `vit_block` (its
`vit_block_fused`); the CUDA kernel is `csrc/vit_block.cu`. LNs with
two-pass statistics (`mlp.ln_rows`) and `eps`; act is "gelu" (exact, erf) or "quick_gelu"
(x * sigmoid(1.702 x)); the residual x1 is rounded to the working dtype
inside the block.

Weights are in PyTorch's Linear layout [out, in]: qkv_w [3C, C], proj_w
[C, C], fc1_w [F, C], fc2_w [C, F]; LN params and biases are f32. x and the
weights share the working dtype (float32 or bfloat16).

In bfloat16 the kernel runs the stages of B9 and K2, composed: LN1 rows,
QKV, K1's attention core (scale 1) and projection with the residual, then
K2 on x1. fc1 and fc2 take the tensor-core loop where `gemm_route` allows
it; QKV and proj keep the plain version's order of summation on the
128x128 FFMA tile (`routes` names the loop of each product of a call).
`vit_block_composed` is the same composition of the stages' plain
versions.

The kernel follows the TPU kernel's rounding of q: (acc + b) * hd^-0.5 in
f32, rounded once. The plain version copies the JAX oracle, which rounds q
and then scales it in the working dtype, unless it is asked to fold the
scale in as the kernel does (`fold_scale=True`). The two roundings agree
exactly in float32 (to f32 rounding) and where the scale is a power of two
(hd 16, 64); in bfloat16 at hd 32 they move ~40% of the outputs by an ulp.
"""

from __future__ import annotations

import torch

from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.attn import attn_core, check_attn_smem
from vsc22_tpu_torch.ops.attn_proj import (
    attn_proj_residual_reference,
    qkv_reference,
    qkv_routes,
)
from vsc22_tpu_torch.ops.library import kernel_op
from vsc22_tpu_torch.ops.mlp import _ACT_CODES, _activate, ln_mlp_residual_reference, ln_rows
from vsc22_tpu_torch.ops.mlp import routes as mlp_routes
from vsc22_tpu_torch.ops.vjp import recompute_vjp

_LN_EPS = 1e-6
_ARGTYPES = [build.PTR] * 19 + [build.INT] * 6 + [build.FLOAT, build.INT, build.PTR]


def routes(x, fc1_w, fc2_w, num_heads: int) -> dict:
    """What a B10 launch on these operands runs: where LN1 and LN2 are
    computed ("rows" or "prologue"), the attention core and the loop of
    each product. LN1 and QKV as B9's (`attn_proj.qkv_routes`); proj like
    QKV on the 128x128 FFMA tile in bfloat16 ("ffma128"), the 64x64 one in
    float32; LN2, fc1 and fc2 as K2's (`mlp.routes`). Mirrors `vit_block`
    in `csrc/vit_block.cu`."""
    dt, c = x.dtype, x.shape[-1]
    q = qkv_routes(dt)
    k2 = mlp_routes(x, fc1_w, fc2_w)
    return dict(ln1=q["ln"], qkv=q["qkv"], core=attn_core(dt, c // num_heads), proj=q["qkv"],
                ln2=k2["ln"], fc1=k2["fc1"], fc2=k2["fc2"])


def vit_block_reference(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                        fc1_w, fc1_b, fc2_w, fc2_b, num_heads: int,
                        activation: str = "gelu", eps: float = _LN_EPS,
                        fold_scale: bool = False):
    """Plain PyTorch version: the JAX XLA twin `vit_block_reference`; with
    `fold_scale`, q rounded as the TPU kernel (and the CUDA one) rounds it."""
    b, l, c = x.shape
    hd = c // num_heads
    dt = x.dtype
    ln1 = ln_rows(x.float(), ln1_s, ln1_b, eps).to(dt)
    qkv = (ln1.float() @ qkv_w.float().t() + qkv_b.float()).reshape(b, l, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].to(dt) for i in range(3))
    q = (qkv[:, :, 0] * hd**-0.5).to(dt) if fold_scale else q * hd**-0.5
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    probs = torch.softmax(logits, dim=-1).to(dt)
    attn = torch.einsum("bhlm,bmhd->blhd", probs.float(), v.float()).reshape(b, l, c).to(dt)
    proj = attn.float() @ proj_w.float().t() + proj_b.float()
    x1 = (x.float() + proj).to(dt)
    ln2 = ln_rows(x1.float(), ln2_s, ln2_b, eps).to(dt)
    hidden = _activate(ln2.float() @ fc1_w.float().t() + fc1_b.float(), activation).to(dt)
    mlp = hidden.float() @ fc2_w.float().t() + fc2_b.float()
    return (x1.float() + mlp).to(dt)


def vit_block_composed(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
                       fc1_w, fc1_b, fc2_w, fc2_b, num_heads: int,
                       activation: str = "gelu", eps: float = _LN_EPS):
    """The plain version as the kernel composes it, from the plain versions
    of its stages: LN1 rows, QKV with q's scale folded in
    (`qkv_reference`), K1 with the logits scale 1, then K2 on x1. Equal bit
    for bit to `vit_block_reference(..., fold_scale=True)`."""
    ln1 = ln_rows(x.float(), ln1_s, ln1_b, eps).to(x.dtype)
    qkv = qkv_reference(ln1, qkv_w, qkv_b, (x.shape[-1] // num_heads) ** -0.5)
    x1 = attn_proj_residual_reference(x, qkv, proj_w, proj_b, num_heads, scale=1.0)
    return ln_mlp_residual_reference(x1, ln2_s, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, activation,
                                     eps)


def vit_block(x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
              fc1_w, fc1_b, fc2_w, fc2_b, num_heads: int,
              activation: str = "gelu", eps: float = _LN_EPS):
    """B10 on a CUDA tensor, the plain version on a CPU tensor. On the
    card it is differentiable as the JAX custom VJP (`pallas_vit_block.py:290-327`),
    the backward recomputed through `vit_block_reference`, as JAX's through
    its XLA twin."""
    args = (x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
            fc1_w, fc1_b, fc2_w, fc2_b)
    if x.device.type == "cpu":
        return vit_block_reference(*args, num_heads, activation, eps)
    build.require_cuda(x)  # before the op, whose fake takes any device
    return _vit_block_vjp(*args, num_heads, activation, eps)


def _vit_block_cuda(x: torch.Tensor, ln1_s: torch.Tensor, ln1_b: torch.Tensor,
                    qkv_w: torch.Tensor, qkv_b: torch.Tensor, proj_w: torch.Tensor,
                    proj_b: torch.Tensor, ln2_s: torch.Tensor, ln2_b: torch.Tensor,
                    fc1_w: torch.Tensor, fc1_b: torch.Tensor, fc2_w: torch.Tensor,
                    fc2_b: torch.Tensor, num_heads: int, activation: str,
                    eps: float) -> torch.Tensor:
    args = (x, ln1_s, ln1_b, qkv_w, qkv_b, proj_w, proj_b, ln2_s, ln2_b,
            fc1_w, fc1_b, fc2_w, fc2_b)
    device = build.require_cuda(x)
    code = build.working_dtype(x)
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    b, l, c = x.shape
    if c % num_heads:
        raise ValueError(f"width {c} is not a multiple of {num_heads} heads")
    f = fc1_w.shape[0]
    shapes = {"x": (b, l, c), "qkv_w": (3 * c, c), "proj_w": (c, c), "fc1_w": (f, c),
              "fc2_w": (c, f)}
    f32 = {"ln1_s": c, "ln1_b": c, "qkv_b": 3 * c, "proj_b": c, "ln2_s": c, "ln2_b": c,
           "fc1_b": f, "fc2_b": c}
    named = dict(zip(("x", "ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2_s",
                      "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b"), args))
    for name, t in named.items():
        if name in shapes:
            build.check_cuda(name, t, device, x.dtype, shapes[name])
        else:
            build.check_cuda(name, t, device, torch.float32, (f32[name],))
    check_attn_smem(l, c // num_heads, x.dtype)
    ln = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    qkv = torch.empty((b, l, 3 * c), dtype=x.dtype, device=device)
    attn, x1, out = (torch.empty_like(x) for _ in range(3))
    hidden = torch.empty((b, l, f), dtype=x.dtype, device=device)
    build.call(
        "vit_block", "vsc22_vit_block", _ARGTYPES,
        *(t.data_ptr() for t in args), None if ln is None else ln.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), x1.data_ptr(), hidden.data_ptr(), out.data_ptr(), b, l, c, num_heads,
        f, _ACT_CODES[activation], eps, code, build.stream_ptr(device),
    )
    vit_block.launches += 1
    return out


vit_block.launches = 0
_vit_block_op = kernel_op("vit_block", _vit_block_cuda)
_vit_block_vjp = recompute_vjp(_vit_block_op, vit_block_reference, 13)
