"""Shared model building blocks.

Counterpart of `vsc22_tpu/models/layers.py`. Parameters follow the JAX
package's precision split: matmul weights live in the model's compute
dtype (the JAX code casts its f32 params to it at use, which rounds the
same way), while biases, LayerNorm params and f32 heads stay float32.
Weights use PyTorch layouts (Linear [out, in]); `utils/jax_params.py`
carries JAX param trees across. Training keeps f32 masters of the
parameters beside the model (`train/contrastive.py`), so that the
inference paths round as before.

Dropout and DropPath draw their masks from a `DropRng`, one per train
step: the FGM pass and a rematerialised block reuse the first pass's
masks, as JAX's passes reuse one `rng`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vsc22_tpu_torch.ops.attn import attention
from vsc22_tpu_torch.ops.attn_proj import attn_proj_residual
from vsc22_tpu_torch.ops.mlp import fused_mlp, ln_mlp_residual


class Linear(nn.Module):
    """y = x W^T + b, W [out, in] in `dtype`, b float32 (or no bias)."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.float32, device=None,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=dtype, device=device))
        self.bias = (
            nn.Parameter(torch.empty(out_dim, dtype=torch.float32, device=device))
            if bias else None
        )

    def reset(self, generator: torch.Generator) -> None:
        _normal_(self.weight, self.weight.shape[1] ** -0.5, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        """A flax `nn.Dense` whose `dtype` is the weight's (see `dense`)."""
        return dense(x, self.weight, self.bias)


def dense(x, weight, bias=None):
    """x W^T + b as a flax `nn.Dense(dtype=W's dtype)` computes it
    (`y = dot(x, kernel); y += bias`, both in that dtype): in float32 one
    product plus the bias; in bfloat16 the product rounded to bf16, then the
    bias rounded to bf16 and added in bf16, a second rounding."""
    x = x.to(weight.dtype)
    if bias is None or weight.dtype == torch.float32:
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias.to(weight.dtype)


def linear_f32_bias(x, lin: Linear):
    """x W^T + b as the JAX ViT and CLIP blocks compute their QKV
    (`jnp.dot(..., preferred_element_type=f32) + qkv_b`): the product of
    operands in W's dtype accumulated in f32, the f32 bias added, and one
    rounding to W's dtype. `Linear.forward` (`dense`) instead rounds the
    product, then adds the bias rounded to W's dtype, as a flax Dense does."""
    w = lin.weight
    if w.dtype == torch.float32:
        return lin(x)
    return (matmul_f32(x.to(w.dtype), w.t()) + lin.bias).to(w.dtype)


def matmul_f32(x, w):
    """x [..., K] @ w [K, N] in float32 as `jnp.dot(...,
    preferred_element_type=f32)` computes it: products of x's dtype
    accumulated in float32. Differentiable: the cotangents of x and w come
    back in their own dtypes."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype == torch.float32 or x2.device.type == "cpu":
        out = x2.float() @ w.float()  # bf16 x bf16 products are exact in f32
    else:
        out = _MatmulF32.apply(x2, w)
    return out.reshape(*x.shape[:-1], w.shape[1])


class _MatmulF32(torch.autograd.Function):
    """`torch.mm(x, w, out_dtype=float32)` with a backward: each cotangent
    is an f32 product of the f32 output cotangent and the other operand,
    rounded once to its operand's dtype (JAX's transpose of a dot with
    `preferred_element_type=f32`, then the cast back)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = (g @ w.float().t()).to(x2.dtype) if ctx.needs_input_grad[0] else None
        gw = (x2.float().t() @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def gelu_exact(x):
    """`jax.nn.gelu(x, approximate=False)` with its roundings: 0.5 * x *
    erfc(-x * sqrt(0.5)), where sqrt(0.5), the argument of erfc, erfc
    itself and the product are each rounded to x's dtype (exact GELU in
    one f32 pass and one rounding moves 37% of bf16 outputs)."""
    r = lambda v: v.to(x.dtype).float()
    xf = x.float()
    sqrt_half = r(torch.tensor(0.5 ** 0.5))
    return (0.5 * xf * r(torch.special.erfc(r(-xf * sqrt_half)))).to(x.dtype)


class DropRng:
    """The dropout and DropPath keep-masks of one train step. The step's
    seed is drawn once from `generator` (a CPU `torch.Generator`, whose
    state a checkpoint keeps); each mask is drawn at its first use on the
    tensor's own device, from a generator there seeded with the step's
    seed, as `uniform < keep` (JAX's `bernoulli`), and kept under its key
    (the module and a tag): the FGM pass and a block recomputed under
    `torch.utils.checkpoint` get the first pass's masks.

    A rank of a data-parallel step passes `rows`, the global batch's
    sample index of each of its samples, and `total`, the global batch's
    sample count: each mask is then drawn for the whole global batch (a
    leading dim of `total` times the rows a sample spans, such as its
    windows) and the rank takes its samples' rows of it, so the masks do
    not depend on the world size (JAX's keys are sharding-invariant)."""

    def __init__(self, generator: torch.Generator, rows: Optional[torch.Tensor] = None,
                 total: Optional[int] = None):
        self.seed = int(torch.randint(2**62, (), generator=generator))
        self.rows, self.total = rows, total
        self._generators: dict = {}
        self._masks: dict = {}

    def keep_mask(self, key, shape, keep: float, device) -> torch.Tensor:
        mask = self._masks.get(key)
        if mask is None:
            device = torch.device(device)
            gen = self._generators.get(device)
            if gen is None:
                gen = torch.Generator(device).manual_seed(self.seed)
                self._generators[device] = gen
            if self.rows is None:
                mask = torch.rand(shape, generator=gen, device=device) < keep
            else:
                per, left = divmod(shape[0], len(self.rows))
                if left:
                    raise ValueError(f"a leading dim of {shape[0]} over {len(self.rows)} samples")
                whole = torch.rand((self.total * per,) + tuple(shape[1:]), generator=gen,
                                   device=device) < keep
                at = self.rows.to(device)[:, None] * per + torch.arange(per, device=device)
                mask = whole[at.reshape(-1)]
            self._masks[key] = mask
        return mask


def dropout(x, rate: float, rng, key):
    """flax `nn.Dropout`: x / keep where the mask keeps, 0 elsewhere; the
    identity when `rng` is None (deterministic) or the rate is 0."""
    if rate == 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    mask = rng.keep_mask(key, tuple(x.shape), keep, x.device)
    return torch.where(mask, x / keep, 0.0)


class DropPath(nn.Module):
    """Stochastic depth (`vsc22_tpu/models/layers.py:166-179`): each
    sample's residual branch kept with probability 1 - rate and scaled by
    1 / keep, or zeroed; the identity when `rng` is None or the rate is 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, rng=None):
        if self.rate == 0.0 or rng is None:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return torch.where(rng.keep_mask((self, "path"), shape, keep, x.device), x / keep, 0.0)


class LayerNorm(nn.Module):
    """Scale and bias of a LayerNorm (float32); the math is in the callers."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def reset(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


def _normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """In-place N(0, std^2) draw from `generator` (made on the CPU, so a
    seed gives the same weights on every device)."""
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator) * std)


def reset_parameters(module: nn.Module, generator: torch.Generator,
                     embed_std: float = 0.02) -> None:
    """Seeded random init of a port model: every submodule with a
    `reset(generator)` method sets its own parameters (Linear weights
    N(0, 1/fan_in), zero biases, unit LayerNorm scales; see each class);
    every other parameter (class tokens, position tables) is drawn from
    N(0, embed_std^2)."""
    owned = set()
    for m in module.modules():
        if callable(getattr(m, "reset", None)):
            m.reset(generator)
            owned.update(id(p) for p in m.parameters(recurse=False))
    for p in module.parameters():
        if id(p) not in owned:
            _normal_(p, embed_std, generator)


@contextlib.contextmanager
def _cudnn_ieee():
    """cuDNN's float32 convolutions in full float32 (TF32 off) inside the
    block; the caller's setting is back after it."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class _ConvIEEE(torch.autograd.Function):
    """`F.conv2d` (no bias, dilation 1) whose backward, like its forward,
    runs with TF32 off: autograd's own conv backward would run later,
    under whatever the caller's flag says (torch's default: TF32 on). The
    backward is aten's `convolution_backward`, the one autograd calls."""

    @staticmethod
    def forward(ctx, x, w, stride: int, pad: int, groups: int):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, groups)
        with _cudnn_ieee():
            return F.conv2d(x, w, None, stride, pad, 1, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad, groups = ctx.conf
        with _cudnn_ieee():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [stride, stride], [pad, pad], [1, 1], False, [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """flax `SAME` padding of one spatial axis: (low, high) with out =
    ceil(size / stride) and the odd pixel at the high end, so that k 3 at
    stride 2 on an even input pads (0, 1) where torch's `padding=1` pads
    (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A flax `nn.Conv` over NHWC activations: weight OIHW [F, C / groups,
    k, k] in `dtype`; padding `pad`, either torch's symmetric `padding=`
    (an int) or "same", flax's `SAME` (`same_pads`); an optional float32
    bias, added in the output's dtype after the convolution, as flax adds
    it (a second rounding in bfloat16). float32 convolutions run in full
    float32 (no TF32), their backward too."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, pad=0,
                 groups: int = 1, dtype=torch.float32, device=None, bias: bool = False):
        super().__init__()
        self.stride, self.pad, self.groups = stride, pad, groups
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel, kernel, dtype=dtype, device=device))
        self.bias = (
            nn.Parameter(torch.empty(cout, dtype=torch.float32, device=device))
            if bias else None
        )

    def reset(self, generator: torch.Generator) -> None:
        _normal_(self.weight, self.weight[0].numel() ** -0.5, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):  # [B, H, W, C] -> [B, H', W', F]
        w = self.weight
        x = x.to(w.dtype).permute(0, 3, 1, 2)
        pad = self.pad
        if pad == "same":
            k = w.shape[-1]
            (top, bottom), (left, right) = (same_pads(n, k, self.stride) for n in x.shape[2:])
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        y = _ConvIEEE.apply(x, w, self.stride, pad, self.groups).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ConvTranspose(nn.Module):
    """A flax `nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding="SAME")` with its bias over NHWC activations. flax does not
    flip the kernel (`transpose_kernel=False`): it correlates the
    stride-dilated input, padded by lax's `SAME` transpose padding (pa,
    pb), with the HWIO kernel. torch's `conv_transpose2d` correlates the
    dilated input padded by k - 1 - padding with the kernel flipped in
    space, so the weight here is the flax kernel flipped in space and laid
    out [in, out, k, k], and padding = k - 1 - pa (pa == pb: k 4, s 2 pads
    (2, 2), torch's padding 1). float32 runs in full float32 (no TF32)."""

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2,
                 dtype=torch.float32, device=None):
        super().__init__()
        pad_len = kernel + stride - 2
        pa = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
        if pa != pad_len - pa or pa > kernel - 1:
            raise ValueError(f"ConvTranspose: k {kernel}, s {stride} pads ({pa}, "
                             f"{pad_len - pa}), which conv_transpose2d cannot take")
        self.stride, self.padding = stride, kernel - 1 - pa
        self.weight = nn.Parameter(
            torch.empty(cin, cout, kernel, kernel, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(cout, dtype=torch.float32, device=device))

    def reset(self, generator: torch.Generator) -> None:
        _normal_(self.weight, self.weight[:, 0].numel() ** -0.5, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):  # [B, H, W, C] -> [B, sH, sW, F]
        w = self.weight
        with _cudnn_ieee():
            y = F.conv_transpose2d(x.to(w.dtype).permute(0, 3, 1, 2), w, None, self.stride,
                                   self.padding)
        y = y.permute(0, 2, 3, 1)
        return y + self.bias.to(y.dtype)


def upsample_nearest_2x(x):
    """[B, H, W, C] -> [B, 2H, 2W, C], each pixel repeated:
    `jax.image.resize(..., "nearest")` at an exact 2x (output i reads input
    floor((i + 0.5) / 2) = i // 2)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Embed(nn.Module):
    """A flax `nn.Embed`: a float32 table [num, features]; a lookup
    returns its float32 rows."""

    def __init__(self, num: int, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features, dtype=torch.float32,
                                               device=device))

    def reset(self, generator: torch.Generator) -> None:
        """N(0, 1 / features): flax's default `variance_scaling(1, fan_in,
        normal, out_axis=0)`."""
        _normal_(self.weight, self.weight.shape[1] ** -0.5, generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


def spatial_mean(x):
    """jnp.mean over H and W of [B, H, W, C]: a float32 sum divided in
    float32, one rounding to x's dtype."""
    return (x.float().sum((1, 2)) / (x.shape[1] * x.shape[2])).to(x.dtype)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the last axis (momentum 0.99, eps 1e-5):
    float32 scale, bias and running mean and variance."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))
        self.register_buffer("mean", torch.zeros(features, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32, device=device))

    def reset(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, y, train: bool = False):
        """flax `nn.BatchNorm` in y's dtype: (y - mean) * (rsqrt(var + eps)
        * scale) + bias in float32, rounded to y's dtype once. At inference
        (`use_running_average=True`) mean and var are the running ones. In
        training they are the batch's, over every axis but the last, in
        float32 with flax's fast variance max(0, E[y^2] - E[y]^2) (not
        `F.batch_norm`'s two-pass one), differentiated through; the running
        buffers become 0.99 * running + 0.01 * batch, with that (biased)
        variance."""
        if not train:
            mean, var = self.mean, self.var
        else:
            yf = y.float()
            dims = tuple(range(y.ndim - 1))
            mean = yf.mean(dims)
            var = (yf.square().mean(dims) - mean.square()).clamp(min=0.0)
            with torch.no_grad():
                self.mean.copy_(0.99 * self.mean + (1.0 - 0.99) * mean)
                self.var.copy_(0.99 * self.var + (1.0 - 0.99) * var)
        mul = torch.rsqrt(var + 1e-5) * self.weight
        return ((y.float() - mean) * mul + self.bias).to(y.dtype)

    def folded(self, y):
        """The BN folded into two constants, as the JAX HRNet's packed
        branch 0 applies it: mult = scale / sqrt(var + eps) and add = bias
        - mean * mult in float32, cast to y's dtype, then y * mult + add in
        y's dtype (two roundings in bfloat16)."""
        mult = self.weight / torch.sqrt(self.var + 1e-5)
        add = self.bias - self.mean * mult
        return y * mult.to(y.dtype) + add.to(y.dtype)


def layer_norm(x, ln: LayerNorm, eps: float, dtype):
    """flax `nn.LayerNorm` semantics: f32 stats with the fast variance
    E[x^2] - E[x]^2 (clipped at 0), y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias, output in `dtype`."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp(min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * ln.weight) + ln.bias
    return y.to(dtype)


def gem_pool(x, p: float = 3.0, dim: int = 1, eps: float = 1e-6):
    """Generalized-mean pool over `dim`: (mean(clamp(x, eps)^p))^(1/p), f32."""
    x = x.float().clamp(min=eps)
    return (x**p).mean(dim=dim) ** (1.0 / p)


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=eps)


class GeMPool(nn.Module):
    """1x1 projection (Conv1d k=1 == Linear) to `proj_dim`, then GeM over tokens."""

    def __init__(self, in_dim: int, proj_dim: int, pool_param: float = 3.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.pool_param = pool_param
        self.proj = Linear(in_dim, proj_dim, dtype, device)

    def forward(self, tokens):  # [B, L, C]
        return gem_pool(self.proj(tokens), self.pool_param, dim=1)


class PatchEmbed(nn.Module):
    """Non-overlapping patch conv (stride == kernel), written as patch
    flatten + one matmul (no cuDNN, so no TF32 in f32). Weight is OIHW
    [C, 3, p, p] in `dtype`; images are NHWC."""

    def __init__(self, patch: int, dim: int, dtype=torch.float32, device=None,
                 bias: bool = True):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(
            torch.empty(dim, 3, patch, patch, dtype=dtype, device=device)
        )
        self.bias = (
            nn.Parameter(torch.empty(dim, dtype=torch.float32, device=device))
            if bias else None
        )

    def reset(self, generator: torch.Generator) -> None:
        _normal_(self.weight, (3 * self.patch**2) ** -0.5, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, images):  # [B, H, W, 3] -> [B, P, C]
        b, h, w, c = images.shape
        p = self.patch
        x = images.to(self.weight.dtype).reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), p * p * c)
        wt = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        return dense(x, wt, self.bias)  # a flax Conv adds its bias as a Dense does


class AttentionParams(nn.Module):
    """The {qkv, proj} Linears of an attention block (JAX `AttentionParams`)."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, dtype, device)
        self.proj = Linear(dim, dim, dtype, device)


class MultiHeadAttention(nn.Module):
    """Attention with a fused QKV projection (JAX `MultiHeadAttention`):
    params `qkv` (bias optional) and `proj`. With no `attn_bias` it runs
    `attention(q * hd^-0.5, k, v)` (B8 on the card, differentiable through
    its recompute VJP); with one, f32 logits scaled after the product plus
    the bias (the JAX einsum path, `layers.py:152-158`). Given a `DropRng`
    it applies `proj_drop` after the projection, as JAX in training;
    `attn_drop` is kept as a field and not applied (no model sets it)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = Linear(dim, 3 * dim, dtype, device, bias=qkv_bias)
        self.proj = Linear(dim, dim, dtype, device)

    def forward(self, x, attn_bias=None, rng=None):  # [B, L, C]
        b, l, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, l, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, L, H, hd]
        if attn_bias is None:
            out = attention((q * hd**-0.5).contiguous(), k.contiguous(), v.contiguous())
        else:
            logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * hd**-0.5
            probs = torch.softmax(logits + attn_bias, dim=-1).to(self.dtype)
            out = torch.einsum("bhlm,bmhd->blhd", probs.float(), v.float())
        out = self.proj(out.reshape(b, l, c).to(self.dtype))
        return dropout(out, self.proj_drop, rng, (self, "proj"))


class MlpParams(nn.Module):
    """The {fc1, fc2} Linears of a ViT MLP (JAX `MlpParams`)."""

    def __init__(self, dim: int, hidden: int, dtype, device):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype, device)
        self.fc2 = Linear(hidden, dim, dtype, device)


class Mlp(MlpParams):
    """The JAX `layers.Mlp` (`vsc22_tpu/models/layers.py:46-87`) with its
    output width equal to its input's, as every model here has it: fc1 ->
    exact GELU -> dropout -> fc2 -> dropout. With no dropout acting (rate
    0, or no `DropRng`: inference) it is kernel B7 (`ops/mlp.fused_mlp`:
    the kernel on a CUDA tensor, its plain version on a CPU one), the
    biases passed in the working dtype as JAX passes them; otherwise the
    plain MLP, fc1 and fc2 as flax Denses, its dropout masks drawn from the
    `DropRng`."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32, device=None,
                 dropout: float = 0.0):
        super().__init__(dim, hidden, dtype, device)
        self.dropout = dropout

    def forward(self, x, rng=None):
        fc1, fc2 = self.fc1, self.fc2
        dt = fc1.weight.dtype
        if rng is None or self.dropout == 0.0:
            y = fused_mlp(x.reshape(-1, x.shape[-1]).to(dt), fc1.weight, fc1.bias.to(dt),
                          fc2.weight, fc2.bias.to(dt))
            return y.reshape(x.shape)
        y = dropout(gelu_exact(fc1(x)), self.dropout, rng, (self, "hidden"))
        return dropout(fc2(y), self.dropout, rng, (self, "out"))


class TransformerBlock(nn.Module):
    """Pre-LN ViT encoder block: x + attn(LN1 x) through K1, then x +
    mlp(LN2 x) with exact GELU through K2; LN eps 1e-6 (flax default,
    `vsc22_tpu/models/layers.py:240`). Training takes the same kernels
    when dropout and drop-path are 0, differentiable through their
    recompute VJPs (`ops/vjp.py`); otherwise it takes JAX's plain path
    with dropout and DropPath (`layers.py:221-256`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, device=None, drop_path: float = 0.0,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.dropout = dropout
        self.norm1 = LayerNorm(dim, device)
        self.attn = AttentionParams(dim, dtype, device)
        self.norm2 = LayerNorm(dim, device)
        self.mlp = MlpParams(dim, int(dim * mlp_ratio), dtype, device)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, rng=None):  # [B, L, C]; rng: a DropRng in training
        if rng is not None and (self.dropout > 0.0 or self.drop_path1.rate > 0.0):
            return self._plain(x, rng)
        b, l, c = x.shape
        dt = self.dtype
        y = layer_norm(x, self.norm1, 1e-6, dt)
        qkv = linear_f32_bias(y, self.attn.qkv)
        x = attn_proj_residual(
            x.to(dt), qkv, self.attn.proj.weight, self.attn.proj.bias, self.num_heads
        )
        return ln_mlp_residual(
            x.reshape(b * l, c), self.norm2.weight, self.norm2.bias,
            self.mlp.fc1.weight, self.mlp.fc1.bias,
            self.mlp.fc2.weight, self.mlp.fc2.bias, "gelu", 1e-6,
        ).reshape(b, l, c)

    def _plain(self, x, rng):
        """The train path with dropout and DropPath, in JAX's roundings:
        attention as `_attn_proj_xla`, LN2 with two-pass f32 statistics,
        fc1 and fc2 as flax Denses in the working dtype."""
        b, l, c = x.shape
        h, dt = self.num_heads, self.dtype
        hd = c // h
        y = layer_norm(x, self.norm1, 1e-6, dt)
        r = linear_f32_bias(y, self.attn.qkv).reshape(b, l, 3, h, hd).float()
        logits = torch.einsum("blhd,bmhd->bhlm", r[:, :, 0], r[:, :, 1]) * hd**-0.5
        probs = torch.softmax(logits, dim=-1).to(dt).float()
        out = torch.einsum("bhlm,bmhd->blhd", probs, r[:, :, 2]).to(dt).reshape(b, l, c)
        out = (matmul_f32(out, self.attn.proj.weight.t()) + self.attn.proj.bias).to(dt)
        out = dropout(out, self.dropout, rng, (self, "attn"))
        x = x + self.drop_path1(out, rng)
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + 1e-6) * self.norm2.weight
             + self.norm2.bias).to(dt)
        y = dropout(gelu_exact(self.mlp.fc1(y)), self.dropout, rng, (self, "hidden"))
        y = dropout(self.mlp.fc2(y), self.dropout, rng, (self, "mlp"))
        return x + self.drop_path2(y, rng)
