"""CLIP visual encoder (ViT-L/14 style).

Counterpart of `vsc22_tpu/models/clip.py`: patch conv without bias, class
embedding, learned positions, ln_pre, pre-LN blocks with QuickGELU MLPs,
ln_post, no projection; returns all tokens (the VED gate takes CLS). LN
eps is 1e-5. A block runs one of the JAX `CLIPBlock`'s three paths
(`clip.py:88-134`), chosen by its flags (plain attributes, read at each
call; both False by default, as in the JAX package):
- default: LN1 (two-pass stats) + the QKV GEMM in torch, then K1 for
  attention + projection + residual and K2 for LN2 + MLP + residual;
- `use_half_block`: B9 for LN1 + QKV + attention + projection + residual,
  then K2;
- `use_block_kernel`: B10 for the whole block.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import (
    AttentionParams,
    LayerNorm,
    Linear,
    PatchEmbed,
    layer_norm,
    linear_f32_bias,
)
from vsc22_tpu_torch.ops.attn_proj import attn_proj_residual, ln_attn_proj_residual
from vsc22_tpu_torch.ops.mlp import ln_mlp_residual, ln_rows
from vsc22_tpu_torch.ops.vit_block import vit_block


@dataclasses.dataclass(frozen=True)
class CLIPVisualConfig:
    img_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16

    @property
    def num_tokens(self) -> int:
        return (self.img_size // self.patch_size) ** 2 + 1


CLIP_VIT_L14 = CLIPVisualConfig()
CLIP_TINY_TEST = CLIPVisualConfig(img_size=32, patch_size=8, width=32, layers=2, heads=2)

_CLIP_LN_EPS = 1e-5


def _ln_two_pass(x, ln: LayerNorm, dtype, eps: float = _CLIP_LN_EPS):
    """`clip._ln`: two-pass stats, (x - mean) * rsqrt(var + eps) * s + b,
    computed as the kernels' LN prologue computes it (`mlp.ln_rows`)."""
    return ln_rows(x.float(), ln.weight, ln.bias, eps).to(dtype)


class CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32, device=None,
                 use_block_kernel: bool = False, use_half_block: bool = False):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.use_block_kernel = use_block_kernel
        self.use_half_block = use_half_block
        self.ln_1 = LayerNorm(width, device)
        self.attn = AttentionParams(width, dtype, device)
        self.ln_2 = LayerNorm(width, device)
        self.c_fc = Linear(width, 4 * width, dtype, device)
        self.c_proj = Linear(4 * width, width, dtype, device)

    def forward(self, x):  # [B, L, C]
        b, l, c = x.shape
        dt = self.dtype
        qkv_w, qkv_b = self.attn.qkv.weight, self.attn.qkv.bias
        proj_w, proj_b = self.attn.proj.weight, self.attn.proj.bias
        if self.use_block_kernel:
            return vit_block(
                x.to(dt), self.ln_1.weight, self.ln_1.bias, qkv_w, qkv_b, proj_w, proj_b,
                self.ln_2.weight, self.ln_2.bias, self.c_fc.weight, self.c_fc.bias,
                self.c_proj.weight, self.c_proj.bias, self.heads, "quick_gelu", _CLIP_LN_EPS,
            )
        if self.use_half_block:
            x = ln_attn_proj_residual(
                x.to(dt), self.ln_1.weight, self.ln_1.bias, qkv_w, qkv_b, proj_w, proj_b,
                self.heads, _CLIP_LN_EPS,
            )
        else:
            qkv = linear_f32_bias(_ln_two_pass(x, self.ln_1, dt), self.attn.qkv)
            x = attn_proj_residual(x.to(dt), qkv, proj_w, proj_b, self.heads)
        return ln_mlp_residual(
            x.reshape(b * l, c), self.ln_2.weight, self.ln_2.bias,
            self.c_fc.weight, self.c_fc.bias, self.c_proj.weight, self.c_proj.bias,
            "quick_gelu", _CLIP_LN_EPS,
        ).reshape(b, l, c)


class CLIPVisual(nn.Module):
    """Returns all tokens [B, 1+P, width] after ln_post (CLS first)."""

    def __init__(self, cfg: CLIPVisualConfig = CLIP_VIT_L14, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        w = cfg.width
        self.conv1 = PatchEmbed(cfg.patch_size, w, dtype, device, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.num_tokens, w, device=device))
        self.ln_pre = LayerNorm(w, device)
        self.blocks = nn.ModuleList(
            CLIPBlock(w, cfg.heads, dtype, device) for _ in range(cfg.layers)
        )
        self.ln_post = LayerNorm(w, device)

    def forward(self, images):  # [B, H, W, 3]
        cfg = self.cfg
        b, h, w, _ = images.shape
        if h != cfg.img_size or w != cfg.img_size:
            raise ValueError(f"expected {cfg.img_size}^2 input, got {h}x{w}")
        dt = self.dtype
        x = self.conv1(images)
        cls = self.class_embedding.to(dt).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = layer_norm(x, self.ln_pre, _CLIP_LN_EPS, dt)
        for block in self.blocks:
            x = block(x)
        return layer_norm(x, self.ln_post, _CLIP_LN_EPS, dt)


def clip_vit_l14(dtype=torch.bfloat16, device="cuda") -> CLIPVisual:
    """The VED gate's CLIP ViT-L/14; on the card unless `device` says otherwise."""
    return CLIPVisual(CLIP_VIT_L14, dtype, resolve(device))


def clip_tiny_test(dtype=torch.float32, device=None) -> CLIPVisual:
    """Small config for tests (on the CPU by default: it exists for tests)."""
    return CLIPVisual(CLIP_TINY_TEST, dtype, device)
