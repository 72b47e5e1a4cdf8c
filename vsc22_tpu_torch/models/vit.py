"""Vision Transformer backbone + SSCD-style descriptor head.

Counterpart of `vsc22_tpu/models/vit.py`: the v68 descriptor is
Linear_2048->512( GeM_p3( Conv1d_768->2048( all ViT tokens ) ) ), GeM over
the token axis (CLS included). Images are NHWC; the GeM pool and the head
run in f32 even in a bf16 model (`vit.py:113`). `train=True` with a
`layers.DropRng` applies `cfg.dropout` after the position embedding and
in each block, and DropPath at `cfg.drop_path * i / (depth - 1)` in block
i (`vit.py:26-90`); with both at 0 (the v68 recipe) training runs the
same kernels as inference.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import (
    GeMPool,
    LayerNorm,
    Linear,
    PatchEmbed,
    TransformerBlock,
    dropout,
    layer_norm,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 384
    patch_size: int = 32
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    drop_path: float = 0.0

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


VIT_BASE_PATCH32_384 = ViTConfig()
VIT_TINY_TEST = ViTConfig(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2)


class VisionTransformer(nn.Module):
    """Plain ViT encoder; returns all tokens [B, 1+P, C] (CLS first)."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, c, dtype, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.num_patches, c, device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(c, cfg.num_heads, cfg.mlp_ratio, dtype, device,
                             cfg.drop_path * i / max(cfg.depth - 1, 1), cfg.dropout)
            for i in range(cfg.depth)
        )
        self.norm = LayerNorm(c, device)

    def forward(self, images, rng=None):  # [B, H, W, 3]; rng: a DropRng in training
        cfg = self.cfg
        b, h, w, _ = images.shape
        if h != cfg.img_size or w != cfg.img_size:
            raise ValueError(f"expected {cfg.img_size}^2 input, got {h}x{w}")
        dt = self.dtype
        x = self.patch_embed(images)
        cls = self.cls_token.to(dt).expand(b, 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = dropout(x, cfg.dropout, rng, (self, "embed"))
        for block in self.blocks:
            x = block(x, rng)
        return layer_norm(x, self.norm, 1e-6, dt)


class VitDescriptor(nn.Module):
    """ViT backbone + (1x1 proj -> GeM -> Linear) head; [B, out_dim]
    un-normalized f32 descriptors."""

    def __init__(self, cfg: ViTConfig = VIT_BASE_PATCH32_384, pool_param: float = 3.0,
                 head_dim: int = 2048, out_dim: int = 512, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.out_dim = out_dim
        self.backbone = VisionTransformer(cfg, dtype, device)
        self.gem = GeMPool(cfg.embed_dim, head_dim, pool_param, dtype, device)
        self.head = Linear(head_dim, out_dim, torch.float32, device)

    def forward(self, images, train: bool = False, rng=None):
        """`rng` (a `layers.DropRng`) draws the dropout and DropPath masks
        when `train`; training with a rate above 0 needs one."""
        cfg = self.backbone.cfg
        if train and rng is None and (cfg.dropout > 0.0 or cfg.drop_path > 0.0):
            raise ValueError("training with dropout or drop-path needs a DropRng")
        return self.head(self.gem(self.backbone(images, rng if train else None)))


def vit_base_patch32_384_descriptor(dtype=torch.bfloat16, device="cuda") -> VitDescriptor:
    """The v68 ensemble member: ViT-B/32 @ 384, 512-d descriptors; on the
    card unless `device` says otherwise."""
    return VitDescriptor(VIT_BASE_PATCH32_384, dtype=dtype, device=resolve(device))


def vit_tiny_test_descriptor(dtype=torch.float32, device=None) -> VitDescriptor:
    """Small config for unit tests and CPU runs (on the CPU by default: it
    exists for tests)."""
    return VitDescriptor(VIT_TINY_TEST, head_dim=64, out_dim=16, dtype=dtype, device=device)
