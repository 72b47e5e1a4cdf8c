"""Swin Transformer v1 backbone + GeM descriptor head.

Counterpart of `vsc22_tpu/models/swin_v1.py` (Swin-T v1 at 224: patch 4,
embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 7, f32; part of
the legacy zoo). Unlike SwinV2 (`models/swinv2.py`): pre-norm blocks,
scaled dot-product window attention with a learned relative-position-bias
table [(2w - 1)^2, H] indexed by `swinv2._relative_position_index`, and
patch merging that normalises the 4C concat before its 4C -> 2C
reduction. Window partition and reverse and the shift mask are SwinV2's,
as in JAX. The window attention and its products are plain torch (plain
XLA in JAX); each block's MLP is `layers.Mlp`, kernel B7 on the card.

`train=True` with a `layers.DropRng` applies DropPath at
`linspace(0, drop_path_rate, depth)` on both residual branches of each
block (0.1 at the top for Swin-T) and `cfg.dropout` after the patch
embedding, as the JAX model does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    dropout,
    gem_pool,
    layer_norm,
)
from vsc22_tpu_torch.models.swinv2 import (
    _relative_position_index,
    _shift_attn_mask,
    window_partition,
    window_reverse,
)

_LN_EPS = 1e-6  # flax nn.LayerNorm default


@dataclasses.dataclass(frozen=True)
class SwinV1Config:
    img_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    dropout: float = 0.0
    ape: bool = False  # absolute position embedding
    output_dim: int = 256
    pool_param: float = 3.0

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


SWIN_V1_TINY_224 = SwinV1Config()
SWIN_V1_TINY_TEST = SwinV1Config(
    img_size=32,
    patch_size=4,
    embed_dim=16,
    depths=(1, 2),
    num_heads=(2, 4),
    window_size=4,
    drop_path_rate=0.0,
    output_dim=8,
)


class WindowAttentionV1(nn.Module):
    """Scaled dot-product window attention with a learned RPB table, as
    `swin_v1.py:79-117` computes it: q scaled by hd^-0.5 in the model
    dtype, f32 logits + the table's bias (+ the shift mask), softmax rounded
    to the model dtype, P.V in the model dtype, then `proj`."""

    def __init__(self, dim: int, window: int, num_heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Linear(dim, 3 * dim, dtype, device)
        self.rpb_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads, dtype=torch.float32, device=device))
        self.proj = Linear(dim, dim, dtype, device)
        index = _relative_position_index(window, window).reshape(-1)
        self.register_buffer("rel_index", torch.from_numpy(index).to(device), persistent=False)

    def forward(self, x, mask=None):  # x [bw, n, c]; mask [nW, n, n] or None
        bw, n, c = x.shape
        h, dt = self.num_heads, self.dtype
        hd = c // h
        qkv = self.qkv(x).reshape(bw, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [bw, h, n, hd]
        logits = torch.einsum("bhnd,bhmd->bhnm", (q * hd**-0.5).float(), k.float())
        rpb = self.rpb_table[self.rel_index].reshape(n, n, h).permute(2, 0, 1)
        logits = logits + rpb[None]
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(bw // nw, nw, h, n, n) + mask[None, :, None]).reshape(
                bw, h, n, n)
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhnm,bhmd->bhnd", probs.float(), v.float()).to(dt)
        return self.proj(out.permute(0, 2, 1, 3).reshape(bw, n, c))


class SwinBlockV1(nn.Module):
    """Pre-norm Swin v1 block (`swin_v1.py:120-162`): x + attn(LN1 x) over
    (shifted) windows, then x + mlp(LN2 x). A stage whose resolution is at
    most the window takes one window per image and no shift."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        res = input_resolution
        window, shift = window_size, shift_size
        if res <= window:
            window, shift = res, 0
        self.res, self.window, self.shift = res, window, shift
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, device)
        self.attn = WindowAttentionV1(dim, window, num_heads, dtype, device)
        self.norm2 = LayerNorm(dim, device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, device)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        mask = _shift_attn_mask(res, res, window, shift) if shift > 0 else None
        self.register_buffer("mask", None if mask is None else torch.from_numpy(mask).to(device),
                             persistent=False)

    def forward(self, x, rng=None):  # [B, L, C]
        b, l, c = x.shape
        r, window, shift, dt = self.res, self.window, self.shift, self.dtype
        xs = layer_norm(x, self.norm1, _LN_EPS, dt).reshape(b, r, r, c)
        if shift > 0:
            xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
        xs = window_reverse(self.attn(window_partition(xs, window), self.mask), window, r, r)
        if shift > 0:
            xs = torch.roll(xs, shifts=(shift, shift), dims=(1, 2))
        x = x + self.drop_path1(xs.reshape(b, l, c), rng)
        y = self.mlp(layer_norm(x, self.norm2, _LN_EPS, dt), rng)
        return x + self.drop_path2(y, rng)


class PatchMergingV1(nn.Module):
    """v1 merge order: 2x2 neighbourhood concat -> LayerNorm on the 4C
    concat -> Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, input_resolution: int, dtype=torch.float32, device=None):
        super().__init__()
        self.res = input_resolution
        self.dtype = dtype
        self.norm = LayerNorm(4 * dim, device)
        self.reduction = Linear(4 * dim, 2 * dim, dtype, device, bias=False)

    def forward(self, x):
        b, _, c = x.shape
        r = self.res
        xs = x.reshape(b, r, r, c)
        parts = [xs[:, 0::2, 0::2], xs[:, 1::2, 0::2], xs[:, 0::2, 1::2], xs[:, 1::2, 1::2]]
        xs = torch.cat(parts, dim=-1).reshape(b, (r // 2) ** 2, 4 * c)
        return self.reduction(layer_norm(xs, self.norm, _LN_EPS, self.dtype))


class SwinTransformerV1(nn.Module):
    """Swin v1 encoder + GeM(p) token pooling + Linear head; [B, output_dim]
    un-normalized f32 descriptors."""

    def __init__(self, cfg: SwinV1Config = SWIN_V1_TINY_224, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.out_dim = cfg.output_dim
        res = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim, dtype, device)
        self.patch_norm = LayerNorm(cfg.embed_dim, device)
        self.absolute_pos_embed = (
            nn.Parameter(torch.zeros(1, res * res, cfg.embed_dim, device=device))
            if cfg.ape else None
        )
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
        self.stages = nn.ModuleList()
        self.merges = nn.ModuleList()
        for s, depth in enumerate(cfg.depths):
            dim = cfg.embed_dim * 2**s
            r = res // 2**s
            self.stages.append(nn.ModuleList(
                SwinBlockV1(dim, r, cfg.num_heads[s], cfg.window_size,
                            0 if i % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio,
                            float(dpr[sum(cfg.depths[:s]) + i]), dtype, device)
                for i in range(depth)
            ))
            if s < len(cfg.depths) - 1:
                self.merges.append(PatchMergingV1(dim, r, dtype, device))
        self.norm = LayerNorm(cfg.num_features, device)
        self.output_proj = Linear(cfg.num_features, cfg.output_dim, torch.float32, device)

    def forward(self, images, train: bool = False, rng=None):  # [B, H, W, 3]
        """`rng` (a `layers.DropRng`) draws the DropPath and dropout masks
        when `train`; training with a rate above 0 needs one."""
        cfg = self.cfg
        b, h, w, _ = images.shape
        if h != cfg.img_size or w != cfg.img_size:
            raise ValueError(f"expected {cfg.img_size}^2 input, got {h}x{w}")
        if train and rng is None and (cfg.drop_path_rate > 0.0 or cfg.dropout > 0.0):
            raise ValueError("training with dropout or drop-path needs a DropRng")
        rng = rng if train else None
        dt = self.dtype
        x = layer_norm(self.patch_embed(images), self.patch_norm, _LN_EPS, dt)
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(dt)
        x = dropout(x, cfg.dropout, rng, (self, "embed"))
        for s, blocks in enumerate(self.stages):
            for block in blocks:
                x = block(x, rng)
            if s < len(self.merges):
                x = self.merges[s](x)
        x = layer_norm(x, self.norm, _LN_EPS, dt)
        return self.output_proj(gem_pool(x, cfg.pool_param, axis=1))


def swin_v1_tiny_224(dtype=torch.float32, device="cuda") -> SwinTransformerV1:
    """Swin-T v1 @ 224, 256-d out, f32; on the card unless `device` says
    otherwise."""
    return SwinTransformerV1(SWIN_V1_TINY_224, dtype, resolve(device))


def swin_v1_tiny_test(dtype=torch.float32, device=None) -> SwinTransformerV1:
    """Small config for tests (on the CPU by default: it exists for tests)."""
    return SwinTransformerV1(SWIN_V1_TINY_TEST, dtype, device)
