"""Swin Transformer V2 backbone + GeM descriptor head.

Counterpart of `vsc22_tpu/models/swinv2.py` (SwinV2-Base@256: patch 4,
window 16, embed 128, depths [2, 2, 18, 2], heads [4, 8, 16, 32]; the v106,
v107 and v115 ensemble members): res-post-norm blocks with cosine window
attention, a log-spaced continuous relative position bias (CPB MLP,
16 * sigmoid), the exp-clamped per-head logit scale, q/v biases only,
v2 patch merging (Linear 4C -> 2C without bias, then LN), final LN, GeM(p=3)
over tokens and a Linear head. Images are NHWC.

Each `SwinBlock` takes one of the JAX model's two paths, chosen as
`swinv2.py:322-332` chooses on a TPU and on every device alike, so that the
card and the CPU round the same way:
  - the fused path: the whole block in kernel B1 (`ops/swin_block.py`),
    around a torch roll and window partition;
  - the module path: the QKV and proj GEMMs in torch, the attention in
    kernel B6 (`ops/window_attn.py`), flax-style LNs and the MLP in kernel
    B7 (`layers.Mlp`, on `ops/mlp.fused_mlp`).
The fused path is taken when C and the MLP width are multiples of 128 and
the TPU kernel's VMEM estimate for one window is under 48 MiB: every block
of the Base model in bf16, all but stage 4 in f32, none at the tiny test
widths. `fused_block=False` forces the module path.

Training (`train=True`) takes JAX's train route (`swinv2.py:207-222,
322-333, 456-460`): never the fused block, the module path with the plain
attention chunked over windows (`ops/window_attn.window_attention_chunked`,
not B6), the MLP in B7 (differentiable through its recompute VJP), and
DropPath at `linspace(0, drop_path_rate, depth)` on both branches, its
masks from a `layers.DropRng`. With `remat` each block runs under
`torch.utils.checkpoint`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    _normal_,
    dense,
    dropout,
    gem_pool,
    layer_norm,
)
from vsc22_tpu_torch.ops.swin_block import swin_block
from vsc22_tpu_torch.ops.window_attn import window_attention, window_attention_chunked

_LN_EPS = 1e-6  # flax nn.LayerNorm default


@dataclasses.dataclass(frozen=True)
class SwinV2Config:
    img_size: int = 256
    patch_size: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 16
    pretrained_window_sizes: Tuple[int, ...] = (12, 12, 12, 6)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2
    dropout: float = 0.0
    output_dim: int = 512
    pool_param: float = 3.0

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


SWINV2_BASE_256 = SwinV2Config()
SWINV2_TINY_TEST = SwinV2Config(
    img_size=32,
    patch_size=4,
    embed_dim=16,
    depths=(1, 2),
    num_heads=(2, 4),
    window_size=4,
    pretrained_window_sizes=(0, 0),
    drop_path_rate=0.0,
    output_dim=8,
)


# --- geometry: copies of `vsc22_tpu/models/swinv2.py:82-139` ---------------


def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """[Wh*Ww, Wh*Ww] index into the (2Wh-1)(2Ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _relative_coords_table(wh: int, ww: int, pretrained: int) -> np.ndarray:
    """[1, 2Wh-1, 2Ww-1, 2] log-spaced normalized relative coordinates."""
    ch = np.arange(-(wh - 1), wh, dtype=np.float32)
    cw = np.arange(-(ww - 1), ww, dtype=np.float32)
    table = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1)[None]  # 1,2Wh-1,2Ww-1,2
    denom_h = (pretrained - 1) if pretrained > 0 else (wh - 1)
    denom_w = (pretrained - 1) if pretrained > 0 else (ww - 1)
    table[..., 0] /= max(denom_h, 1)
    table[..., 1] /= max(denom_w, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """[nW, N, N] additive mask (-100 across shifted-window region seams)."""
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = (
        img_mask.reshape(h // window, window, w // window, window)
        .transpose(0, 2, 1, 3)
        .reshape(-1, window * window)
    )
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, window*window, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, window*window, C] -> [B, H, W, C]."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // window // window)
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _vmem_estimate(g: int, n: int, c: int, f: int, h: int, itemsize: int) -> int:
    """The TPU whole-block kernel's VMEM estimate
    (`vsc22_tpu/ops/pallas_swin_block.py:359-378`, with the mask counted as
    `swinv2.py:330` calls it), kept only to choose the block's path as the
    JAX model does."""
    batched = n % 128 == 0
    gn = g * n if batched else n
    x_out = 2 * 2 * g * n * c * itemsize
    weights = (4 * c * c + c * f + f * c) * itemsize + 2 * h * (c // h) * 4
    rpb = h * n * n * 4
    mask = 2 * g * n * n * 4
    temps = gn * f * 4 + gn * f * itemsize + 4 * n * n * 4 + 6 * gn * c * 4
    kp = 2 * 128 * 4 * n * itemsize
    scratch = (2 * gn * c * 4 + 4 * gn * c * itemsize) if batched else 0
    return x_out + weights + rpb + mask + temps + kp + scratch


class WindowAttention(nn.Module):
    """The `attn` parameters of a SwinV2 block (JAX `WindowAttention` /
    `_WindowAttnParams`: same tree), the bias and scale they give, and the
    module path's attention."""

    def __init__(self, dim: int, window: int, num_heads: int, pretrained_window: int = 0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        h = num_heads
        self.logit_scale = nn.Parameter(
            torch.full((h, 1, 1), math.log(10.0), dtype=torch.float32, device=device)
        )
        self.qkv_weight = nn.Parameter(torch.empty(3 * dim, dim, dtype=dtype, device=device))
        self.q_bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
        self.v_bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))
        self.cpb_fc1 = Linear(2, 512, torch.float32, device)
        self.cpb_fc2 = Linear(512, h, torch.float32, device, bias=False)
        self.proj = Linear(dim, dim, dtype, device)
        table = _relative_coords_table(window, window, pretrained_window)
        index = _relative_position_index(window, window).reshape(-1)
        self.register_buffer("coords_table", torch.from_numpy(table).to(device), persistent=False)
        self.register_buffer("rel_index", torch.from_numpy(index).to(device), persistent=False)

    def reset(self, generator: torch.Generator) -> None:
        """logit_scale = ln 10 as in JAX; QKV weight N(0, 1/C); q and v
        biases N(0, 0.02^2), so both bias paths carry weight."""
        with torch.no_grad():
            self.logit_scale.fill_(math.log(10.0))
        _normal_(self.qkv_weight, self.qkv_weight.shape[1] ** -0.5, generator)
        _normal_(self.q_bias, 0.02, generator)
        _normal_(self.v_bias, 0.02, generator)

    def qkv_bias(self) -> torch.Tensor:
        """[3C] f32: q bias, zero k bias, v bias."""
        return torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])

    def bias_and_scale(self):
        """(rpb [H, N, N] = 16 * sigmoid(CPB MLP), scale [H] =
        exp(min(logit_scale, ln 100))), both f32 (`swinv2.py:253-263`)."""
        h = self.num_heads
        cpb = self.cpb_fc2(torch.relu(self.cpb_fc1(self.coords_table))).reshape(-1, h)
        n = math.isqrt(self.rel_index.numel())
        rpb = cpb[self.rel_index].reshape(n, n, h).permute(2, 0, 1)
        rpb = 16.0 * torch.sigmoid(rpb)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0))).reshape(h)
        return rpb.contiguous(), scale

    def forward(self, x: torch.Tensor, mask: torch.Tensor, num_shift_windows: int,
                train: bool = False):
        """The module path (`swinv2.py:174-225`): x [W, N, C] windows ->
        [W, N, C] in the model dtype; B6 in inference, the chunked plain
        attention in training."""
        dt = self.dtype
        b_, n, c = x.shape
        h = self.num_heads
        qkv = dense(x, self.qkv_weight, self.qkv_bias())
        q, k, v = qkv.reshape(b_, n, 3, h, c // h).permute(2, 0, 3, 1, 4).contiguous()
        rpb, scale = self.bias_and_scale()
        attend = window_attention_chunked if train else window_attention
        out = attend(q, k, v, rpb, scale, mask, num_shift_windows)
        out = out.permute(0, 2, 1, 3).reshape(b_, n, c).to(dt)
        return self.proj(out)


class SwinBlock(nn.Module):
    """Res-post-norm SwinV2 block. Window and shift are clamped as in JAX:
    a stage whose resolution is at most the window uses one window per
    image and no shift. In inference it takes B1 or the module path (B6,
    B7); in training (`train=True`) always the module path, with the plain
    chunked attention, B7 through its recompute VJP, and DropPath at
    `drop_path` on both residual branches (`swinv2.py:322-410`)."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float = 4.0, pretrained_window: int = 0,
                 dtype=torch.float32, device=None, fused_block: Optional[bool] = None,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        res = input_resolution
        window, shift = window_size, shift_size
        if res <= window:
            window, shift = res, 0
        self.dim, self.res, self.window, self.shift = dim, res, window, shift
        self.num_heads = num_heads
        self.dtype = dtype
        self.hidden = int(dim * mlp_ratio)
        self.attn = WindowAttention(dim, window, num_heads, pretrained_window, dtype, device)
        self.norm1 = LayerNorm(dim, device)
        self.mlp = Mlp(dim, self.hidden, dtype, device)
        self.norm2 = LayerNorm(dim, device)
        n = window * window
        mask = (
            _shift_attn_mask(res, res, window, shift) if shift > 0
            else np.zeros((1, n, n), np.float32)
        )
        self.register_buffer("mask", torch.from_numpy(mask).to(device), persistent=False)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.fused = (
            (fused_block is None or fused_block)
            and dim % 128 == 0
            and self.hidden % 128 == 0
            and _vmem_estimate(1, n, dim, self.hidden, num_heads, itemsize) < 48 * 2**20
        )

    def forward(self, x: torch.Tensor, rng=None, train: bool = False) -> torch.Tensor:
        """x [B, L, C]; `train` takes the train route, `rng` (a
        `layers.DropRng`) draws its DropPath masks."""
        b, l, c = x.shape
        r, window, shift, dt = self.res, self.window, self.shift, self.dtype
        nw = self.mask.shape[0]
        fused = self.fused and not train
        xs = x.reshape(b, r, r, c)
        if shift > 0:
            xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
        windows = window_partition(xs, window)
        if fused:
            rpb, scale = self.attn.bias_and_scale()
            a, mlp = self.attn, self.mlp
            out_w = swin_block(
                windows.to(dt).contiguous(), a.qkv_weight, a.qkv_bias(),
                a.proj.weight, a.proj.bias, self.norm1.weight, self.norm1.bias,
                mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias,
                self.norm2.weight, self.norm2.bias, rpb, scale, self.mask,
                self.num_heads, nw,
            )
        else:
            out_w = self.attn(windows, self.mask, nw, train)
        xs = window_reverse(out_w, window, r, r)
        if shift > 0:
            xs = torch.roll(xs, shifts=(shift, shift), dims=(1, 2))
        xs = xs.reshape(b, l, c)
        if fused:
            return xs
        # Module path: flax LNs and residual adds in the model dtype.
        x = x.to(dt) + self.drop_path1(layer_norm(xs, self.norm1, _LN_EPS, dt), rng)
        y = self.mlp(x)  # B7: the block's MLP has no dropout
        return x + self.drop_path2(layer_norm(y, self.norm2, _LN_EPS, dt), rng)


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat -> Linear(4C -> 2C, no bias) -> LayerNorm."""

    def __init__(self, dim: int, input_resolution: int, dtype=torch.float32, device=None):
        super().__init__()
        self.res = input_resolution
        self.dtype = dtype
        self.reduction = Linear(4 * dim, 2 * dim, dtype, device, bias=False)
        self.norm = LayerNorm(2 * dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        r = self.res
        xs = x.reshape(b, r, r, c)
        parts = [xs[:, 0::2, 0::2], xs[:, 1::2, 0::2], xs[:, 0::2, 1::2], xs[:, 1::2, 1::2]]
        xs = torch.cat(parts, dim=-1).reshape(b, (r // 2) ** 2, 4 * c)
        xs = self.reduction(xs)
        return layer_norm(xs, self.norm, _LN_EPS, self.dtype)


class SwinTransformerV2(nn.Module):
    """SwinV2 encoder + GeM(p) token pooling + Linear head; returns
    [B, output_dim] un-normalized f32 descriptors. `remat`: in training,
    each block under `torch.utils.checkpoint` (JAX's per-block `nn.remat`,
    `swinv2.py:459-460`), so that only block-boundary activations stay
    for the backward."""

    def __init__(self, cfg: SwinV2Config = SWINV2_BASE_256, dtype=torch.float32, device=None,
                 fused_block: Optional[bool] = None, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
        self.out_dim = cfg.output_dim
        res = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim, dtype, device)
        self.patch_norm = LayerNorm(cfg.embed_dim, device)
        self.stages = nn.ModuleList()
        self.merges = nn.ModuleList()
        for s, depth in enumerate(cfg.depths):
            dim = cfg.embed_dim * 2**s
            r = res // 2**s
            self.stages.append(nn.ModuleList(
                SwinBlock(
                    dim, r, cfg.num_heads[s], cfg.window_size,
                    0 if i % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio,
                    cfg.pretrained_window_sizes[s], dtype, device, fused_block,
                    float(dpr[sum(cfg.depths[:s]) + i]),
                )
                for i in range(depth)
            ))
            if s < len(cfg.depths) - 1:
                self.merges.append(PatchMerging(dim, r, dtype, device))
        self.norm = LayerNorm(cfg.num_features, device)
        self.output_proj = Linear(cfg.num_features, cfg.output_dim, torch.float32, device)

    def forward(self, images: torch.Tensor, train: bool = False,
                rng=None) -> torch.Tensor:  # [B, H, W, 3]
        """`train` takes the train route; `rng` (a `layers.DropRng`) draws
        its dropout and DropPath masks and is needed where a rate is above 0."""
        cfg = self.cfg
        b, h, w, _ = images.shape
        if h != cfg.img_size or w != cfg.img_size:
            raise ValueError(f"expected {cfg.img_size}^2 input, got {h}x{w}")
        if train and rng is None and (cfg.drop_path_rate > 0.0 or cfg.dropout > 0.0):
            raise ValueError("training with dropout or drop-path needs a DropRng")
        rng = rng if train else None
        dt = self.dtype
        x = layer_norm(self.patch_embed(images), self.patch_norm, _LN_EPS, dt)
        x = dropout(x, cfg.dropout, rng, (self, "embed"))
        for s, blocks in enumerate(self.stages):
            for block in blocks:
                if train and self.remat:
                    x = checkpoint(block, x, rng, True, use_reentrant=False)
                else:
                    x = block(x, rng, train)
            if s < len(self.merges):
                x = self.merges[s](x)
        x = layer_norm(x, self.norm, _LN_EPS, dt)
        return self.output_proj(gem_pool(x, cfg.pool_param, axis=1))


def swinv2_base_256_descriptor(dtype=torch.bfloat16, device="cuda",
                               fused_block: Optional[bool] = None,
                               remat: bool = False) -> SwinTransformerV2:
    """The v106/v107/v115 ensemble members: SwinV2-Base @ 256, 512-d out;
    on the card unless `device` says otherwise."""
    return SwinTransformerV2(SWINV2_BASE_256, dtype, resolve(device), fused_block, remat)


def swinv2_tiny_test_descriptor(dtype=torch.float32, device=None, remat: bool = False,
                                output_dim=None, img_size=None,
                                window_size=None) -> SwinTransformerV2:
    """Small config for tests and CPU runs (on the CPU by default: it
    exists for tests). `output_dim`, `img_size` and `window_size` override
    the test config, as the JAX builder's do (registry configs pass them
    through: the learning demo trains a 32-d model at 64^2, window 8)."""
    over = {key: int(v) for key, v in (("output_dim", output_dim), ("img_size", img_size),
                                       ("window_size", window_size)) if v is not None}
    cfg = dataclasses.replace(SWINV2_TINY_TEST, **over)
    return SwinTransformerV2(cfg, dtype, device, remat=remat)
