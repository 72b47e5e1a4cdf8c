"""HRNet-W18 + fusion head: the Similarity Alignment Model (SAM).

Counterpart of `vsc22_tpu/models/hrnet.py`: timm `hrnet_w18` features with
both stem strides set to 1 (full input resolution), the five feature maps
(stem 64 ch + the final stage's 18/36/72/144-ch branches) fused by a 1x1
conv to 64 channels, relu, and a 1x1 conv to a 2-channel per-pixel map.
Activations are NHWC, as in the JAX modules.

The head's first conv runs in the JAX package's split form: each scale's
slice of the [334, 64] kernel at that branch's own resolution, products
accumulated in float32, upsampled and summed in float32, so the
334-channel concat at full resolution never exists.

`s2d_branch0` keeps the numerics of the JAX packed branch 0 (its BN folded
into two constants and applied in the compute dtype) on the branch-0
blocks, at inference, for even H and W. The space-to-depth layout itself,
a TPU lane-width device, is not kept: the convolutions are the same sums.

`train=True` is flax's `train`: every BN normalises with the batch's
statistics and updates its running ones. It runs on the unpacked path
only: a model built with `s2d_branch0` raises in train mode, as the JAX
packed branch asserts `not train`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import BatchNorm, Conv, _normal_, matmul_f32


@dataclasses.dataclass(frozen=True)
class HRNetConfig:
    width: int = 18
    layer1_blocks: int = 4
    stage_modules: Tuple[int, int, int] = (1, 4, 3)  # stages 2, 3, 4
    blocks_per_branch: int = 4
    stem_stride: int = 1  # SAM sets the usual 2 to 1 (full resolution)
    stem_channels: int = 64

    @property
    def branch_channels(self) -> Tuple[int, ...]:
        return (self.width, 2 * self.width, 4 * self.width, 8 * self.width)


HRNET_W18_SAM = HRNetConfig()
HRNET_TINY_TEST = HRNetConfig(
    width=4, layer1_blocks=1, stage_modules=(1, 1, 1), blocks_per_branch=1, stem_channels=8
)


class ConvBN(nn.Module):
    """Conv (timm's symmetric padding) + BN + optional relu."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, (kernel - 1) // 2, 1, dtype, device)
        self.bn = BatchNorm(cout, device)
        self.act = act

    def forward(self, x, folded: bool = False, train: bool = False):
        y = self.conv(x)
        y = self.bn.folded(y) if folded else self.bn(y, train)
        return F.relu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, dtype, device):
        super().__init__()
        out_ch = 4 * planes
        self.conv1 = ConvBN(cin, planes, 1, dtype=dtype, device=device)
        self.conv2 = ConvBN(planes, planes, 3, dtype=dtype, device=device)
        self.conv3 = ConvBN(planes, out_ch, 1, act=False, dtype=dtype, device=device)
        self.downsample = (
            ConvBN(cin, out_ch, 1, act=False, dtype=dtype, device=device)
            if cin != out_ch else None
        )

    def forward(self, x, train: bool = False):
        y = self.conv3(self.conv2(self.conv1(x, train=train), train=train), train=train)
        if self.downsample is not None:
            x = self.downsample(x, train=train)
        return F.relu(x + y)


class BasicBlock(nn.Module):
    def __init__(self, planes: int, dtype, device):
        super().__init__()
        self.conv1 = ConvBN(planes, planes, 3, dtype=dtype, device=device)
        self.conv2 = ConvBN(planes, planes, 3, act=False, dtype=dtype, device=device)

    def forward(self, x, folded: bool = False, train: bool = False):
        return F.relu(x + self.conv2(self.conv1(x, folded, train), folded, train))


def _nearest_up(x, factor: int):
    """Whole-factor nearest upsampling of [B, H, W, C]: pixel i reads i // factor."""
    if factor == 1:
        return x
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c).reshape(
        b, h * factor, w * factor, c)


class HRModule(nn.Module):
    """Parallel branches of basic blocks + full cross-resolution fusion."""

    def __init__(self, channels: Tuple[int, ...], num_blocks: int, dtype, device,
                 s2d_branch0: bool = False):
        super().__init__()
        self.s2d_branch0 = s2d_branch0
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.ModuleList(BasicBlock(c, dtype, device) for _ in range(num_blocks))
            for c in channels
        )
        fuse = {}
        for i in range(n):
            for j in range(n):
                if j > i:  # lower resolution -> 1x1 conv to C_i, then upsample
                    fuse[f"{i}_{j}"] = ConvBN(channels[j], channels[i], 1, act=False,
                                              dtype=dtype, device=device)
                elif j < i:  # higher resolution -> chain of stride-2 3x3 convs
                    steps = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        steps.append(ConvBN(channels[j], channels[i] if last else channels[j], 3,
                                            2, act=not last, dtype=dtype, device=device))
                    fuse[f"{i}_{j}"] = nn.ModuleList(steps)
        self.fuse = nn.ModuleDict(fuse)

    def forward(self, xs: List[torch.Tensor], train: bool = False) -> List[torch.Tensor]:
        ys = []
        for i, (x, blocks) in enumerate(zip(xs, self.branches)):
            folded = self.s2d_branch0 and i == 0 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
            for block in blocks:
                x = block(x, folded, train)
            ys.append(x)
        fused = []
        for i in range(len(ys)):
            acc = ys[i]
            for j in range(len(ys)):
                if j == i:
                    continue
                f = self.fuse[f"{i}_{j}"]
                if j > i:
                    t = _nearest_up(f(ys[j], train=train), 2 ** (j - i))
                else:
                    t = ys[j]
                    for step in f:
                        t = step(t, train=train)
                acc = acc + t
            fused.append(F.relu(acc))
        return fused


class HRNetFeatures(nn.Module):
    """[stem (64 ch), branch 0 (w), 1 (2w), 2 (4w), 3 (8w)] at resolutions
    [1, 1, 1/2, 1/4, 1/8] x the input's."""

    def __init__(self, cfg: HRNetConfig, dtype, device, s2d_branch0: bool = False):
        super().__init__()
        s, sc, ch = cfg.stem_stride, cfg.stem_channels, cfg.branch_channels
        mk = dict(dtype=dtype, device=device)
        self.stem1 = ConvBN(3, sc, 3, s, **mk)
        self.stem2 = ConvBN(sc, sc, 3, s, **mk)
        self.layer1 = nn.ModuleList(
            Bottleneck(sc if b == 0 else 4 * sc, sc, dtype, device)
            for b in range(cfg.layer1_blocks)
        )
        self.trans1 = nn.ModuleList([ConvBN(4 * sc, ch[0], 3, **mk),
                                     ConvBN(4 * sc, ch[1], 3, 2, **mk)])
        self.stage2 = nn.ModuleList(
            HRModule(ch[:2], cfg.blocks_per_branch, dtype, device, s2d_branch0)
            for _ in range(cfg.stage_modules[0]))
        self.trans2 = ConvBN(ch[1], ch[2], 3, 2, **mk)
        self.stage3 = nn.ModuleList(
            HRModule(ch[:3], cfg.blocks_per_branch, dtype, device, s2d_branch0)
            for _ in range(cfg.stage_modules[1]))
        self.trans3 = ConvBN(ch[2], ch[3], 3, 2, **mk)
        self.stage4 = nn.ModuleList(
            HRModule(ch, cfg.blocks_per_branch, dtype, device, s2d_branch0)
            for _ in range(cfg.stage_modules[2]))

    def forward(self, x, train: bool = False) -> List[torch.Tensor]:
        stem_out = x = self.stem1(x, train=train)  # timm taps feature 0 before conv2
        x = self.stem2(x, train=train)
        for block in self.layer1:
            x = block(x, train)
        xs = [t(x, train=train) for t in self.trans1]
        for m in self.stage2:
            xs = m(xs, train)
        xs.append(self.trans2(xs[-1], train=train))
        for m in self.stage3:
            xs = m(xs, train)
        xs.append(self.trans3(xs[-1], train=train))
        for m in self.stage4:
            xs = m(xs, train)
        return [stem_out] + xs


class SAMHRNet(nn.Module):
    """[B, H, W, 3] -> [B, H, W, 2] per-pixel match logits (float32).

    fuse1 (kernel [334, 64] and bias, float32) runs per scale in the split
    form; relu; fuse2 a float32 1x1 conv (kernel [2, 64] and bias)."""

    ups = (1, 1, 2, 4, 8)

    def __init__(self, cfg: HRNetConfig = HRNET_W18_SAM, fuse_channels: int = 64,
                 dtype=torch.float32, device=None, s2d_branch0: bool = False):
        super().__init__()
        self.dtype = dtype
        self.s2d_branch0 = s2d_branch0
        self.backbone = HRNetFeatures(cfg, dtype, device, s2d_branch0)
        self.in_channels = (cfg.stem_channels, *cfg.branch_channels)
        total = sum(self.in_channels)
        f32 = dict(dtype=torch.float32, device=device)
        self.fuse1_weight = nn.Parameter(torch.empty(total, fuse_channels, **f32))
        self.fuse1_bias = nn.Parameter(torch.zeros(fuse_channels, **f32))
        self.fuse2_weight = nn.Parameter(torch.empty(2, fuse_channels, **f32))
        self.fuse2_bias = nn.Parameter(torch.zeros(2, **f32))

    def reset(self, generator: torch.Generator) -> None:
        _normal_(self.fuse1_weight, self.fuse1_weight.shape[0] ** -0.5, generator)
        _normal_(self.fuse2_weight, self.fuse2_weight.shape[1] ** -0.5, generator)
        nn.init.zeros_(self.fuse1_bias)
        nn.init.zeros_(self.fuse2_bias)

    def forward(self, images, train: bool = False):
        if train and self.s2d_branch0:
            raise ValueError("SAMHRNet: the packed branch 0 (s2d_branch0) is inference only")
        dt = self.dtype
        feats = self.backbone(images.to(dt), train)
        acc, start = None, 0
        for f, c, u in zip(feats, self.in_channels, self.ups):
            y = _nearest_up(matmul_f32(f, self.fuse1_weight[start : start + c].to(dt)), u)
            acc = y if acc is None else acc + y
            start += c
        y = F.relu((acc + self.fuse1_bias).to(dt))
        return F.linear(y.float(), self.fuse2_weight, self.fuse2_bias)


def sam_hrnet_w18(dtype=torch.float32, s2d: bool = False, device="cuda") -> SAMHRNet:
    """SAM over HRNet-W18; `s2d` the JAX packed-branch-0 numerics. On the
    card unless `device` says otherwise."""
    return SAMHRNet(HRNET_W18_SAM, dtype=dtype, device=resolve(device), s2d_branch0=s2d)


def sam_hrnet_tiny_test(dtype=torch.float32, s2d: bool = False, device=None) -> SAMHRNet:
    """Small config for unit tests and CPU runs (on the CPU by default)."""
    return SAMHRNet(HRNET_TINY_TEST, fuse_channels=8, dtype=dtype, device=device,
                    s2d_branch0=s2d)
