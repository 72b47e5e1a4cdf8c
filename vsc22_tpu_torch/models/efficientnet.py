"""EfficientNetV2-style backbone + GeM + Linear/BN descriptor head.

Counterpart of `vsc22_tpu/models/efficientnet.py` (EfficientNetV2-S,
bf16; part of the legacy zoo): a stem conv, FusedMBConv stages (a 3x3
expand conv) then MBConv stages (1x1 expand, depthwise 3x3 with
`groups=mid`, squeeze-excite), SiLU, BatchNorm after every conv; then a
spatial GeM at p = 1 (clamped at 1e-6), `fc` (no bias, f32) and a 1-D
BatchNorm over [B, fc_dim]. Convolutions pad as flax `SAME` (`layers.Conv`
with pad "same": (0, 1) at stride 2 on an even input) and run in cuDNN;
the SE convs carry biases. Rounding follows flax: BN once after its f32
arithmetic, the SE mean a float32 sum rounded once (`layers.spatial_mean`),
SiLU as x * sigmoid(x), each op in the compute dtype.

`train=True` is flax's `train`: every BatchNorm normalises with the batch's
statistics and updates its running ones (`layers.BatchNorm`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import BatchNorm, Conv, Linear, spatial_mean


@dataclasses.dataclass(frozen=True)
class MBStage:
    fused: bool  # FusedMBConv (3x3 expand conv) vs MBConv (1x1 + depthwise)
    expand: int
    channels: int
    layers: int
    stride: int
    se_ratio: float = 0.0


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    stem_channels: int = 24
    stages: Tuple[MBStage, ...] = (
        MBStage(True, 1, 24, 2, 1),
        MBStage(True, 4, 48, 4, 2),
        MBStage(True, 4, 64, 4, 2),
        MBStage(False, 4, 128, 6, 2, 0.25),
        MBStage(False, 6, 160, 9, 1, 0.25),
        MBStage(False, 6, 256, 15, 2, 0.25),
    )
    fc_dim: int = 256
    pool_param: float = 1.0  # reference default p = 1.0 (plain average)


EFFNET_V2_S = EfficientNetConfig()
EFFNET_TINY_TEST = EfficientNetConfig(
    stem_channels=8,
    stages=(
        MBStage(True, 2, 8, 1, 2),
        MBStage(False, 2, 16, 1, 2, 0.25),
    ),
    fc_dim=16,
)


def silu(x):
    """`nn.silu` as x * sigmoid(x), each op rounded to x's dtype."""
    return x * torch.sigmoid(x)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int, dtype, device):
        super().__init__()
        self.reduce = Conv(channels, reduced, 1, dtype=dtype, device=device, bias=True)
        self.expand = Conv(reduced, channels, 1, dtype=dtype, device=device, bias=True)

    def forward(self, x):  # [B, H, W, C]
        s = spatial_mean(x)[:, None, None, :]
        return x * torch.sigmoid(self.expand(silu(self.reduce(s))))


class MBConvBlock(nn.Module):
    def __init__(self, stage: MBStage, cin: int, stride: int, dtype, device):
        super().__init__()
        mid = cin * stage.expand
        self.residual = stride == 1 and cin == stage.channels
        if stage.fused:
            self.expand_conv = Conv(cin, mid, 3, stride, "same", dtype=dtype, device=device)
            self.dw_conv = self.bn1 = None
        else:
            self.expand_conv = Conv(cin, mid, 1, dtype=dtype, device=device)
            self.dw_conv = Conv(mid, mid, 3, stride, "same", groups=mid, dtype=dtype,
                                device=device)
            self.bn1 = BatchNorm(mid, device)
        self.bn0 = BatchNorm(mid, device)
        self.se = (
            SqueezeExcite(mid, max(1, int(cin * stage.se_ratio)), dtype, device)
            if stage.se_ratio > 0 else None
        )
        self.project_conv = Conv(mid, stage.channels, 1, dtype=dtype, device=device)
        self.bn2 = BatchNorm(stage.channels, device)

    def forward(self, x, train: bool = False):
        y = silu(self.bn0(self.expand_conv(x), train))
        if self.dw_conv is not None:
            y = silu(self.bn1(self.dw_conv(y), train))
        if self.se is not None:
            y = self.se(y)
        y = self.bn2(self.project_conv(y), train)
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """V2 trunk -> spatial GeM(p) -> Linear(fc_dim, no bias, f32) ->
    BatchNorm; [B, fc_dim] f32 descriptors."""

    def __init__(self, cfg: EfficientNetConfig = EFFNET_V2_S, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.out_dim = cfg.fc_dim
        self.stem = Conv(3, cfg.stem_channels, 3, 2, "same", dtype=dtype, device=device)
        self.stem_bn = BatchNorm(cfg.stem_channels, device)
        blocks, ch = [], cfg.stem_channels
        for stage in cfg.stages:
            for li in range(stage.layers):
                blocks.append(MBConvBlock(stage, ch, stage.stride if li == 0 else 1, dtype,
                                          device))
                ch = stage.channels
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(ch, cfg.fc_dim, torch.float32, device, bias=False)
        self.bn = BatchNorm(cfg.fc_dim, device)

    def forward(self, images, train: bool = False, rng=None):  # [B, H, W, 3]
        """`rng` is taken for the trainers' call and unused: no dropout."""
        x = silu(self.stem_bn(self.stem(images.to(self.dtype)), train))
        for block in self.blocks:
            x = block(x, train)
        p = self.cfg.pool_param
        pooled = (x.float().clamp(min=1e-6) ** p).mean((1, 2)) ** (1.0 / p)
        return self.bn(self.fc(pooled), train)


def efficientnet_v2_s(dtype=torch.bfloat16, device="cuda") -> EfficientNet:
    """EfficientNetV2-S, 256-d out; on the card unless `device` says otherwise."""
    return EfficientNet(EFFNET_V2_S, dtype, resolve(device))


def efficientnet_tiny_test(dtype=torch.float32, device=None) -> EfficientNet:
    """Small config for tests (on the CPU by default: it exists for tests)."""
    return EfficientNet(EFFNET_TINY_TEST, dtype, device)
