"""MobileNetV3-Small classifier (the matching track's candidate filter).

Counterpart of `vsc22_tpu/models/mobilenetv3.py`: timm
`mobilenetv3_small_100` widths with a 2-class head over NHWC images (the
similarity matrix broadcast to 3 channels). Convolutions, BN and Dense
layers round where the flax modules round: every op of `hard_sigmoid` in
the compute dtype, BN once after its float32 arithmetic, the SE and
`pre_logits` Dense layers twice (`layers.dense`), the classifier in
float32 over the rounded features.

`train=True` is flax's `train`: every BN normalises with the batch's
statistics and updates its running ones, and the head's dropout (0.2)
acts, its mask drawn from the step's `layers.DropRng`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import BatchNorm, Conv, Linear, dropout, spatial_mean

# (kernel, expansion, out_channels, se_reduce_ch, use_hswish, stride): timm
# `mobilenetv3_small_100`, as `vsc22_tpu/models/mobilenetv3.py:32` lists it.
MNV3_SMALL_SPEC = (
    (3, 16, 16, 8, False, 2),
    (3, 72, 24, 0, False, 2),
    (3, 88, 24, 0, False, 1),
    (5, 96, 40, 24, True, 2),
    (5, 240, 40, 64, True, 1),
    (5, 240, 40, 64, True, 1),
    (5, 120, 48, 32, True, 1),
    (5, 144, 48, 40, True, 1),
    (5, 288, 96, 72, True, 2),
    (5, 576, 96, 144, True, 1),
    (5, 576, 96, 144, True, 1),
)


def hard_sigmoid(x):
    """relu6(x + 3) / 6, each op rounded to x's dtype (`F.hardsigmoid`
    rounds once)."""
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


class ConvBNAct(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
                 act: Optional[str] = "relu", dtype=torch.float32, device=None):
        super().__init__()
        pad = ((stride - 1) + (kernel - 1)) // 2  # timm's static symmetric pad
        self.conv = Conv(cin, cout, kernel, stride, pad, groups, dtype, device)
        self.bn = BatchNorm(cout, device)
        self.act = act

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
        if self.act == "relu":
            return F.relu(x)
        if self.act == "hswish":
            return hard_swish(x)
        return x


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduce_to: int, dtype, device):
        super().__init__()
        self.fc1 = Linear(channels, reduce_to, dtype, device)
        self.fc2 = Linear(reduce_to, channels, dtype, device)

    def forward(self, x):  # [B, H, W, C]
        s = self.fc2(F.relu(self.fc1(spatial_mean(x))))
        return x * hard_sigmoid(s)[:, None, None, :]


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, kernel: int, expansion: int, out_ch: int, se_reduce: int,
                 use_hswish: bool, stride: int, dtype, device):
        super().__init__()
        act = "hswish" if use_hswish else "relu"
        self.residual = stride == 1 and in_ch == out_ch
        self.expand = (
            ConvBNAct(in_ch, expansion, 1, act=act, dtype=dtype, device=device)
            if expansion != in_ch else None
        )
        self.dw = ConvBNAct(expansion, expansion, kernel, stride, groups=expansion, act=act,
                            dtype=dtype, device=device)
        self.se = SqueezeExcite(expansion, se_reduce, dtype, device) if se_reduce else None
        self.project = ConvBNAct(expansion, out_ch, 1, act=None, dtype=dtype, device=device)

    def forward(self, x, train: bool = False):
        y = self.expand(x, train) if self.expand is not None else x
        y = self.dw(y, train)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y, train)
        return x + y if self.residual else y


class MobileNetV3Small(nn.Module):
    """[B, H, W, 3] images -> [B, num_classes] float32 logits."""

    def __init__(self, num_classes: int = 2, dtype=torch.float32, device=None,
                 spec: Sequence = MNV3_SMALL_SPEC, dropout: float = 0.2):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.stem = ConvBNAct(3, 16, 3, 2, act="hswish", dtype=dtype, device=device)
        blocks, ch = [], 16
        for k, exp, out, se, hs, s in spec:
            blocks.append(InvertedResidual(ch, k, exp, out, se, hs, s, dtype, device))
            ch = out
        self.blocks = nn.ModuleList(blocks)
        self.head_conv = ConvBNAct(ch, 576, 1, act="hswish", dtype=dtype, device=device)
        self.pre_logits = Linear(576, 1024, dtype, device)
        self.classifier = Linear(1024, num_classes, torch.float32, device)

    def forward(self, images, train: bool = False, rng=None):
        """`rng` (a `layers.DropRng`) draws the head's dropout mask; train
        mode with a nonzero rate needs one."""
        if train and self.dropout > 0.0 and rng is None:
            raise ValueError("MobileNetV3Small: train mode with dropout needs a DropRng")
        x = self.stem(images.to(self.dtype), train)
        for block in self.blocks:
            x = block(x, train)
        x = spatial_mean(self.head_conv(x, train))
        x = hard_swish(self.pre_logits(x))
        if train:
            x = dropout(x, self.dropout, rng, (self, "head"))
        return self.classifier(x)


def mobilenetv3_small(num_classes: int = 2, dtype=torch.float32, device="cuda",
                      dropout: float = 0.2) -> MobileNetV3Small:
    """On the card unless `device` says otherwise."""
    return MobileNetV3Small(num_classes, dtype, resolve(device), dropout=dropout)
