"""Deconvolutional decoder head.

Counterpart of `vsc22_tpu/models/deconv.py` (dim 2048, f32; part of the
legacy zoo): residual conv blocks (ReLU, 3x3 conv, BN, ReLU, 1x1 conv, BN,
+ the input) interleaved with nearest 2x upsampling and stride-2
transposed convs (`layers.ConvTranspose`, flax's unflipped kernel, SAME),
mapping a [B, h, w, dim] feature map to [B, 32h, 32w, output_dim]. The
convs carry biases and pad as flax `SAME`; all run in cuDNN.

`train=True` is flax's `train`: every BatchNorm normalises with the batch's
statistics and updates its running ones (`layers.BatchNorm`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import BatchNorm, Conv, ConvTranspose, upsample_nearest_2x


class ResBlock(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, 1, "same", dtype=dtype, device=device,
                          bias=True)
        self.bn1 = BatchNorm(channels, device)
        self.conv2 = Conv(channels, channels, 1, dtype=dtype, device=device, bias=True)
        self.bn2 = BatchNorm(channels, device)

    def forward(self, x, train: bool = False):
        y = self.bn1(self.conv1(F.relu(x)), train)
        y = self.bn2(self.conv2(F.relu(y)), train)
        return x + y


class DeConvModel(nn.Module):
    """[B, h, w, dim] -> [B, 32h, 32w, output_dim] decoder."""

    def __init__(self, dim: int = 2048, output_dim: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.res0 = ResBlock(dim, dtype, device)
        self.up0 = ConvTranspose(dim, dim // 2, 4, 2, dtype, device)
        self.res1 = ResBlock(dim // 2, dtype, device)
        self.up1 = ConvTranspose(dim // 2, dim // 4, 4, 2, dtype, device)
        self.res2 = ResBlock(dim // 4, dtype, device)
        self.out = ConvTranspose(dim // 4, output_dim, 4, 2, dtype, device)

    def forward(self, x, train: bool = False):
        x = self.up0(upsample_nearest_2x(F.relu(self.res0(x, train))))
        x = self.up1(upsample_nearest_2x(F.relu(self.res1(x, train))))
        return self.out(F.relu(self.res2(x, train)))


def deconv_model(dim: int = 2048, output_dim: int = 3, dtype=torch.float32,
                 device="cuda") -> DeConvModel:
    """The registry's `deconv_model` (dim 2048 unless given); on the card
    unless `device` says otherwise."""
    return DeConvModel(dim, output_dim, dtype, resolve(device))
