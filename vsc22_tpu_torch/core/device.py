"""Where the port's entry points run.

The entry points a user calls (the Base model constructors, the batched
pipeline, the PCA fit and score-norm) run on the card unless the caller
names another device. Without a card they raise; they never fall back to
the CPU quietly. Tests and CPU runs pass `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """`device` as a torch.device; raise if it is a CUDA device and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the GPU unless told "
            "otherwise; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
