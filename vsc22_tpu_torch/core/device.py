"""Where the port's entry points run.

The entry points a user calls (the Base model constructors, the batched
pipeline, the PCA fit and score-norm) run on the card unless the caller
names another device. Without a card they raise; they never fall back to
the CPU quietly. Tests and CPU runs pass `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vsc22_tpu_torch.utils.observability import count


def resolve(device="cuda") -> torch.device:
    """`device` as a torch.device; raise if it is a CUDA device and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the GPU unless told "
            "otherwise; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def upload(array, device: torch.device, keep: Optional[list] = None) -> torch.Tensor:
    """A host array as a tensor on `device` with no host sync: on a card,
    copied from a pinned staging buffer with `non_blocking=True`. `keep`,
    where given, receives that buffer, for a caller that holds it until
    the copy is known to be done (the caching host allocator also holds
    it until then). On the CPU the result shares the array's memory. The
    array's bytes go to the `h2d_bytes` counter (`utils/observability`), on
    either device."""
    array = np.ascontiguousarray(array)
    count("h2d_bytes", array.nbytes)
    host = torch.from_numpy(array)
    if device.type != "cuda":
        return host.to(device)
    host = host.pin_memory()
    if keep is not None:
        keep.append(host)
    return host.to(device, non_blocking=True)
