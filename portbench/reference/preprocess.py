"""Frame preprocessing of the reference: crop, cubic resize, normalise.

A crop + resize is linear: a pair of weight matrices over the original
frame axes (zero outside the crop box), with `jax.image.resize` "cubic"
semantics (Keys a = -0.5, the kernel stretched on a downscale, each output
renormalised), as the submission's JAX port resizes. The CLIP gate's frames
are resized on their shortest side to the tower's size and centre-cropped.
Computed in float32 here; the program computes it in its model's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

PRESETS = {
    "clip": ((0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)),
    "vit": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "efficientnet": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}


def _keys(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x <= 1.0, 1.5 * x ** 3 - 2.5 * x ** 2 + 1.0,
                    np.where(x < 2.0, -0.5 * x ** 3 + 2.5 * x ** 2 - 4.0 * x + 2.0, 0.0))


def resize_weights(in_size: int, out_size: int, start: int = 0, stop=None) -> np.ndarray:
    """[in_size, out_size]: the slice [start, stop) resized to out_size."""
    stop = in_size if stop is None else stop
    length = stop - start
    scale = out_size / length
    stretch = max(1.0 / scale, 1.0)
    sample = (np.arange(out_size) + 0.5) / scale - 0.5
    w = _keys(np.abs(sample[None, :] - np.arange(length)[:, None]) / stretch) / stretch
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1e-6, w / total, 0.0)
    full = np.zeros((in_size, out_size), np.float64)
    full[start:stop] = w
    return full


def crop_resize(frames_u8: torch.Tensor, box, size: int, preset: str) -> torch.Tensor:
    """[N, H, W, 3] uint8 on the device -> [N, size, size, 3] float32: the
    box (top, bottom, left, right) resized to size x size, normalised."""
    _, h, w, _ = frames_u8.shape
    dev = frames_u8.device
    rw = torch.from_numpy(resize_weights(h, size, box[0], box[1])).float().to(dev)
    cw = torch.from_numpy(resize_weights(w, size, box[2], box[3])).float().to(dev)
    return _normalise(frames_u8, rw, cw, preset)


def clip_resize(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """Shortest-side resize to `size`, centre crop, CLIP normalisation."""
    _, h, w, _ = frames_u8.shape
    if h <= w:
        nh, nw = size, max(int(round(w * size / h)), size)
    else:
        nh, nw = max(int(round(h * size / w)), size), size
    top, left = (nh - size) // 2, (nw - size) // 2
    dev = frames_u8.device
    rw = torch.from_numpy(resize_weights(h, nh)[:, top:top + size]).float().to(dev)
    cw = torch.from_numpy(resize_weights(w, nw)[:, left:left + size]).float().to(dev)
    return _normalise(frames_u8, rw, cw, "clip")


def _normalise(frames_u8, rw, cw, preset: str):
    mean, std = (torch.tensor(v, dtype=torch.float32, device=frames_u8.device)
                 for v in PRESETS[preset])
    x = frames_u8.float() / 255.0
    y = torch.einsum("nhwc,hs->nswc", x, rw)
    y = torch.einsum("nswc,wt->nstc", y, cw)
    return (y - mean) / std
