"""The one generator of every traffic mix: a mix is a JSON file of
parameters beside this module, read by `load`, and drawn from the run's
seed on the device in a few large calls.

kind "videos" (query traffic): `videos` uint8 videos of `frames` frames of
`height` x `width`, each made of `scenes` static scenes of equal length (a
scene's frames are identical, so near-duplicate removal keeps one frame
of each; scenes differ in content). A scene is a diagonal gradient, a
low-frequency colour field and per-pixel noise. The FSD mix repeats over
each `len(mix)` videos: "plain" frames, "letterbox" (static black bars of
height // 6 at the top and the bottom) and "stack" (two independent
half-height videos with a static 24-pixel black gap). Every seed draws
the same shapes and kinds in the same places; only the content changes.

kind "image_pairs" (training traffic): a pool of `pool` batches of
`pairs` image pairs [pairs, size, size, 3] float32 (a normal image and a
second view of it with added noise), cycled by the trainer.

Every mix may set `trace_units`, the units of work (passes, steps) that a
traced run records.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str, path: str = None) -> dict:
    with open(path or os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws of a run."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2 ** 63)


def _scenes(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    """[n, h, w, 3] uint8 scene images."""
    yy = torch.linspace(0, 255, h, device=device)[:, None, None]
    xx = torch.linspace(0, 255, w, device=device)[None, :, None]
    low = torch.randn((n, 3, 4, 6), generator=gen, device=device) * 40.0
    field = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    noise = torch.randn((n, h, w, 3), generator=gen, device=device) * 18.0
    img = 0.5 * yy + 0.5 * xx + field.permute(0, 2, 3, 1) + noise
    return img.clamp(0, 255).to(torch.uint8)


def _content(gen, p: dict, h: int, w: int, device) -> torch.Tensor:
    per = p["frames"] // p["scenes"]
    return _scenes(gen, p["scenes"], h, w, device).repeat_interleave(per, dim=0)


def video_kinds(p: dict) -> List[str]:
    cycle = [kind for kind, count in p["mix"].items() for _ in range(count)]
    return [cycle[i % len(cycle)] for i in range(p["videos"])]


def videos(p: dict, seed: int, device) -> List[np.ndarray]:
    """The mix's videos, drawn on `device`, as host uint8 [N, H, W, 3]
    arrays in page-locked memory (where a decoder would leave them; the
    pipeline's input is frames in host memory)."""
    if p["frames"] % p["scenes"]:
        raise ValueError("frames must be a whole number of scenes")
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 1))
    n, h, w = p["frames"], p["height"], p["width"]
    out = []
    for kind in video_kinds(p):
        vid = torch.zeros((n, h, w, 3), dtype=torch.uint8, device=device)
        if kind == "plain":
            vid = _content(gen, p, h, w, device)
        elif kind == "letterbox":
            bar = h // 6
            vid[:, bar:h - bar] = _content(gen, p, h - 2 * bar, w, device)
        elif kind == "stack":
            half = (h - 24) // 2
            vid[:, :half] = _content(gen, p, half, w, device)
            vid[:, half + 24:2 * half + 24] = _content(gen, p, half, w, device)
        else:
            raise ValueError(f"unknown video kind {kind!r}")
        out.append(vid)
    stacked = torch.stack(out)
    host = torch.empty(stacked.shape, dtype=torch.uint8, pin_memory=stacked.is_cuda)
    host.copy_(stacked)
    host = host.numpy()
    return [host[i] for i in range(len(out))]


def image_pairs(p: dict, seed: int, device) -> List[dict]:
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 2))
    shape = (p["pairs"], p["size"], p["size"], 3)
    pool = []
    for _ in range(p["pool"]):
        a = torch.randn(shape, generator=gen, device=device)
        b = a + 0.25 * torch.randn(shape, generator=gen, device=device)
        pool.append({"img_a": a, "img_b": b})
    return pool
