"""What the tasks share: configurations, the program's models built from a
configuration's sizes, and seeded weights drawn on the device.

Weights are drawn by a rule on each parameter's name and shape, in one
`torch.randn` call per model on the run's device (matmul weights N(0,
1/fan_in), LayerNorm scales 1, biases and embeddings N(0, 0.02^2),
SwinV2's logit scales ln 10), each in the dtype the program holds it in.
The reference redraws them from the same seed; it never reads the
program's parameters.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Tuple

import torch

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

Spec = List[Tuple[str, Tuple[int, ...], torch.dtype]]


def load_config(name: str, path: str = None) -> dict:
    with open(path or os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


def build_model(spec: dict, dtype, device):
    """The program's model for one entry of a configuration's `models`."""
    d = spec["dims"]
    arch = spec["arch"]
    if arch == "vit":
        from vsc22_tpu_torch.models.vit import ViTConfig, VitDescriptor

        cfg = ViTConfig(img_size=d["img_size"], patch_size=d["patch_size"],
                        embed_dim=d["embed_dim"], depth=d["depth"], num_heads=d["num_heads"],
                        mlp_ratio=d["mlp_ratio"])
        return VitDescriptor(cfg, d["pool_param"], d["head_dim"], d["out_dim"], dtype, device)
    if arch == "swinv2":
        from vsc22_tpu_torch.models.swinv2 import SwinTransformerV2, SwinV2Config

        cfg = SwinV2Config(img_size=d["img_size"], patch_size=d["patch_size"],
                           embed_dim=d["embed_dim"], depths=tuple(d["depths"]),
                           num_heads=tuple(d["num_heads"]), window_size=d["window_size"],
                           pretrained_window_sizes=tuple(d["pretrained_window_sizes"]),
                           mlp_ratio=d["mlp_ratio"], output_dim=d["output_dim"],
                           pool_param=d["pool_param"])
        return SwinTransformerV2(cfg, dtype, device)
    if arch == "clip":
        from vsc22_tpu_torch.models.clip import CLIPVisual, CLIPVisualConfig

        cfg = CLIPVisualConfig(img_size=d["img_size"], patch_size=d["patch_size"],
                               width=d["width"], layers=d["layers"], heads=d["heads"])
        return CLIPVisual(cfg, dtype, device)
    if arch == "vsm":
        from vsc22_tpu_torch.models.vsm import VideoScoreModel, VSMConfig

        cfg = VSMConfig(feat_dim=d["feat_dim"], hidden=d["hidden"], layers=d["layers"],
                        heads=d["heads"], max_frames=d["max_frames"])
        return VideoScoreModel(cfg, dtype, device)
    raise ValueError(f"unknown architecture {arch!r}")


def param_spec(module) -> Spec:
    return [(n, tuple(p.shape), p.dtype) for n, p in module.named_parameters()]


def _rule(name: str, shape) -> Tuple[str, float]:
    if name.endswith("logit_scale"):
        return "const", math.log(10.0)
    if len(shape) == 1 and name.endswith(".weight"):
        return "const", 1.0  # a LayerNorm scale
    if len(shape) >= 2 and name.endswith("weight"):
        return "normal", math.prod(shape[1:]) ** -0.5
    return "normal", 0.02  # biases, class tokens, position tables


def draw(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for `spec`, in its dtypes, on `device`."""
    rules = [_rule(n, s) for n, s, _ in spec]
    total = sum(math.prod(s) for (_, s, _), (kind, _) in zip(spec, rules) if kind == "normal")
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, dtype), (kind, v) in zip(spec, rules):
        if kind == "const":
            t = torch.full(shape, v, device=device)
        else:
            n = math.prod(shape)
            t = flat[at:at + n].reshape(shape) * v
            at += n
        out[name] = t.to(dtype)
    return out


@torch.no_grad()
def load(module, params: Dict[str, torch.Tensor]) -> None:
    for name, p in module.named_parameters():
        p.copy_(params[name])


def as_f32(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.float() for n, t in params.items()}
