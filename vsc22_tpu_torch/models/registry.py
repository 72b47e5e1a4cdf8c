"""Config-driven model registry.

Counterpart of `vsc22_tpu/models/registry.py`: configs are plain dicts with
a ``type`` key naming a registered constructor; the other keys (and any
keyword given to `build`, such as ``device``) are passed to it. The
backbones registry holds the models the port has, under the JAX names;
each constructor takes ``device`` (the Base models default to the card, the
``*_tiny_test`` ones to the CPU). A JAX name of a model the port does not
have raises `KeyError` saying so.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

# Registered in the JAX package and not ported: the video-score embedding
# variant and the legacy zoo.
NOT_PORTED = frozenset({
    "video_score_md", "efficientnet_v2_s", "efficientnet_tiny_test", "swin_v1_tiny_224",
    "swin_v1_tiny_test", "mae_base_patch16_224", "mae_tiny_test", "roberta_base",
    "roberta_tiny_test", "deconv_model",
})


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, fn: Callable = None, *, name: str = None):
        def wrap(f):
            key = name or f.__name__
            if key in self._entries:
                raise KeyError(f"{key} already registered in {self.name}")
            self._entries[key] = f
            return f

        return wrap(fn) if fn is not None else wrap

    def get(self, key: str) -> Callable:
        if key not in self._entries:
            if key in NOT_PORTED:
                raise KeyError(f"{key!r} is a JAX-package model that the PyTorch port "
                               f"does not have; {self.name} here: {sorted(self._entries)}")
            raise KeyError(
                f"{key!r} not in registry {self.name}; known: {sorted(self._entries)}"
            )
        return self._entries[key]

    def build(self, cfg: Dict[str, Any], **extra):
        cfg = dict(cfg)
        kind = cfg.pop("type")
        return self.get(kind)(**cfg, **extra)

    def __contains__(self, key: str) -> bool:
        return key in self._entries


BACKBONES = Registry("backbones")


def build_backbone(cfg: Dict[str, Any], **extra):
    return BACKBONES.build(cfg, **extra)


def _register_builtins():
    from vsc22_tpu_torch.models import clip, hrnet, mobilenetv3, swinv2, vit, vsm

    BACKBONES.register(vit.vit_base_patch32_384_descriptor, name="vit_base_patch32_384")
    BACKBONES.register(vit.vit_tiny_test_descriptor, name="vit_tiny_test")
    BACKBONES.register(swinv2.swinv2_base_256_descriptor, name="swinv2_base_256")
    BACKBONES.register(swinv2.swinv2_tiny_test_descriptor, name="swinv2_tiny_test")
    BACKBONES.register(clip.clip_vit_l14, name="clip_vit_l14")
    BACKBONES.register(clip.clip_tiny_test, name="clip_tiny_test")
    BACKBONES.register(vsm.vsm_base, name="video_score_ms")
    BACKBONES.register(mobilenetv3.mobilenetv3_small, name="mobilenetv3_small")
    BACKBONES.register(hrnet.sam_hrnet_w18, name="sam_hrnet_w18")


_register_builtins()
