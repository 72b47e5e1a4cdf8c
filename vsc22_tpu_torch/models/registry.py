"""Config-driven model registry.

Counterpart of `vsc22_tpu/models/registry.py`: configs are plain dicts with
a ``type`` key naming a registered constructor; the other keys (and any
keyword given to `build`, such as ``device``) are passed to it. The
backbones registry holds the models under the JAX names;
each constructor takes ``device`` (the Base models default to the card, the
``*_tiny_test`` ones to the CPU). Every name of the JAX registry is here,
the legacy zoo included.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


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
DATASETS = Registry("datasets")


def build_backbone(cfg: Dict[str, Any], **extra):
    return BACKBONES.build(cfg, **extra)


def _register_builtins():
    from vsc22_tpu_torch.models import (
        clip,
        deconv,
        efficientnet,
        hrnet,
        mae,
        mobilenetv3,
        swin_v1,
        swinv2,
        text_encoder,
        vit,
        vsm,
    )

    BACKBONES.register(vit.vit_base_patch32_384_descriptor, name="vit_base_patch32_384")
    BACKBONES.register(vit.vit_tiny_test_descriptor, name="vit_tiny_test")
    BACKBONES.register(swinv2.swinv2_base_256_descriptor, name="swinv2_base_256")
    BACKBONES.register(swinv2.swinv2_tiny_test_descriptor, name="swinv2_tiny_test")
    BACKBONES.register(clip.clip_vit_l14, name="clip_vit_l14")
    BACKBONES.register(clip.clip_tiny_test, name="clip_tiny_test")
    BACKBONES.register(vsm.vsm_base, name="video_score_ms")
    BACKBONES.register(vsm.vsm_embed, name="video_score_md")
    BACKBONES.register(mobilenetv3.mobilenetv3_small, name="mobilenetv3_small")
    BACKBONES.register(hrnet.sam_hrnet_w18, name="sam_hrnet_w18")
    # The legacy zoo (`vsc22_tpu/models/registry.py:80-92`).
    BACKBONES.register(efficientnet.efficientnet_v2_s, name="efficientnet_v2_s")
    BACKBONES.register(efficientnet.efficientnet_tiny_test, name="efficientnet_tiny_test")
    BACKBONES.register(swin_v1.swin_v1_tiny_224, name="swin_v1_tiny_224")
    BACKBONES.register(swin_v1.swin_v1_tiny_test, name="swin_v1_tiny_test")
    BACKBONES.register(mae.mae_base_patch16_224, name="mae_base_patch16_224")
    BACKBONES.register(mae.mae_tiny_test, name="mae_tiny_test")
    BACKBONES.register(text_encoder.roberta_base, name="roberta_base")
    BACKBONES.register(text_encoder.text_tiny_test, name="roberta_tiny_test")
    BACKBONES.register(deconv.deconv_model, name="deconv_model")


_register_builtins()
