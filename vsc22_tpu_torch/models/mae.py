"""MAE-pretrained ViT backbone as a descriptor model.

Counterpart of `vsc22_tpu/models/mae.py` (MAE ViT-B/16 at 224, bf16; part
of the legacy zoo): the port's `vit.VisionTransformer` (K1 and K2 in every
block on the card), then the head output_proj(GeM_p(fc(patch tokens))):
`fc` (Linear embed -> embed, a flax Dense in the model dtype) on the patch
tokens with the CLS token dropped, a GeM mean over the tokens in float32,
and a float32 Linear to `output_dim`.

`random_masking` is split in two: `masking_noise` draws the per-sample
uniform noise from a `torch.Generator`, and `random_masking` is a function
of that noise (the MAE recipe: argsort the noise, keep the first L_keep).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import Linear, gem_pool
from vsc22_tpu_torch.models.vit import ViTConfig, VisionTransformer

MAE_BASE_PATCH16_224 = ViTConfig(img_size=224, patch_size=16)
MAE_TINY_TEST = ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2)


class MaeDescriptor(nn.Module):
    """ViT encoder + (fc -> token GeM -> output_proj) head; [B, output_dim]
    un-normalized f32 descriptors."""

    def __init__(self, cfg: ViTConfig = MAE_BASE_PATCH16_224, output_dim: int = 512,
                 pool_param: float = 3.0, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.pool_param = pool_param
        self.out_dim = output_dim
        self.backbone = VisionTransformer(cfg, dtype, device)
        self.fc = Linear(cfg.embed_dim, cfg.embed_dim, dtype, device)
        self.output_proj = Linear(cfg.embed_dim, output_dim, torch.float32, device)

    def forward(self, images, train: bool = False, rng=None):
        """`rng` (a `layers.DropRng`) draws the ViT's dropout and DropPath
        masks when `train`; training with a rate above 0 needs one."""
        cfg = self.backbone.cfg
        if train and rng is None and (cfg.dropout > 0.0 or cfg.drop_path > 0.0):
            raise ValueError("training with dropout or drop-path needs a DropRng")
        tokens = self.backbone(images, rng if train else None)
        y = self.fc(tokens[:, 1:])  # CLS excluded
        return self.output_proj(gem_pool(y, self.pool_param, axis=1))


def masking_noise(generator: torch.Generator, b: int, l: int, device=None) -> torch.Tensor:
    """[B, L] uniform [0, 1) noise for `random_masking`, drawn from
    `generator` (on its device) and moved to `device`."""
    return torch.rand((b, l), generator=generator, device=generator.device).to(device)


def random_masking(tokens: torch.Tensor, mask_ratio: float,
                   noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample random token masking for MAE pretraining, given the
    per-sample noise [B, L] (`masking_noise`, or any other draw): (kept
    tokens [B, L_keep, C], binary mask [B, L] in tokens' dtype with 1 =
    removed, restore indices [B, L]), L_keep = int(L * (1 - mask_ratio)).
    The noise's stable argsort is the shuffle, as `jnp.argsort` sorts."""
    b, l, c = tokens.shape
    len_keep = int(l * (1.0 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    kept = torch.gather(tokens, 1, ids_keep[:, :, None].expand(b, len_keep, c))
    mask = torch.ones((b, l), dtype=tokens.dtype, device=tokens.device)
    mask[:, :len_keep] = 0.0
    return kept, torch.gather(mask, 1, ids_restore), ids_restore


def mae_base_patch16_224(dtype=torch.bfloat16, device="cuda") -> MaeDescriptor:
    """MAE ViT-B/16 @ 224, 512-d out; on the card unless `device` says otherwise."""
    return MaeDescriptor(MAE_BASE_PATCH16_224, dtype=dtype, device=resolve(device))


def mae_tiny_test(dtype=torch.float32, device=None) -> MaeDescriptor:
    """Small config for tests (on the CPU by default: it exists for tests)."""
    return MaeDescriptor(MAE_TINY_TEST, output_dim=16, dtype=dtype, device=device)
