"""Video-score model (VED): "was this video edited/copied?" classifier.

Counterpart of `vsc22_tpu/models/vsm.py` (`MS` head): CLIP CLS frame
features -> Linear + LN(1e-5) -> [CLS] frames [SEP] + positions ->
LN(1e-12) -> post-LN BERT layers (LN eps 1e-12, erf GELU, additive mask
bias -1e4 on masked keys, `vsm.py:114`) -> concat([CLS] state,
masked-average pool) -> Linear -> 1 logit; with `cfg.output_dim` > 0 the
`MD` head, Linear -> an `output_dim` embedding (`vsm_embed`). Attention is
`layers.MultiHeadAttention` with the mask bias, so it takes the plain
einsum path, as the JAX package's does. In training (`train=True` with a
`layers.DropRng`) dropout at `cfg.dropout` follows the embedding LN, each
attention projection and each fc2, as in JAX (`vsm.py:55,67,111`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import (
    LayerNorm,
    Linear,
    MultiHeadAttention,
    dropout,
    gelu_exact,
    layer_norm,
)


@dataclasses.dataclass(frozen=True)
class VSMConfig:
    feat_dim: int = 1024
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    max_frames: int = 256
    dropout: float = 0.1
    # 0: the `MS` scorer head (1 logit, squeezed); > 0: the `MD` embedding
    # twin, whose output_proj maps the 2 * hidden pooled state to an
    # `output_dim` vector (`vsm.py:43-47, 125-138`).
    output_dim: int = 0


VSM_BASE = VSMConfig()
VSM_TINY_TEST = VSMConfig(feat_dim=16, hidden=32, layers=2, heads=2, max_frames=8)


class PostLNBlock(nn.Module):
    """BERT-style post-LN encoder block."""

    def __init__(self, hidden: int, heads: int, dtype=torch.float32, device=None,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.attn = MultiHeadAttention(hidden, heads, dtype, proj_drop=dropout, device=device)
        self.ln_attn = LayerNorm(hidden, device)
        self.fc1 = Linear(hidden, 4 * hidden, dtype, device)
        self.fc2 = Linear(4 * hidden, hidden, dtype, device)
        self.ln_mlp = LayerNorm(hidden, device)

    def forward(self, x, mask_bias, rng=None):
        dt = self.dtype
        x = layer_norm(x + self.attn(x, mask_bias, rng), self.ln_attn, 1e-12, dt)
        y = dropout(self.fc2(gelu_exact(self.fc1(x))), self.dropout, rng, (self, "fc2"))
        return layer_norm(x + y, self.ln_mlp, 1e-12, dt)


class VideoScoreModel(nn.Module):
    """feats [B, N, feat_dim] -> logits [B] (`MD`: embeddings [B,
    output_dim]). All-zero frame rows are masked out of attention and
    pooling."""

    def __init__(self, cfg: VSMConfig = VSM_BASE, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.frame_proj = Linear(cfg.feat_dim, cfg.hidden, dtype, device)
        self.frame_norm = LayerNorm(cfg.hidden, device)
        self.cls_emb = nn.Parameter(torch.zeros(cfg.hidden, device=device))
        self.sep_emb = nn.Parameter(torch.zeros(cfg.hidden, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_frames + 2, cfg.hidden, device=device))
        self.emb_norm = LayerNorm(cfg.hidden, device)
        self.layers = nn.ModuleList(
            PostLNBlock(cfg.hidden, cfg.heads, dtype, device, cfg.dropout)
            for _ in range(cfg.layers)
        )
        self.output_proj = Linear(2 * cfg.hidden, cfg.output_dim or 1, torch.float32,
                                  device)

    def forward(self, feats, train: bool = False, rng=None):
        """`rng` (a `layers.DropRng`) draws the dropout masks when `train`."""
        cfg = self.cfg
        if train and cfg.dropout > 0.0 and rng is None:
            raise ValueError("training with dropout needs a DropRng")
        rng = rng if train else None
        dt = self.dtype
        b, n, _ = feats.shape
        vision = layer_norm(self.frame_proj(feats), self.frame_norm, 1e-5, dt)
        frame_mask = (feats.abs().sum(dim=2) > 0).float()
        tokens = torch.cat(
            [
                self.cls_emb.to(dt).expand(b, 1, cfg.hidden),
                vision,
                self.sep_emb.to(dt).expand(b, 1, cfg.hidden),
            ],
            dim=1,
        )
        # Reference mask layout [1, 1, frame_mask] (cls and sep always visible).
        mask = torch.cat([torch.ones(b, 2, device=feats.device), frame_mask], dim=1)
        tokens = layer_norm(tokens + self.pos_embed[: n + 2].to(dt), self.emb_norm, 1e-12, dt)
        tokens = dropout(tokens, cfg.dropout, rng, (self, "emb"))
        bias = (1.0 - mask)[:, None, None, :] * -10000.0
        for layer in self.layers:
            tokens = layer(tokens, bias, rng)
        states = tokens.float()
        weights = mask[..., None]
        avg_pool = (states * weights).sum(dim=1) / (weights.sum(dim=1) + 1e-5)
        cat = torch.cat([states[:, 0], avg_pool], dim=1)
        if cfg.output_dim > 0:  # MD: the embedding head
            return self.output_proj(cat)
        return self.output_proj(cat).squeeze(-1)


def vsm_base(dtype=torch.bfloat16, device="cuda") -> VideoScoreModel:
    """The VED gate's video-score model; on the card unless `device` says otherwise."""
    return VideoScoreModel(VSM_BASE, dtype, resolve(device))


def vsm_embed(output_dim: int = 256, dtype=torch.bfloat16, device="cuda") -> VideoScoreModel:
    """The reference's `MD` video-embedding twin: the VSM trunk with an
    `output_dim` head; on the card unless `device` says otherwise."""
    return VideoScoreModel(dataclasses.replace(VSM_BASE, output_dim=output_dim), dtype,
                           resolve(device))


def vsm_tiny_test(dtype=torch.float32, device=None) -> VideoScoreModel:
    """Small config for tests (on the CPU by default: it exists for tests)."""
    return VideoScoreModel(VSM_TINY_TEST, dtype, device)
