"""RoBERTa/BERT-style text encoder.

Counterpart of `vsc22_tpu/models/text_encoder.py` (RoBERTa-base: a
21,128-word vocabulary, hidden 768, 12 layers, 12 heads, 512 positions,
bf16; part of the legacy zoo): token ids (a float32 `Embed` lookup) or
precomputed embeddings [B, L, H], + learned positions (+ token-type
embeddings where ids are given), a flax-default LayerNorm (eps 1e-6),
dropout, then `vsm.PostLNBlock`s (LN eps 1e-12) under an additive mask
bias of -1e9 on masked keys (the VSM uses -1e4), and optionally the tanh
pooler on the first token. With a mask the attention takes the einsum
path of `layers.MultiHeadAttention`, as in JAX; without one, B8 on the
card.

The JAX model declares `word_embeddings` only when it is given ids and
`token_type_embeddings` only when it is given token types; the port always
has both, and `utils/jax_params.text_encoder_entries` leaves out those a
JAX tree lacks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.models.layers import Embed, LayerNorm, Linear, dropout, layer_norm
from vsc22_tpu_torch.models.vsm import PostLNBlock


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int = 21128  # chinese-roberta-wwm-ext vocabulary
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    max_positions: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1


TEXT_BASE = TextEncoderConfig()
TEXT_TINY_TEST = TextEncoderConfig(
    vocab_size=64, hidden=32, layers=2, heads=2, max_positions=16
)


class TextEncoder(nn.Module):
    """BERT-style encoder over token ids or embeddings: the last hidden
    state [B, L, H] in the model dtype, or with `output_pool` the tanh
    pooler output [B, H] in float32."""

    def __init__(self, cfg: TextEncoderConfig = TEXT_BASE, output_pool: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden, device)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, cfg.max_positions, cfg.hidden, device=device))
        self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden, device)
        self.embeddings_norm = LayerNorm(cfg.hidden, device)
        self.layers = nn.ModuleList(
            PostLNBlock(cfg.hidden, cfg.heads, dtype, device, cfg.dropout)
            for _ in range(cfg.layers)
        )
        self.pooler = Linear(cfg.hidden, cfg.hidden, torch.float32, device) if output_pool \
            else None

    def forward(self, inputs, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None, train: bool = False, rng=None):
        """inputs: [B, L] int ids or [B, L, H] embeddings; attention_mask
        [B, L], 1 = attend. `rng` (a `layers.DropRng`) draws the dropout
        masks when `train`."""
        cfg = self.cfg
        if train and cfg.dropout > 0.0 and rng is None:
            raise ValueError("training with dropout needs a DropRng")
        rng = rng if train else None
        if inputs.ndim == 2:
            x = self.word_embeddings(inputs)
        elif inputs.shape[-1] == cfg.hidden:
            x = inputs
        else:
            raise ValueError(
                f"inputs_embeds last dim {inputs.shape[-1]} != hidden {cfg.hidden}")
        b, l = x.shape[:2]
        if l > cfg.max_positions:
            raise ValueError(f"sequence {l} > max_positions {cfg.max_positions}")
        x = x + self.position_embeddings[:, :l].to(x.dtype)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        x = layer_norm(x, self.embeddings_norm, 1e-6, self.dtype)
        x = dropout(x, cfg.dropout, rng, (self, "emb"))
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()
        for layer in self.layers:
            x = layer(x, bias, rng)
        if self.pooler is not None:
            return torch.tanh(self.pooler(x[:, 0].float()))
        return x


def roberta_base(dtype=torch.bfloat16, output_pool: bool = False,
                 device="cuda") -> TextEncoder:
    """RoBERTa-base (chinese-roberta-wwm-ext widths); on the card unless
    `device` says otherwise."""
    return TextEncoder(TEXT_BASE, output_pool, dtype, resolve(device))


def text_tiny_test(dtype=torch.float32, output_pool: bool = False,
                   device=None) -> TextEncoder:
    """Small config for tests (on the CPU by default: it exists for tests)."""
    return TextEncoder(TEXT_TINY_TEST, output_pool, dtype, device)
