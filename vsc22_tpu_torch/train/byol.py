"""BYOL self-supervised training recipe.

Counterpart of `vsc22_tpu/train/byol.py` (part of the legacy zoo): an
online network (any registry backbone returning [B, D], then a projector
and a predictor, `ByolMLP`: Dense -> LayerNorm -> ReLU -> Dense, float32),
a target network that is an EMA of the online one, and the symmetric loss
2 - 2 cos(pred(proj_online(view)), sg(proj_target(other view))).

As in the port's contrastive trainer (`train/contrastive.py`), the
networks hold their weights in the compute dtype and `ByolState` keeps
float32 masters of both by parameter name: the optimizer (`AdamW`, optax's
order of operations) updates the online masters, the target masters move
as `optax.incremental_update(online, target, 1 - ema_decay)`, and both are
written back into their networks, each rounded to its parameter's dtype.
The target runs under `torch.no_grad()`. The backbone runs as called
without `train` (JAX's `apply_backbone(params, images)` is `model.apply`),
so a BatchNorm member normalises with its running statistics. Those are
leaves of JAX's online dict (its `batch_stats`), which the JAX step
differentiates and hands to the optimizer and the EMA like any weight: so
here each BatchNorm's running mean and variance are trained tensors of
the step too (`trained_tensors`), after the parameters.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from vsc22_tpu_torch.models.layers import BatchNorm, LayerNorm, Linear, layer_norm
from vsc22_tpu_torch.train.contrastive import AdamState, AdamW


@dataclasses.dataclass(frozen=True)
class ByolConfig:
    projection_size: int = 256
    hidden_size: int = 4096
    ema_decay: float = 0.99
    learning_rate: float = 3e-4


class ByolMLP(nn.Module):
    """Projector/predictor MLP: Dense -> LayerNorm (eps 1e-6) -> ReLU ->
    Dense, float32 (the reference's BatchNorm1d as a batch-size-free LN,
    as in JAX)."""

    def __init__(self, in_dim: int, hidden: int, out: int, device=None):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden, torch.float32, device)
        self.norm = LayerNorm(hidden, device)
        self.fc2 = Linear(hidden, out, torch.float32, device)

    def forward(self, x):
        return self.fc2(torch.relu(layer_norm(self.fc1(x), self.norm, 1e-6, torch.float32)))


class ByolHeads(nn.Module):
    """Projector + predictor over backbone embeddings [B, emb_dim]."""

    def __init__(self, emb_dim: int, cfg: ByolConfig = ByolConfig(), device=None):
        super().__init__()
        self.projector = ByolMLP(emb_dim, cfg.hidden_size, cfg.projection_size, device)
        self.predictor = ByolMLP(cfg.projection_size, cfg.hidden_size, cfg.projection_size,
                                 device)

    def project(self, emb):
        return self.projector(emb.float())

    def predict(self, proj):
        return self.predictor(proj)

    def forward(self, emb):
        return self.predict(self.project(emb))


class ByolNet(nn.Module):
    """A backbone and its heads (JAX's {"backbone": ..., "heads": ...})."""

    def __init__(self, backbone: nn.Module, heads: ByolHeads):
        super().__init__()
        self.backbone = backbone
        self.heads = heads

    def forward(self, images):  # the online prediction
        return self.heads(self.backbone(images))

    def project(self, images):  # the target projection
        return self.heads.project(self.backbone(images))


@dataclasses.dataclass
class ByolState:
    """`step`; float32 masters of the online and target networks by
    parameter name, and the optimizer state over the online ones."""

    step: int
    online: Dict[str, torch.Tensor]
    target: Dict[str, torch.Tensor]
    opt_state: AdamState


def regression_loss(pred, target):
    """2 - 2 cosine, averaged over the batch (`_regression_loss`)."""
    p = pred / torch.linalg.vector_norm(pred, dim=-1, keepdim=True).clamp(min=1e-12)
    t = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.mean(2.0 - 2.0 * torch.sum(p * t, dim=-1))


def byol_loss(online: ByolNet, target: ByolNet, view_a, view_b):
    """The symmetric BYOL loss over two augmented views; no gradient
    reaches the target."""
    pa, pb = online(view_a), online(view_b)
    with torch.no_grad():
        ta, tb = target.project(view_a), target.project(view_b)
    return 0.5 * (regression_loss(pa, tb) + regression_loss(pb, ta))


def trained_tensors(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors the step trains, by name: every parameter, then each
    BatchNorm's running mean and variance (JAX's `batch_stats` leaves)."""
    out = dict(net.named_parameters())
    for name, m in net.named_modules():
        if isinstance(m, BatchNorm):
            out[f"{name}.mean"], out[f"{name}.var"] = m.mean, m.var
    return out


def _masters(net: nn.Module) -> Dict[str, torch.Tensor]:
    return {name: t.detach().float().clone() for name, t in trained_tensors(net).items()}


@torch.no_grad()
def _write(net: nn.Module, masters: Dict[str, torch.Tensor]) -> None:
    for name, t in trained_tensors(net).items():
        t.copy_(masters[name])


def init_byol(backbone: nn.Module, heads: ByolHeads,
              tx: AdamW) -> Tuple[ByolNet, ByolNet, ByolState]:
    """(online, target, state): the online network from `backbone` and
    `heads` as they stand, the target a copy of it, both sets of masters
    from the online weights, zero moments (`init_byol`,
    byol_pytorch.py:220-227)."""
    online = ByolNet(backbone, heads)
    target = copy.deepcopy(online)
    masters = _masters(online)
    state = ByolState(0, masters, {k: v.clone() for k, v in masters.items()},
                      tx.init(list(masters.values())))
    return online, target, state


def make_byol_step(online: ByolNet, target: ByolNet, tx: AdamW,
                   cfg: ByolConfig = ByolConfig()):
    """The step `step(state, view_a, view_b) -> (state, loss)`: the loss
    and the online gradients, the optimizer on the online masters, then the
    target masters <- (1 - decay) * online + decay * target
    (`optax.incremental_update` with step size 1 - decay), both written
    back into their networks."""
    params = list(trained_tensors(online).values())
    for t in params:
        t.requires_grad_(True)  # the BatchNorm buffers: gradients, as in JAX
    step_size = 1.0 - cfg.ema_decay

    def step(state: ByolState, view_a, view_b):
        loss = byol_loss(online, target, view_a, view_b)
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            new = list(state.online.values())
            tx.apply([g.float() for g in grads], state.opt_state, new)
            old = list(state.target.values())
            torch._foreach_mul_(old, 1.0 - step_size)
            torch._foreach_add_(old, torch._foreach_mul(new, step_size))
        _write(online, state.online)
        _write(target, state.target)
        state.step += 1
        return state, loss.detach()

    return step
