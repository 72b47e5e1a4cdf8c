"""Video-score (VED) model training: binary "was this video edited?".

Counterpart of `vsc22_tpu/train/vid_score.py`: sigmoid binary cross
entropy on the VSM's logits over CLIP frame-feature sequences, AdamW
(weight decay 0.01) on the warm-up schedule, an optional f32 EMA, and the
average precision of an eval stream. It shares the contrastive trainer's
`TrainState`, optimizer and checkpoints. The VSM runs no hand kernel:
its attention takes a mask bias and stays einsum. With a `mesh` the batch
is split over the data axis and the gradients are all-reduced, as the
contrastive step does it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vsc22_tpu_torch.core.metrics import _binary_average_precision
from vsc22_tpu_torch.models.layers import DropRng
from vsc22_tpu_torch.train.contrastive import (
    AdamW,
    TrainState,
    _grads,
    batch_rows,
    create_train_state,
    load_masters,
    reduce_gradients,
    warmup_linear_schedule,
)


@dataclasses.dataclass(frozen=True)
class VidScoreConfig:
    learning_rate: float = 5e-5
    warmup_ratio: float = 0.1
    total_steps: int = 1000
    weight_decay: float = 0.01
    adam_eps: float = 1e-6
    ema_decay: Optional[float] = None


def make_vid_score_optimizer(cfg: VidScoreConfig) -> AdamW:
    warmup = max(int(cfg.warmup_ratio * cfg.total_steps), 1)
    schedule = warmup_linear_schedule(cfg.learning_rate, warmup,
                                      max(cfg.total_steps - warmup, 1))
    return AdamW(schedule, eps=cfg.adam_eps, weight_decay=cfg.weight_decay)


def create_vid_score_state(model, cfg: VidScoreConfig, params=None):
    """(state, optimizer): f32 masters from `params` or the model's own."""
    return create_train_state(model, cfg, params, make_vid_score_optimizer(cfg))


def make_vid_score_train_step(model, tx: AdamW, cfg: VidScoreConfig, mesh=None):
    """`step(state, batch, generator) -> (state, metrics)` with batch =
    {"feats": [B, N, D], "label": [B]} on the model's device (under a
    `mesh`: this rank's rows of the global batch); `generator` (a CPU
    `torch.Generator`) seeds the dropout masks (`layers.DropRng`, drawn for
    the global batch under a mesh). The loss is the global batch's mean."""
    params = [p for _, p in model.named_parameters()]

    def step(state: TrainState, batch, generator: torch.Generator):
        feats, labels = batch["feats"], batch["label"]
        if mesh is None:
            rng = DropRng(generator)
        else:
            rows = feats.shape[0]
            rng = DropRng(generator, batch_rows(mesh, rows), rows * mesh.shape["data"])
        logits = model(feats, train=True, rng=rng)
        if mesh is not None:
            logits = mesh.gather_rows(logits)
            labels = torch.cat(mesh.all_gather(labels, "data"))
        loss = F.binary_cross_entropy_with_logits(logits, labels.to(logits.dtype))
        grads = [g.float() for g in _grads(loss, params)]
        if mesh is not None:
            grads = reduce_gradients(mesh, grads)
        state.apply_gradients(tx, grads, cfg.ema_decay or 0.0)
        load_masters(model, state.params)
        return state, {"loss": loss.detach()}

    return step


@torch.no_grad()
def evaluate_ap(model, batches: Iterable[Dict[str, np.ndarray]]
                ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Average precision of the model's logits over an eval stream (the
    logits gathered on the host), with the scores and labels."""
    device = next(model.parameters()).device
    scores, labels = [], []
    for batch in batches:
        feats = torch.as_tensor(np.asarray(batch["feats"]), device=device)
        scores.append(model(feats).float().cpu().numpy())
        labels.append(np.asarray(batch["label"]))
    scores = np.concatenate(scores)
    labels = np.concatenate(labels)
    return float(_binary_average_precision(labels, scores)), scores, labels
