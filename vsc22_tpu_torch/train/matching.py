"""Matching-track training: the 2-fold classify filter and SAM refine model.

Counterpart of `vsc22_tpu/train/matching.py` (reference contract
M1/train/train_matching.py:281-420 and M1/train/dataset.py):
  - folds: query ids shuffled with np seed 2023, split in half; model h1
    trains on fold A's complement and predicts fold A, h2 the reverse;
  - classify: mean CE over 2 classes, AdamW lr 1e-4 wd 5e-5, 160^2 padded
    sims, augs (Gaussian blur p.3 / uniform noise +-0.1 p.3 / sqrt-abs p.1);
  - refine: soft diagonal-band heatmap labels (sqrt(1 - |d|) within
    perpendicular distance 1 of each GT segment's diagonal), loss
    -(log_softmax(pred) * [1-y, y]).sum(); 128^2 with random transpose.

Both models are BatchNorm CNNs in float32: a train step runs the model in
train mode (batch statistics, the running buffers updated in place, the
classifier's dropout), takes the gradients of the loss, and applies the
optimizer (`contrastive.AdamW`, optax's `adamw` at a constant rate, eps
1e-8) to f32 masters written back into the model. The batches, their
padding, the random transposes and the augmentations come from the same
`np.random.default_rng(seed)` stream, in the same order, as the JAX fold
trainers draw them; the initial weights (`layers.reset_parameters`) and
the dropout masks (`layers.DropRng`) come from torch generators seeded
with `seed`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.matching.simmat import pad_sim_matrix
from vsc22_tpu_torch.models.layers import DropRng, reset_parameters
from vsc22_tpu_torch.train.contrastive import AdamState, AdamW, load_masters


# ---------------------------------------------------------------------------
# Labels and augmentation (host numpy, as the JAX package's)
# ---------------------------------------------------------------------------


def soft_band_label(
    resolution: Tuple[int, int], gt_list: Sequence[Tuple[float, float, float, float]]
) -> np.ndarray:
    """Soft diagonal-band heatmap label for GT segments (qs, qe, rs, re).

    Pixels within perpendicular distance 1 of the segment's diagonal get
    value sqrt(1 - |d|); the band spans the GT bounding box.
    """
    label = np.zeros(resolution, np.float32)
    for qs, qe, rs, re in gt_list:
        v = np.array([rs - re, qe - qs], np.float32)
        norm = np.linalg.norm(v)
        if norm == 0:
            continue
        v /= norm
        i0, i1 = int(round(qs)), min(int(qe), resolution[0] - 1)
        j0, j1 = int(round(rs)), min(int(re), resolution[1] - 1)
        if i1 < i0 or j1 < j0:
            continue
        ii, jj = np.meshgrid(
            np.arange(i0, i1 + 1), np.arange(j0, j1 + 1), indexing="ij"
        )
        dist = (ii - qs) * v[0] + (jj - rs) * v[1]
        band = np.abs(dist) < 1
        vals = np.sqrt(np.clip(1 - np.abs(dist), 0, None))
        patch = label[i0 : i1 + 1, j0 : j1 + 1]
        label[i0 : i1 + 1, j0 : j1 + 1] = np.where(band, vals, patch)
    return label


def augment_sim(sim: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Reference sim-matrix augs: blur p.3 / noise p.3 / sqrt-abs p.1."""
    from scipy import ndimage

    val = rng.uniform(0, 1)
    if val > 0.7:
        sigma = rng.uniform(0.1, 0.7)
        return ndimage.gaussian_filter(sim, sigma, mode="nearest")
    if val > 0.4:
        return sim + rng.uniform(-0.1, 0.1, sim.shape).astype(np.float32)
    if val < 0.1:
        return np.sqrt(np.abs(sim))
    return sim


def split_folds(query_ids: Sequence[str], seed: int = 2023) -> set:
    """First-half query ids after the reference's seeded shuffle (the
    shuffle `np.random.seed(seed); np.random.shuffle` gives, without
    touching numpy's global state)."""
    qid_list = sorted(set(query_ids))
    np.random.RandomState(seed).shuffle(qid_list)
    return set(qid_list[: len(qid_list) // 2])


# ---------------------------------------------------------------------------
# Train steps (BatchNorm-aware)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CNNTrainState:
    """f32 master `params` by parameter name, the model's BN running
    buffers by name (`batch_stats`, the model's own tensors: a train step
    updates them in place), the optimizer state and the step."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: AdamState
    step: int = 0


def make_cnn_optimizer(lr: float = 1e-4, weight_decay: float = 5e-5) -> AdamW:
    """optax `adamw(lr, weight_decay=weight_decay)`: b1 0.9, b2 0.999, eps
    1e-8, a constant rate, decay on every leaf."""
    return AdamW(lambda count: lr, eps=1e-8, weight_decay=weight_decay)


def create_cnn_state(model, tx: AdamW) -> CNNTrainState:
    """The state of `model` as it stands: masters copied from its
    parameters, zero moments."""
    params = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    return CNNTrainState(params=params, batch_stats=dict(model.named_buffers()),
                         opt_state=tx.init(list(params.values())))


def _make_step(model, tx: AdamW, forward, loss_fn):
    """step(state, images, labels, generator) -> (state, loss): one train
    step on the model's device, `forward(images, generator)` its train-mode
    pass; the loss is a detached 0-d tensor. Its two halves:
    `step.gradients(images, labels, generator)` -> (loss, the f32
    parameter gradients), which moves the BN buffers, and
    `step.update(state, grads)`, the optimizer on the masters, written
    back into the model."""
    params = [p for _, p in model.named_parameters()]

    def gradients(images, labels, generator: torch.Generator):
        loss = loss_fn(forward(images, generator).float(), labels)
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        return loss.detach(), [g.float() for g in grads]

    def update(state: CNNTrainState, grads) -> CNNTrainState:
        tx.apply(grads, state.opt_state, list(state.params.values()))
        load_masters(model, state.params)
        state.step += 1
        return state

    def step(state: CNNTrainState, images, labels, generator: torch.Generator):
        loss, grads = gradients(images, labels, generator)
        return update(state, grads), loss

    step.gradients, step.update = gradients, update
    return step


def classify_loss(logits, labels):
    """Mean 2-class cross-entropy (optax's integer-label softmax CE)."""
    return F.cross_entropy(logits, labels.long())


def refine_loss(logits, labels):
    """Summed soft cross-entropy over the [B, H, W, 2] per-pixel logits
    against the targets [1 - y, y]."""
    log_pred = torch.log_softmax(logits, dim=-1)
    target = torch.stack([1.0 - labels, labels], dim=-1)
    return -(log_pred * target).sum()


def make_classify_train_step(model, tx: AdamW):
    """The classifier's step; `generator` (a CPU `torch.Generator`) seeds
    the step's dropout mask (`layers.DropRng`)."""
    return _make_step(model, tx, lambda x, gen: model(x, train=True, rng=DropRng(gen)),
                      classify_loss)


def make_refine_train_step(model, tx: AdamW):
    """The SAM's step (no dropout: `generator` is taken and not drawn from,
    as the JAX step takes an rng the SAM never uses)."""
    return _make_step(model, tx, lambda x, gen: model(x, train=True), refine_loss)


# ---------------------------------------------------------------------------
# Fold orchestration
# ---------------------------------------------------------------------------


def _classify_batches(features, infos, resolution, batch, rng, enhance):
    """(images [B, res, res, 3] f32, labels [B] i32) numpy batches; the last
    one padded with the first indices of the order."""
    order = rng.permutation(len(features)) if enhance else np.arange(len(features))
    for start in range(0, len(order), batch):
        idxs = order[start : start + batch]
        if len(idxs) < batch:
            idxs = np.concatenate([idxs, order[: batch - len(idxs)]])
        images, labels = [], []
        for i in idxs:
            sim = np.asarray(features[i], np.float32)
            if sim.ndim == 3:
                sim = sim[0]
            if enhance:
                sim = augment_sim(sim, rng)
            images.append(pad_sim_matrix(sim, resolution))
            labels.append(int(infos[i][2]))
        yield np.stack(images), np.array(labels, np.int32)


def _refine_batches(train_meta, resolution, batch, rng):
    """(images [B, res, res, 3], soft labels [B, res, res]) numpy batches of
    one epoch, drawn as the JAX `train_refine_model` draws them."""
    order = rng.permutation(len(train_meta))
    for start in range(0, len(order), batch):
        idxs = order[start : start + batch]
        if len(idxs) < batch:
            idxs = np.concatenate([idxs, order[: batch - len(idxs)]])
        images, labels = [], []
        for i in idxs:
            qid, rid, qf, rf, gt_list = train_meta[i]
            sim = (qf @ rf.T).astype(np.float32)
            label = soft_band_label((resolution, resolution), gt_list)
            if rng.uniform() > 0.5:  # random transpose
                sim, label = sim.T, label.T
            sim = augment_sim(sim, rng)
            images.append(pad_sim_matrix(sim, resolution))
            labels.append(label)
        yield np.stack(images), np.stack(labels)


def _fresh_model(model_factory, seed: int, device):
    model = model_factory()
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def train_classify_model(
    model_factory,
    features: List[np.ndarray],
    infos: List[List],
    num_epochs: int = 10,
    batch: int = 64,
    resolution: int = 160,
    seed: int = 2023,
    lr: float = 1e-4,
    device="cuda",
):
    """2-fold training; returns ([(model_h1, state_h1), (model_h2,
    state_h2)], fold-A query ids). `model_factory()` builds a port model
    on the CPU; it is seeded and moved to `device` (the card unless told
    otherwise).

    h1 trains on queries outside fold A and scores fold A; h2 the reverse —
    every candidate gets an out-of-fold probability downstream.
    """
    device = resolve(device)
    fold_a = split_folds([info[0] for info in infos], seed)
    in_a = [i for i in range(len(infos)) if infos[i][0] in fold_a]
    out_a = [i for i in range(len(infos)) if infos[i][0] not in fold_a]

    tx = make_cnn_optimizer(lr)
    states = []
    for train_idx in (out_a, in_a):
        model = _fresh_model(model_factory, seed, device)
        rng_np = np.random.default_rng(seed)
        state = create_cnn_state(model, tx)
        step = make_classify_train_step(model, tx)
        feats = [features[i] for i in train_idx]
        infs = [infos[i] for i in train_idx]
        gen = torch.Generator().manual_seed(seed)
        for _ in range(num_epochs):
            for images, labels in _classify_batches(feats, infs, resolution, batch, rng_np, True):
                state, _ = step(state, torch.from_numpy(images).to(device),
                                torch.from_numpy(labels).to(device), gen)
        states.append((model, state))
    return states, fold_a


def train_refine_model(
    model_factory,
    match_meta: List[Tuple],
    num_epochs: int = 20,
    batch: int = 8,
    resolution: int = 128,
    seed: int = 2023,
    lr: float = 1e-4,
    device="cuda",
):
    """2-fold SAM training. meta rows: (qid, rid, qfeat, rfeat, gt_list).
    Returns ([(model_h1, state_h1), (model_h2, state_h2)], fold-A query
    ids): h1 trained on fold A, h2 on the rest."""
    device = resolve(device)
    fold_a = split_folds([m[0] for m in match_meta], seed)
    in_a = [m for m in match_meta if m[0] in fold_a]
    out_a = [m for m in match_meta if m[0] not in fold_a]

    tx = make_cnn_optimizer(lr)
    states = []
    for train_meta in (in_a, out_a):
        model = _fresh_model(model_factory, seed, device)
        rng_np = np.random.default_rng(seed)
        state = create_cnn_state(model, tx)
        step = make_refine_train_step(model, tx)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(num_epochs):
            for images, labels in _refine_batches(train_meta, resolution, batch, rng_np):
                state, _ = step(state, torch.from_numpy(images).to(device),
                                torch.from_numpy(labels).to(device), gen)
        states.append((model, state))
    return states, fold_a
