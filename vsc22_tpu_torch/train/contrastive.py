"""Global-batch contrastive descriptor training (InfoNCE + KoLeo entropy).

Counterpart of `vsc22_tpu/train/contrastive.py`: the same losses over both
views' L2-normalised f32 embeddings, AdamW (optax's `adamw`: b1 0.9, b2
0.999, eps 1e-6, decoupled weight decay) on optax's warm-up schedule with
optax's global-norm clip, an f32 EMA of the parameters, and FGM's second
pass on inputs perturbed along the first pass's input gradients.

Parameters: the model holds its working copies (matmul weights in the
compute dtype, so that inference rounds as before); the `TrainState`
holds f32 masters, the f32 Adam moments and the f32 EMA, keyed by the
model's parameter names. Each step takes the gradients of the working
copies (a bf16 weight's gradient is rounded to bf16 and then summed in
f32, as JAX's `astype` VJP does), updates the masters and writes them back
into the model, rounded to each parameter's dtype (JAX's cast at use).

The step runs where the model and the batch are: on the card for the
Base builders, on the CPU when the caller builds there. It updates the
state in place and returns it, as the JAX step donates its state.

With a `mesh` (`parallel/mesh.Mesh`) each rank passes its rows of the
global batch (`parallel.batch_sharding`; ranks of one model column pass
the same rows) and the step is the one-rank step on the global batch, as
the JAX step is under its sharding: the embeddings are gathered over the
data axis (`Mesh.gather_rows`) so that every loss, Barlow's moments too,
is over the global batch; FGM's input-gradient norms are global; the
dropout and DropPath masks are drawn for the global batch
(`layers.DropRng` rows); the summed gradients are all-reduced over the
data axis. On the model axis each rank keeps only its `param_shardings`
block of the f32 masters, the Adam moments and the EMA (`ModelShards`),
updates it from the reduced gradient (clipped by the global norm: every
rank holds the whole reduced gradient) and gathers the whole working
weights back into the model, because the hand kernels take whole
weights. `TrainState.whole()` gathers a whole state for a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vsc22_tpu_torch.models.layers import BatchNorm, DropRng, l2_normalize
from vsc22_tpu_torch.parallel.mesh import param_shardings

NEG_LARGE = -10000.0


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    temperature: float = 0.05
    margin: float = 0.0
    ici_weight: float = 1.0
    entropy_weight: float = 30.0
    product_loss: bool = False
    # Optimization (reference: transformers.AdamW + linear warmup schedule).
    learning_rate: float = 5e-5
    warmup_ratio: float = 0.1
    total_steps: int = 10000
    weight_decay: float = 0.0
    adam_eps: float = 1e-6
    clip_grad_norm: Optional[float] = None
    # Extras.
    ema_decay: Optional[float] = 0.999
    fgm_epsilon: Optional[float] = None  # e.g. 0.1 enables FGM adversarial step
    remat: bool = False  # activation checkpointing of the whole model
    barlow_weight: float = 0.0
    barlow_lambda: float = 5e-3


# --- losses: `vsc22_tpu/train/contrastive.py:84-164` -------------------------


def contrastive_loss(emb_a, emb_b, temperature: float, margin: float = 0.0):
    """InfoNCE over the 2B x 2B similarity matrix of both views: row i's
    positive is its counterpart view, the self-similarity diagonal is set
    to -1e4, `margin` is subtracted from the positive logits."""
    bz = emb_a.shape[0]
    emb = torch.cat([emb_a, emb_b]).float()
    sims = emb @ emb.t()
    n = 2 * bz
    eye = torch.eye(n, dtype=torch.bool, device=sims.device)
    sims = torch.where(eye, NEG_LARGE, sims)
    labels = torch.cat([torch.arange(bz) + bz, torch.arange(bz)]).to(sims.device)
    if margin > 0:
        sims = sims - margin * F.one_hot(labels, n).to(sims.dtype)
    return F.cross_entropy(sims / temperature, labels)


def entropy_loss(sims_ab, weight: float):
    """KoLeo-style repulsion: -log sqrt((1 - max non-match sim) / 2) over
    the B x B cross-view similarities, the matching diagonal excluded."""
    n = sims_ab.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=sims_ab.device)
    max_non_match = torch.where(eye, NEG_LARGE, sims_ab).amax(dim=1)
    closest = torch.sqrt(torch.clamp(0.5 - max_non_match / 2.0, min=1e-6))
    return -torch.log(closest).mean() * weight


def product_entropy_loss(emb_a, emb_b):
    """Alternative positive-pair pull: mean(exp(1 - sim(a_i, b_i)))."""
    return torch.exp(1.0 - (emb_a * emb_b).sum(-1)).mean()


def barlow_twins_loss(emb_a, emb_b, lambd: float = 5e-3):
    """BarlowTwins redundancy reduction, ||diag(C) - 1||^2 + lambd *
    ||offdiag(C)||^2, with both views standardised over the whole batch
    (unbiased std clamped at 1e-5) as the JAX loss computes it."""
    n = emb_a.shape[0]

    def standardize(e):
        e = e.float()
        centered = e - e.mean(dim=0)
        var = centered.square().mean(dim=0)
        std = torch.sqrt(var * n / max(n - 1, 1))
        return centered / torch.clamp(std, min=1e-5)

    z1, z2 = standardize(emb_a), standardize(emb_b)
    c = z1.t() @ z2 / n
    eye = torch.eye(c.shape[0], dtype=c.dtype, device=c.device)
    on_diag = (torch.diagonal(c) - 1.0).square().sum()
    off_diag = (c * (1.0 - eye)).square().sum()
    return on_diag + lambd * off_diag


# --- the optimizer: `make_optimizer` (`:167-184`) in optax's arithmetic -----


def warmup_linear_schedule(learning_rate: float, warmup_steps: int, decay_steps: int):
    """optax `join_schedules([linear_schedule(0, lr, warmup_steps),
    linear_schedule(lr, 0, decay_steps)], [warmup_steps])` as a function of
    the update count, in optax's float32 arithmetic. The first update
    (count 0) gets lr 0."""
    f32 = np.float32

    def linear(init: float, end: float, steps: int, count: int):
        c = f32(min(max(count, 0), steps))
        frac = f32(1) - c / f32(steps)
        return f32(init - end) * frac + f32(end)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return float(linear(0.0, learning_rate, warmup_steps, count))
        return float(linear(learning_rate, 0.0, decay_steps, count - warmup_steps))

    return schedule


def make_schedule(cfg: ContrastiveConfig):
    warmup = int(cfg.warmup_ratio * cfg.total_steps)
    return warmup_linear_schedule(cfg.learning_rate, max(warmup, 1),
                                  max(cfg.total_steps - warmup, 1))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's `clip_by_global_norm`: the gradients unchanged where their
    global norm is under `max_norm`, else each times max_norm / norm
    (divided first, then multiplied, with no epsilon)."""
    norm = torch.sqrt(sum((g.float().square().sum() for g in grads),
                          torch.zeros((), device=grads[0].device)))
    clipped = norm >= max_norm
    return [torch.where(clipped, (g / norm) * max_norm, g) for g in grads]


@dataclasses.dataclass
class AdamState:
    """optax `ScaleByAdamState` (and the schedule's count, which equals it)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """optax `chain(clip_by_global_norm?, adamw(schedule, b1, b2, eps,
    weight_decay))` over lists of f32 tensors, in optax's order of
    operations: moments, bias corrections by 1 - b^count, m / (sqrt(v) +
    eps), + weight_decay * params, times -lr(count)."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0, clip_grad_norm: Optional[float] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_grad_norm = clip_grad_norm

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor], state: AdamState,
              params: List[torch.Tensor], clip: bool = True) -> None:
        """One update of `params`, `state.mu` and `state.nu`, in place;
        `clip=False` where the caller clipped the whole gradient already."""
        if clip and self.clip_grad_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_grad_norm)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                         1.0 - b2))
        lr = self.schedule(state.count)
        state.count += 1
        f32 = np.float32
        c1 = float(f32(1) - f32(b1) ** f32(state.count))
        c2 = float(f32(1) - f32(b2) ** f32(state.count))
        denom = torch._foreach_sqrt(torch._foreach_div(state.nu, c2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(state.mu, c1), denom)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(params, updates)


def make_optimizer(cfg: ContrastiveConfig) -> AdamW:
    return AdamW(make_schedule(cfg), eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
                 clip_grad_norm=cfg.clip_grad_norm)


# --- state and step ---------------------------------------------------------


@dataclasses.dataclass
class ModelShards:
    """The block of each parameter a rank keeps on the mesh's model axis:
    `specs` by parameter name, from `parallel.param_shardings`."""

    mesh: object
    specs: Dict[str, tuple]

    def take(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.take_shard(t, self.specs[name]).clone()

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.gather_shard(t, self.specs[name])


@dataclasses.dataclass
class TrainState:
    """`step`; f32 master `params`, the optimizer state and the f32 EMA
    (None when EMA is off), each keyed or ordered by the model's
    `named_parameters()`. Under a mesh `shards` says which block of each
    tensor this rank holds (None: whole tensors)."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    ema_params: Optional[Dict[str, torch.Tensor]]
    shards: Optional[ModelShards] = None

    def _map(self, fn) -> "TrainState":
        names = list(self.params)
        opt = AdamState(self.opt_state.count,
                        [fn(n, t) for n, t in zip(names, self.opt_state.mu)],
                        [fn(n, t) for n, t in zip(names, self.opt_state.nu)])
        ema = None if self.ema_params is None else {n: fn(n, t)
                                                    for n, t in self.ema_params.items()}
        return TrainState(self.step, {n: fn(n, t) for n, t in self.params.items()}, opt, ema)

    @torch.no_grad()
    def whole(self) -> "TrainState":
        """The whole state (a collective on the model axis: every rank
        calls it), as a checkpoint holds it; `self` where it is whole."""
        return self if self.shards is None else self._map(self.shards.gather)

    @torch.no_grad()
    def take_shards(self, whole: "TrainState") -> "TrainState":
        """This state's blocks of a whole state (a restored checkpoint)."""
        if self.shards is None:
            return whole
        state = whole._map(self.shards.take)
        state.shards = self.shards
        return state

    @torch.no_grad()
    def apply_gradients(self, tx: AdamW, grads: List[torch.Tensor], ema_decay: float,
                        clip: bool = True):
        params = list(self.params.values())
        tx.apply(grads, self.opt_state, params, clip)
        if self.ema_params is not None:
            ema = list(self.ema_params.values())
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - ema_decay))
        self.step += 1
        return self


@torch.no_grad()
def load_masters(model, params: Dict[str, torch.Tensor],
                 shards: Optional[ModelShards] = None) -> None:
    """Write f32 masters into the model's parameters, each rounded to its
    parameter's dtype; blocks under `shards` are gathered whole first."""
    for name, p in model.named_parameters():
        p.copy_(params[name] if shards is None else shards.gather(name, params[name]))


def create_train_state(model, cfg: ContrastiveConfig, params=None, tx: Optional[AdamW] = None,
                       mesh=None):
    """(state, optimizer) for `model`: f32 masters from `params` (a dict of
    tensors or arrays by parameter name, loaded into the model too) or from
    the model's own parameters, zero moments, and an EMA copy when
    `cfg.ema_decay` is set. Under a `mesh` the state holds this rank's
    model-axis blocks (every rank passes the same weights, as every JAX
    host inits from one key)."""
    tx = tx or make_optimizer(cfg)
    masters = {}
    for name, p in model.named_parameters():
        src = p if params is None else torch.as_tensor(np.asarray(params[name]))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, model {tuple(p.shape)}")
        masters[name] = src.detach().to(device=p.device, dtype=torch.float32).clone()
    if params is not None:
        load_masters(model, masters)
    shards = None
    if mesh is not None:
        shards = ModelShards(mesh, param_shardings(mesh, masters))
        masters = {name: shards.take(name, t) for name, t in masters.items()}
    ema = {k: v.clone() for k, v in masters.items()} if cfg.ema_decay is not None else None
    state = TrainState(0, masters, tx.init(list(masters.values())), ema, shards)
    return state, tx


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def _grads(loss, wrt):
    return torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)


def batch_rows(mesh, local: int, views: int = 1) -> torch.Tensor:
    """The global batch's sample index of each of a rank's `views * local`
    samples: its `local` rows of each of `views` stacked global batches of
    `local * data-axis` rows (the step's `[a; b]` is two)."""
    nd, at = mesh.shape["data"], mesh.index("data")
    own = torch.arange(local) + at * local
    return torch.cat([own + v * nd * local for v in range(views)])


def reduce_gradients(mesh, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """f32 gradients summed over the mesh's data axis, in one collective."""
    flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), "data")
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def _global_norm(mesh, g: torch.Tensor) -> torch.Tensor:
    """The L2 norm of a tensor whose rows are split over the data axis:
    the norm of the ranks' norms (one rank: its own norm, bit for bit)."""
    local = torch.linalg.vector_norm(g)
    if mesh is None:
        return local
    return torch.linalg.vector_norm(torch.stack(mesh.all_gather(local, "data")))


def refuse_batch_norm(model) -> None:
    """Raise for a model that holds a `BatchNorm`: the step runs the model
    in train mode, where a BatchNorm normalises with the batch's statistics
    and updates its running ones. The JAX step refuses such a member (it
    applies the model with no mutable `batch_stats` collection, so flax
    raises `ModifyScopeVariableError` at its first trace), and this
    package's checkpoints keep no running statistics."""
    names = [n or type(model).__name__ for n, m in model.named_modules()
             if isinstance(m, BatchNorm)]
    if names:
        raise ValueError(
            f"the contrastive train step cannot train {type(model).__name__}: it holds "
            f"{len(names)} BatchNorm layers ({', '.join(names[:3])}"
            f"{', ...' if len(names) > 3 else ''}), whose running "
            "statistics a train-mode step would update; the JAX step refuses such a "
            "member too (its batch_stats collection is immutable there)")


def make_train_step(model, tx: AdamW, cfg: ContrastiveConfig, mesh=None):
    """The train step `step(state, batch, generator) -> (state, metrics)`,
    batch = {"img_a": [B, H, W, 3], "img_b": [B, H, W, 3]} on the model's
    device (under a `mesh`: this rank's rows of the global batch, and the
    state from `create_train_state(mesh=)`); `generator` (a CPU
    `torch.Generator`) seeds the step's dropout and DropPath masks
    (`layers.DropRng`, drawn on the model's device), the same for both FGM
    passes. With `cfg.remat` the whole model runs under
    `torch.utils.checkpoint`. Raises for a model with a BatchNorm
    (`refuse_batch_norm`) before any step runs."""
    refuse_batch_norm(model)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def loss_fn(img_a, img_b, rng):
        bz = img_a.shape[0]
        images = torch.cat([img_a, img_b])
        if cfg.remat:
            embeds = checkpoint(model, images, True, rng, use_reentrant=False)
        else:
            embeds = model(images, train=True, rng=rng)
        embeds = l2_normalize(embeds.float())
        emb_a, emb_b = embeds[:bz], embeds[bz:]
        if mesh is not None:
            emb_a, emb_b = mesh.gather_rows(emb_a), mesh.gather_rows(emb_b)
        if cfg.product_loss:
            ent = product_entropy_loss(emb_a, emb_b)
        else:
            ent = entropy_loss(emb_a @ emb_b.t(), cfg.entropy_weight)
        ici = contrastive_loss(emb_a, emb_b, cfg.temperature, cfg.margin) * cfg.ici_weight
        loss = ici + ent
        metrics = {"ici_loss": ici, "entropy_loss": ent}
        if cfg.barlow_weight > 0.0:
            bl = barlow_twins_loss(emb_a, emb_b, cfg.barlow_lambda) * cfg.barlow_weight
            loss = loss + bl
            metrics["barlow_loss"] = bl
        metrics["loss"] = loss
        return loss, metrics

    def gradients(batch, generator: torch.Generator):
        """(metrics, the summed f32 parameter gradients) of one step,
        without the update: the clean pass, and with FGM the pass on
        inputs moved by eps * g / (||g|| + 1e-8) over each whole view.
        Under a mesh the gradients are the global batch's, on every rank."""
        img_a, img_b = batch["img_a"], batch["img_b"]
        if mesh is None:
            rng = DropRng(generator)
        else:
            bz = img_a.shape[0]
            rng = DropRng(generator, batch_rows(mesh, bz, 2), 2 * bz * mesh.shape["data"])
        if cfg.fgm_epsilon is None:
            loss, metrics = loss_fn(img_a, img_b, rng)
            grads = [g.float() for g in _grads(loss, params)]
        else:
            img_a = img_a.detach().requires_grad_()
            img_b = img_b.detach().requires_grad_()
            loss, metrics = loss_fn(img_a, img_b, rng)
            *gp, ga, gb = _grads(loss, params + [img_a, img_b])
            with torch.no_grad():
                adv_a = img_a + cfg.fgm_epsilon * ga / (_global_norm(mesh, ga) + 1e-8)
                adv_b = img_b + cfg.fgm_epsilon * gb / (_global_norm(mesh, gb) + 1e-8)
            adv_loss, _ = loss_fn(adv_a, adv_b, rng)
            grads = [g.float() + h.float() for g, h in zip(gp, _grads(adv_loss, params))]
        if mesh is not None:
            grads = reduce_gradients(mesh, grads)
        return _detached(metrics), grads

    def update(state: TrainState, grads) -> TrainState:
        """The optimizer and EMA on `state`, the masters written back into
        the model (under a mesh: on this rank's blocks, then gathered)."""
        if state.shards is not None:
            if tx.clip_grad_norm is not None:
                grads = clip_by_global_norm(grads, tx.clip_grad_norm)
            grads = [state.shards.mesh.take_shard(g, state.shards.specs[n])
                     for n, g in zip(names, grads)]
        state.apply_gradients(tx, grads, cfg.ema_decay or 0.0, clip=state.shards is None)
        load_masters(model, state.params, state.shards)
        return state

    def step(state: TrainState, batch, generator: torch.Generator):
        metrics, grads = gradients(batch, generator)
        return update(state, grads), metrics

    step.gradients, step.update = gradients, update
    return step
