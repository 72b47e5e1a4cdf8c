"""The contrastive descriptor trainer of the reference, step by step.

The v68 recipe (FeipengMa6/VSC22-Submission train_v68): both views of
every pair through the descriptor model, L2-normalised embeddings, InfoNCE
over the 2B x 2B similarities (temperature t, self-similarity masked) plus
the KoLeo-style entropy term -mean(log sqrt((1 - max non-matching cross
similarity) / 2)) times its weight; AdamW (b1 0.9, b2 0.999) on a linear
warm-up then linear decay, the first update at learning rate 0. Float32
throughout (TF32 off); each block is recomputed in the backward to bound
memory, which changes no number.

`judge` holds the program's readings against these. The set-up's first
steps from the seeded weights: each step's loss, and by the worst
parameter the norm of the first gradient and the norm of the change over
the steps, each gap taken against the reference's norm of that parameter
or of the median parameter, whichever is larger. The checked step after
the window, replayed from the program's own masters and Adam moments: its
loss, and by the worst parameter the norm of the difference of the
gradient (as Adam's first moment took it) and of the change, against the
same floor. Parameters whose reference gradient is under a thousandth of
the median parameter's (a key's bias under softmax moves by rounding
alone) are left out.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import models
from portbench.reference.nn import Numerics, exact_f32, l2n

B1, B2 = 0.9, 0.999
LEAVE_OUT = 1e-3  # of the median parameter's reference gradient norm


def schedule(lr: float, warmup_ratio: float, total: int):
    """Learning rate of update `count` (0-based), in float32 as optax's."""
    f32 = np.float32
    warmup = max(int(warmup_ratio * total), 1)
    decay = max(total - int(warmup_ratio * total), 1)

    def linear(init, end, steps, count):
        c = f32(min(max(count, 0), steps))
        return f32(init - end) * (f32(1) - c / f32(steps)) + f32(end)

    return lambda count: float(linear(0.0, lr, warmup, count) if count < warmup
                               else linear(lr, 0.0, decay, count - warmup))


def loss_fn(emb_a, emb_b, temperature: float, entropy_weight: float):
    bz = emb_a.shape[0]
    emb = torch.cat([emb_a, emb_b])
    sims = emb @ emb.t()
    eye = torch.eye(2 * bz, dtype=torch.bool, device=sims.device)
    sims = torch.where(eye, -10000.0, sims)
    labels = torch.cat([torch.arange(bz) + bz, torch.arange(bz)]).to(sims.device)
    ici = F.cross_entropy(sims / temperature, labels)
    cross = emb_a @ emb_b.t()
    eye = torch.eye(bz, dtype=torch.bool, device=sims.device)
    nearest = torch.where(eye, -10000.0, cross).amax(dim=1)
    ent = -torch.log(torch.sqrt(torch.clamp(0.5 - nearest / 2.0, min=1e-6))).mean()
    return ici + ent * entropy_weight


def run_steps(numerics: str, cfg: dict, weights: Dict[str, torch.Tensor], batches: List[dict],
              half_batch: bool = False, moments=None, count: int = 0,
              keep: bool = False, forward_dtype=None) -> dict:
    """The reference's losses, first-gradient norms and change norms over
    `batches` (one step each), from `weights` and, where given, the Adam
    `moments` (mu, nu: lists in the order of `weights`) after `count`
    updates (else zeros after none). `keep` adds the first step's gradient
    and the whole change, leaf by leaf. `forward_dtype`, where given, is
    the dtype the configuration runs its forward's weights in: the forward
    reads each float32 master rounded to it (the gradient taken with
    respect to the rounded weight, as a mixed-precision step takes it).
    `half_batch` leaves out the second half of every batch (a fault the
    judge has to catch)."""
    nx = Numerics(numerics)
    t = cfg["train"]
    spec = cfg["models"][cfg["model"]]
    fn = models.DESCRIPTORS[spec["arch"]]
    lr_at = schedule(t["learning_rate"], t["warmup_ratio"], t["total_steps"])
    names = list(weights)
    params = [weights[n].float().clone().requires_grad_() for n in names]
    start = [p.detach().clone() for p in params]
    if moments is None:
        mu = [torch.zeros_like(p) for p in start]
        nu = [torch.zeros_like(p) for p in start]
    else:
        mu, nu = ([m.float().clone() for m in ms] for ms in moments)
    losses, first, grad_norms = [], None, None
    run_block = lambda f, x: checkpoint(f, x, use_reentrant=False)
    with exact_f32():
        for k, batch in enumerate(batches):
            a, b = batch["img_a"], batch["img_b"]
            if half_batch:
                a, b = a[: len(a) // 2], b[: len(b) // 2]
            P = dict(zip(names, params if forward_dtype is None else
                         [p + (p.detach().to(forward_dtype).float() - p.detach())
                          for p in params]))
            emb = l2n(fn(nx, P, spec["dims"], torch.cat([a, b]), block_fn=run_block))
            loss = loss_fn(emb[: len(a)], emb[len(a):], t["temperature"], t["entropy_weight"])
            grads = torch.autograd.grad(loss, params)
            losses.append(float(loss.detach()))
            if grad_norms is None:
                first = dict(zip(names, grads)) if keep else None
                grad_norms = {n: float(g.norm()) for n, g in zip(names, grads)}
            with torch.no_grad():
                lr = lr_at(count + k)
                c1 = float(np.float32(1) - np.float32(B1) ** np.float32(count + k + 1))
                c2 = float(np.float32(1) - np.float32(B2) ** np.float32(count + k + 1))
                for p, g, m, v in zip(params, grads, mu, nu):
                    m.mul_(B1).add_(g * (1.0 - B1))
                    v.mul_(B2).add_(g * g * (1.0 - B2))
                    upd = (m / c1) / (torch.sqrt(v / c2) + t["adam_eps"])
                    if t["weight_decay"]:
                        upd = upd + t["weight_decay"] * p
                    p.add_(upd * -lr)
    changes = {n: p.detach() - s for n, p, s in zip(names, params, start)}
    out = dict(losses=losses, grad_norms=grad_norms,
               change_norms={n: float(c.norm()) for n, c in changes.items()})
    if keep:
        out.update(grads=first, changes=changes)
    return out


def _kept(grad_norms: Dict[str, float]) -> List[str]:
    median = float(np.median(list(grad_norms.values())))
    return [n for n, g in grad_norms.items() if g >= LEAVE_OUT * median]


def _worst_gap(got: Dict[str, float], want: Dict[str, float], kept: List[str]) -> float:
    floor = float(np.median([want[n] for n in kept]))
    return max(abs(got[n] - want[n]) / max(want[n], floor) for n in kept)


def _worst_difference(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                      kept: List[str]) -> float:
    """max over `kept` of ||got - want|| / max(||want||, the median leaf's ||want||)."""
    norms = {n: float(want[n].norm()) for n in kept}
    floor = float(np.median(list(norms.values())))
    return max(float((got[n].float() - want[n]).norm()) / max(norms[n], floor, 1e-30)
               for n in kept)


def judge(cfg: dict, exp: dict, answers: dict) -> dict:
    """`exp`: `first` (the set-up's steps, `run_steps`) and `window` (the
    checked step, `run_steps(keep=True)`); `answers` the same of the
    program's (the window's: `loss`, `grads`, `changes`)."""
    lim = cfg["limits"]
    first, window = exp["first"], exp["window"]
    kept = _kept(first["grad_norms"])
    loss_gaps = [abs(g - w) / abs(w) for g, w in zip(answers["losses"], first["losses"])]
    kept_w = _kept(window["grad_norms"])
    read = dict(loss_gap=max(loss_gaps),
                grad_gap=_worst_gap(answers["grad_norms"], first["grad_norms"], kept),
                change_gap=_worst_gap(answers["change_norms"], first["change_norms"], kept),
                window_loss_gap=abs(answers["window"]["loss"] - window["losses"][0])
                / abs(window["losses"][0]),
                window_grad_gap=_worst_difference(answers["window"]["grads"], window["grads"],
                                                  kept_w),
                window_change_gap=_worst_difference(answers["window"]["changes"],
                                                    window["changes"], kept_w))
    group = read["grad_gap"] > lim["grad_gap"] or read["change_gap"] > lim["change_gap"]
    failed = sum(group or gap > lim["loss_gap"] for gap in loss_gaps)
    failed += any(read[k] > lim[k] for k in read if k.startswith("window_"))
    return dict(readings=read, attempted=len(loss_gaps) + 1, failed=int(failed),
                left_out=sorted(set(first["grad_norms"]) - set(kept)))
