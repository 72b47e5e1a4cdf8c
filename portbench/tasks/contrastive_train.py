"""The contrastive descriptor trainer's step (`train/contrastive.make_train_step`).

One unit of work is one step on the next batch of the traffic's pool
(`2 * pairs` images). Set-up builds the model with seeded weights, the
train state (f32 masters, AdamW on the configured schedule) and the pool,
and drives that same step object through the first `reference_steps`
steps on the pool's first batches, which all differ. It keeps, per
parameter, the norm of the first gradient as the optimizer holds it
(Adam's first moment after one step, / (1 - b1)) and the norm of the
parameters' change over those steps, and each step's loss; the window
then carries on with the same object.

Once the window has closed (and the device's peak is read), `release`
takes one more step through the same call on the next batch of the pool:
the checked step. It keeps the masters and Adam's moments from before it
and after it, the gradient as Adam took it ((mu after - b1 mu before) /
(1 - b1)) and the change, then frees the program.

The judge runs the set-up's steps in the plain reference
(`reference/train.py`) from the seeded weights (drawn in the forward's
dtype), and the checked step from the program's own masters and moments of
before it, its forward reading the masters rounded to the configuration's
dtype as the configuration states; it compares the losses, the norms of
the first steps and, leaf by leaf, the checked step's gradient and change.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import train as ref_train
from portbench.tasks import common
from portbench.traffic import generate
from portbench.yardstick.roofline import FORWARD_FLOPS

LIBRARIES = ("attn_proj", "ln_mlp")


class ContrastiveTrain:
    reference_s = 0.0

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.libraries = LIBRARIES
        self.losses: List[torch.Tensor] = []
        self.steps = 0

    def _seed(self, stream: int) -> int:
        return generate.sub_seed(self.seed, stream)

    def setup(self) -> None:
        from vsc22_tpu_torch.train.contrastive import (
            ContrastiveConfig,
            create_train_state,
            make_train_step,
        )

        cfg, t = self.cfg, self.cfg["train"]
        spec = cfg["models"][cfg["model"]]
        self.model = common.build_model(spec, common.DTYPES[cfg["dtype"]], self.device)
        self.spec = common.param_spec(self.model)
        common.load(self.model, common.draw(self.spec, self._seed(10), self.device))
        self.step_cfg = ContrastiveConfig(
            temperature=t["temperature"], entropy_weight=t["entropy_weight"],
            learning_rate=t["learning_rate"], warmup_ratio=t["warmup_ratio"],
            total_steps=t["total_steps"], weight_decay=t["weight_decay"], adam_eps=t["adam_eps"],
            ema_decay=None, fgm_epsilon=None)
        self.state, tx = create_train_state(self.model, self.step_cfg)
        self.b1 = tx.b1
        self.step_fn = make_train_step(self.model, tx, self.step_cfg)
        self.generator = torch.Generator().manual_seed(self._seed(4))
        self.pool = generate.image_pairs(self.traffic, self.seed, self.device)
        start = {n: p.clone() for n, p in self.state.params.items()}
        self.first_losses = []
        for k in range(t["reference_steps"]):
            self.unit()
            if k == 0:
                self.grad_norms = {n: float(m.norm()) / (1.0 - self.b1)
                                   for n, m in zip(self.state.params, self.state.opt_state.mu)}
        self.finish_window()
        self.first_losses = [float(v) for v in self.losses]
        self.change_norms = {n: float((p - start[n]).norm()) for n, p in self.state.params.items()}
        del start
        self.losses.clear()

    def unit(self) -> int:
        batch = self.pool[self.steps % len(self.pool)]
        self.state, metrics = self.step_fn(self.state, batch, self.generator)
        self.losses.append(metrics["loss"])
        self.steps += 1
        return 2 * self.traffic["pairs"]

    def finish_window(self) -> None:
        """Every step's loss on the host (the end of the last step)."""
        if not self.losses:
            return
        values = torch.stack(self.losses).float().cpu()
        if not bool(torch.isfinite(values).all()):
            raise FloatingPointError(f"a step's loss is not finite: {values.tolist()}")

    def window_metrics(self, work: int, seconds: float) -> Dict[str, float]:
        return {"train_images_per_s": work / seconds}

    def trace_modules(self) -> Dict[str, list]:
        return {"train/forward": [self.model]}

    def flops_per_row(self) -> Dict[str, float]:
        spec = self.cfg["models"][self.cfg["model"]]
        return {"train/forward": float(FORWARD_FLOPS[spec["arch"]](spec["dims"]))}

    def set_timer(self, timer) -> None:
        pass

    @torch.no_grad()
    def _snapshot(self) -> dict:
        opt = self.state.opt_state
        return dict(params={n: p.clone() for n, p in self.state.params.items()},
                    mu=[m.clone() for m in opt.mu], nu=[v.clone() for v in opt.nu],
                    count=opt.count)

    def release(self) -> None:
        """The checked step (see the module docstring), then the program's
        device state freed before the reference runs."""
        self.before = self._snapshot()
        self.checked_batch = self.pool[self.steps % len(self.pool)]
        self.unit()
        loss = float(self.losses[-1])
        with torch.no_grad():
            names = list(self.state.params)
            grads = {n: (m - self.b1 * m0) / (1.0 - self.b1) for n, m, m0 in
                     zip(names, self.state.opt_state.mu, self.before["mu"])}
            changes = {n: self.state.params[n] - self.before["params"][n] for n in names}
        self.window_answers = dict(loss=loss, grads=grads, changes=changes)
        self.state = self.step_fn = self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_weights(self) -> Dict[str, torch.Tensor]:
        return common.as_f32(common.draw(self.spec, self._seed(10), self.device))

    def expected(self, numerics: str = "f32", half_batch: bool = False) -> dict:
        b = self.before
        return dict(
            first=ref_train.run_steps(numerics, self.cfg, self.reference_weights(),
                                      self.pool[:self.cfg["train"]["reference_steps"]],
                                      half_batch),
            window=ref_train.run_steps(numerics, self.cfg, b["params"], [self.checked_batch],
                                       half_batch, (b["mu"], b["nu"]), b["count"], keep=True,
                                       forward_dtype=common.DTYPES[self.cfg["dtype"]]))

    def answers(self) -> dict:
        return dict(losses=self.first_losses, grad_norms=self.grad_norms,
                    change_norms=self.change_norms, window=self.window_answers)

    def control_answers(self, other: dict) -> dict:
        """A control's reference readings (`expected`) in the shape of the program's answers."""
        first, window = other["first"], other["window"]
        return dict(losses=first["losses"], grad_norms=first["grad_norms"],
                    change_norms=first["change_norms"],
                    window=dict(loss=window["losses"][0], grads=window["grads"],
                                changes=window["changes"]))

    def judge(self, exp: dict, answers: dict = None) -> dict:
        """The reference's verdict; every step taken counts as attempted."""
        verdict = ref_train.judge(self.cfg, exp, self.answers() if answers is None else answers)
        verdict["attempted"] = self.steps
        return verdict


TASK = ContrastiveTrain
