"""Checkpoints, resume, and inference snapshots.

Counterpart of `vsc22_tpu/train/checkpoint.py`. `CheckpointManager` keeps
the last `max_to_keep` train states under one directory with
`torch.save`: the step, the f32 master parameters, the Adam moments and
count, the EMA, and the state of the generator that draws the dropout
masks (of each rank's, in a multi-process run), so that a resumed run goes
on bit for bit as an unbroken one.

Snapshots are the JAX package's npz files: `save_ema_snapshot` writes the
EMA (or the parameters) under the flat `/`-joined keys and in the layouts
of `vsc22_tpu.train.checkpoint.save_ema_snapshot` (a BatchNorm model's
running statistics beside them, under `batch_stats/...`), and
`save_cnn_snapshot` a BatchNorm CNN's `params/...` and `batch_stats/...`
as its `save_cnn_snapshot` does; the `load_*` functions read either
side's files into a port model (`utils/jax_params.py` holds the key
tables).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from vsc22_tpu_torch.train.contrastive import AdamState, TrainState
from vsc22_tpu_torch.utils import jax_params
from vsc22_tpu_torch.utils.observability import rank

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Train states as `ckpt_<step>.pt` files under `directory`, the newest
    `max_to_keep` kept."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.pt")

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, generator=None) -> None:
        """Write `state` (and `generator`'s state: a `torch.Generator`, or
        every rank's generator state in rank order) as step `step`, then
        drop the oldest files past `max_to_keep`. The file appears whole or
        not at all."""
        if isinstance(generator, torch.Generator):
            generator = generator.get_state()
        elif generator is not None:
            generator = torch.stack(list(generator))
        blob = {
            "step": state.step,
            "params": state.params,
            "opt": {"count": state.opt_state.count, "mu": state.opt_state.mu,
                    "nu": state.opt_state.nu},
            "ema_params": state.ema_params,
            "generator": generator,
        }
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state_template: TrainState, step: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> TrainState:
        """The state saved at `step` (the latest unless given), each tensor
        on its template tensor's device; `generator`, where given, is set
        to the saved generator state (this process's rank's, where the file
        holds every rank's)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)

        def place(saved: dict, template: dict) -> dict:
            if set(saved) != set(template):
                raise ValueError("the checkpoint's parameters differ from the template's")
            return {k: v.to(template[k].device) for k, v in saved.items()}

        def place_list(saved: list, template: list) -> list:
            return [v.to(t.device) for v, t in zip(saved, template)]

        tmpl_opt = state_template.opt_state
        opt = AdamState(blob["opt"]["count"], place_list(blob["opt"]["mu"], tmpl_opt.mu),
                        place_list(blob["opt"]["nu"], tmpl_opt.nu))
        ema = None
        if blob["ema_params"] is not None:
            ema = place(blob["ema_params"], state_template.ema_params or state_template.params)
        if generator is not None and blob["generator"] is not None:
            saved = blob["generator"]
            # a row of the stacked states is a view: set_state takes a tensor of its own
            generator.set_state(saved if saved.ndim == 1 else saved[rank()].clone())
        return TrainState(blob["step"], place(blob["params"], state_template.params), opt, ema)


def save_ema_snapshot(path: str, state: TrainState, model) -> None:
    """The EMA (or, without one, the master) parameters of `state` as the
    JAX package's flat npz inference checkpoint of `model`."""
    params = state.ema_params if state.ema_params is not None else state.params
    by_id = {id(p): params[name] for name, p in model.named_parameters()}
    np.savez(path, **jax_params.jax_flat_params(jax_params.model_entries(model), by_id))


@torch.no_grad()
def load_params_snapshot(path: str, model) -> dict:
    """Inverse of `save_ema_snapshot` (either package's file): fill
    `model`'s parameters, and the running statistics of its BatchNorms
    (the file's `batch_stats/...`, which the JAX `query_cli` reads with the
    rest of a BatchNorm member's variables), and return the parameters as
    f32 tensors by parameter name, as `create_train_state(params=...)`
    takes them."""
    tree = jax_params.npz_tree(path)
    masters = {name: torch.empty(p.shape, dtype=torch.float32)
               for name, p in model.named_parameters()}
    by_id = {id(p): masters[name] for name, p in model.named_parameters()}
    entries = [(key, by_id.get(id(t), t), layout)
               for key, t, layout in jax_params.model_entries(model, tree)]
    jax_params.load_entries(entries, tree)
    for name, p in model.named_parameters():
        p.copy_(masters[name])
    return masters


def save_cnn_snapshot(path: str, model) -> None:
    """A BatchNorm CNN's (`MobileNetV3Small`, `SAMHRNet`, `EfficientNet`,
    `DeConvModel`) `params/...` and `batch_stats/...` as the JAX package's
    flat npz."""
    np.savez(path, **jax_params.jax_flat_params(jax_params.model_entries(model)))


@torch.no_grad()
def load_cnn_snapshot(path: str, model):
    """Inverse of `save_cnn_snapshot` (either package's file) into `model`."""
    tree = jax_params.npz_tree(path)
    jax_params.load_entries(jax_params.model_entries(model, tree), tree)
    return model
