"""Model export: a forward that loads without the model's code.

Counterpart of `vsc22_tpu/utils/export.py` (parity target, the reference's
D1/train/train_v106/torch2scripts.py:672-699: strip the DDP prefix, trace
with a dummy input, save one inference artifact per model). A model export
is two files:
  - `<prefix>.params.npz`: the parameters, written by
    `train/checkpoint.save_ema_snapshot` under the JAX package's flat keys
    and layouts, so that either package's snapshot loads into either
    package's model;
  - `<prefix>.pt2`: the `torch.export` program of the model's forward at
    one input shape and dtype (bfloat16 unless asked otherwise, as in
    JAX), saved with `torch.export.save`.

In PyTorch's idiom the module holds the parameters: the program carries
the weights it was exported with, and `load_exported_with_params` puts a
snapshot's weights in their place. The hand kernels are registered ops
(`ops/library.py`), so a program exported on the card holds one node per
kernel launch (`torch.ops.vsc22.*`), and runs the same kernels, with the
same launch counters, when it is loaded. Exported on the CPU it holds the
plain versions, as the eager model runs them there.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Tuple

import torch
from torch import nn

from vsc22_tpu_torch.ops.library import register_ops
from vsc22_tpu_torch.train.checkpoint import load_params_snapshot, save_ema_snapshot


def export_model(out_prefix: str, model: nn.Module, input_shape: Tuple[int, ...],
                 input_dtype=torch.bfloat16) -> Tuple[str, str]:
    """Write the parameters' npz and the exported forward at `input_shape`
    and `input_dtype` (on the model's device); returns both paths."""
    params_path = f"{out_prefix}.params.npz"
    save_ema_snapshot(params_path, SimpleNamespace(
        params=dict(model.named_parameters()), ema_params=None), model)
    device = next(model.parameters()).device
    example = torch.zeros(input_shape, dtype=input_dtype, device=device)
    with torch.no_grad():
        program = torch.export.export(model, (example,))
    export_path = f"{out_prefix}.pt2"
    torch.export.save(program, export_path)
    return params_path, export_path


def _input_spec(program) -> Tuple[tuple, torch.dtype]:
    """The shape and dtype the program was exported at."""
    (name,) = program.graph_signature.user_inputs
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name)
    val = node.meta["val"]
    return tuple(val.shape), val.dtype


def _checked(module: nn.Module, program) -> Callable:
    """`module(images)` without autograd, for images of the shape and
    dtype `program` was exported at (others raise `ValueError`, where the
    program's own guard would fail with an `AssertionError`); the program
    rides along as `.program`."""
    shape, dtype = _input_spec(program)

    def call(images):
        if tuple(images.shape) != shape or images.dtype != dtype:
            raise ValueError(f"the program was exported for {dtype} images of shape {shape}, "
                             f"not {images.dtype} {tuple(images.shape)}")
        with torch.no_grad():
            return module(images)

    call.program = program
    return call


def load_exported(export_path: str) -> Callable:
    """The exported forward, `fn(images)`, with the weights it was
    exported with. Images of another shape or dtype raise `ValueError`."""
    register_ops()
    program = torch.export.load(export_path)
    return _checked(program.module(), program)


def load_exported_with_params(export_path: str, params_path: str, model: nn.Module) -> Callable:
    """The exported forward with the snapshot's weights bound in place of
    the exported ones: the snapshot fills `model` (a module of the same
    architecture), whose parameters then fill the program's."""
    register_ops()
    program = torch.export.load(export_path)
    load_params_snapshot(params_path, model)
    module = program.module()
    source = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(source[name])
    return _checked(module, program)
