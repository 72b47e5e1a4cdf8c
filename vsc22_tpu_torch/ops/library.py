"""The hand kernels that the models' forwards reach, and K3, as registered
torch ops.

Each wrapper's CUDA launch (`_*_cuda` in `attn_proj.py`, `mlp.py`,
`swin_block.py`, `window_attn.py`, `attn.py`, `vit_block.py`, `sim.py`) is
a `torch.library.custom_op` in the `vsc22` namespace, registered for CUDA
tensors only, with a fake implementation that gives its output's shape
and dtype. So a graph capture (`torch.export`, `utils/export.py`) keeps
each launch as one node, `torch.ops.vsc22.<name>`, where a ctypes call on
raw pointers would be opaque to it, and a profiler's trace holds each
launch's op with its shapes and device time. The launch itself, its checks
and its counter are unchanged: the wrapper still takes the plain version
for a CPU tensor and raises for any device but CUDA before it calls the op
(whose fake implementation takes any device), and the op itself has a
kernel for CUDA tensors only.

K3 (`sim.row_max_gemm`, op `vsc22::row_max`) is score-norm's kernel, so
it is an op for the trace's sake. B5 (`topk.extract_topk`), the search's,
stays a plain ctypes call.
"""

from __future__ import annotations

import importlib

import torch

NAMESPACE = "vsc22"

# The modules that register an op, each by importing it.
OP_MODULES = ("attn", "attn_proj", "mlp", "sim", "swin_block", "vit_block", "window_attn")

OPS: dict = {}  # "vsc22::<name>" -> its op, as registered


def kernel_op(name: str, launch, fake=None):
    """`launch` (a kernel's CUDA launch, its arguments annotated) as the op
    `vsc22::<name>`, whose fake implementation is `fake`, or by default
    returns an empty tensor like its first argument (most kernels' output
    has their first operand's shape and dtype)."""
    qualname = f"{NAMESPACE}::{name}"
    op = torch.library.custom_op(qualname, launch, mutates_args=(), device_types="cuda")
    op.register_fake(fake or (lambda first, *rest: torch.empty_like(first)))
    OPS[qualname] = op
    return op


def register_ops() -> None:
    """Import every module that registers an op (what `torch.export.load`
    needs before it reads a program that holds one)."""
    for name in OP_MODULES:
        importlib.import_module(f"vsc22_tpu_torch.ops.{name}")
