"""Differentiable kernels: the forward on the hand kernel, the backward
recomputed through the kernel's plain version.

Counterpart of the `_fwd`/`_bwd` pairs of the JAX ops: each Pallas
kernel there is a `jax.custom_vjp` whose forward saves only its inputs
(`residuals`) and whose backward is `jax.vjp` of the plain XLA function on
them. No JAX backward is a Pallas kernel, so here the backward is autograd
through the plain PyTorch version, on the device of the inputs. Arguments
past the tensors (heads, activation, eps, window count) get no gradient,
as JAX's `nondiff_argnums`.

On a CPU tensor the wrappers call the plain version directly and
autograd differentiates it; `recompute_vjp` is for the CUDA path only.
"""

from __future__ import annotations

import torch


def recompute_vjp(kernel, plain, n_tensors: int):
    """`kernel(*args)` (on the card, a kernel's registered op) made
    differentiable: a `torch.autograd.Function` whose forward runs
    `kernel` and saves the first `n_tensors` arguments, and whose backward
    re-enters autograd, runs `plain(*args)` on detached copies of them and
    returns `torch.autograd.grad` of it against the incoming cotangent. The returned function calls `kernel` alone (no
    graph, nothing saved) unless grad mode is on and one of the tensors
    requires grad."""

    class _Recompute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.static = args[n_tensors:]
            ctx.save_for_backward(*args[:n_tensors])
            return kernel(*args)

        @staticmethod
        def backward(ctx, g):
            need = ctx.needs_input_grad[:n_tensors]
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            with torch.enable_grad():
                out = plain(*ins, *ctx.static)
            wrt = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
            return (*(next(grads) if n else None for n in need), *([None] * len(ctx.static)))

    # a plain function, or a kernel registered as an op (`ops/library.py`)
    _Recompute.__name__ = f"{getattr(kernel, '__name__', None) or kernel._name}_vjp"

    def call(*args):
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad for a in args[:n_tensors]):
            return _Recompute.apply(*args)
        return kernel(*args)

    return call


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and a tensor requires grad: the kernel
    `name` has no VJP, as its JAX `pallas_call` has none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is not differentiable (the JAX kernel has no VJP either): call it on "
            "tensors that do not require grad, or under torch.no_grad()")
