"""The mesh of ranks and the parameter-sharding rules.

Counterpart of `vsc22_tpu/parallel/mesh.py`. JAX lays its devices on a
`Mesh` with ``data`` and ``model`` axes and lets XLA place collectives;
here one process drives one device, and a `Mesh` lays the world's ranks
on the same named axes, row-major (the last axis varies fastest, so a
rank's model peers are its neighbours), with one process group for each
line of ranks along each axis. The collectives are explicit: the list
forms of all_gather and all_reduce, which NCCL and gloo both take (gloo
on CUDA tensors too).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """The world's ranks on named axes. `shape` maps each axis to its size
    (in axis order); `index(axis)` is this rank's coordinate along it and
    `group(axis)` the process group of its peers there (the ranks whose
    other coordinates are its own), None in a world of one formed by no
    process group, where every collective is the identity."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Optional[dict]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        coords = np.unravel_index(rank, tuple(self.shape.values()))
        self._index = {a: int(c) for a, c in zip(self.axis_names, coords)}
        self._groups = groups or {}

    def index(self, axis: str) -> int:
        return self._index[axis]

    def group(self, axis: str):
        return self._groups.get(axis)

    # -- collectives along one axis ------------------------------------------
    def all_gather(self, x: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every peer's `x` along `axis`, in coordinate order (same shapes)."""
        group = self.group(axis)
        if group is None:
            return [x]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(out, x, group=group)
        return out

    def all_reduce_(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """`x` reduced in place over `axis` ("sum" or "max"); returns it."""
        group = self.group(axis)
        if group is not None:
            dist.all_reduce(x, op=_OPS[op], group=group)
        return x

    def gather_rows(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The peers' `x` concatenated along dim 0, differentiable: the
        gradient of a rank's block is its own block of the incoming one.
        Where every rank computes one replicated function of the whole, a
        rank's parameter gradient is then the part that flows through its
        own rows, and their sum over `axis` is the whole gradient: no
        factor, no collective in the backward."""
        return _GatherRows.apply(x, self, axis)

    # -- model-axis shards of a parameter ------------------------------------
    def take_shard(self, t: torch.Tensor, spec: Tuple) -> torch.Tensor:
        """This rank's block of `t` along the dimension `spec` puts on
        'model' (the whole of `t` where it puts none)."""
        dim = shard_dim(spec)
        if dim is None:
            return t
        n = t.shape[dim] // self.shape["model"]
        return t.narrow(dim, self.index("model") * n, n)

    def gather_shard(self, t: torch.Tensor, spec: Tuple) -> torch.Tensor:
        """The whole tensor from every model peer's `take_shard` block."""
        dim = shard_dim(spec)
        if dim is None:
            return t
        return torch.cat(self.all_gather(t, "model"), dim=dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.rows, ctx.at = x.shape[0], mesh.index(axis)
        return torch.cat(mesh.all_gather(x.detach(), axis))

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.at * ctx.rows : (ctx.at + 1) * ctx.rows], None, None


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
) -> Mesh:
    """A mesh over the world's ranks (one, where no process group is
    formed). Defaults to a 1-D data mesh (model axis of size 1): the
    descriptor models fit one device, so tensor sharding is opt-in via an
    explicit shape like (4, 2). Every rank must call it, in the same order
    as its other group creations: each group is formed by all ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} devices")
    groups = None
    if dist.is_initialized():
        groups = {}
        grid = np.arange(world).reshape(shape)
        for a, name in enumerate(axis_names):
            for line in np.moveaxis(grid, a, -1).reshape(-1, shape[a]).tolist():
                group = dist.new_group(line)
                if rank in line:
                    groups[name] = group
    return Mesh(dict(zip(axis_names, shape)), rank, groups)


def batch_sharding(mesh: Mesh, axis: str = "data"):
    """This rank's rows of a global batch: a function from an array or
    tensor whose leading dim divides by the axis size to this rank's
    contiguous block of it (JAX's NamedSharding(P(axis)))."""
    n, at = mesh.shape[axis], mesh.index(axis)

    def local(x):
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over {n} ranks")
        rows = x.shape[0] // n
        return x[at * rows : (at + 1) * rows]

    return local


def replicated(mesh: Mesh):
    """The replicated placement: every rank holds the whole value."""
    return lambda x: x


# ---------------------------------------------------------------------------
# Tensor-parallel parameter rules for the transformer backbones
# (`vsc22_tpu/parallel/mesh.py:49-98`), on the port's parameter names.
#
# Megatron-style: the QKV / MLP-up projections are column-sharded (output
# dim over 'model'), the attention-out / MLP-down projections row-sharded
# (input dim over 'model'). Anything not matched is replicated. The JAX
# rules read flax paths (`.../qkv/kernel`, `.../fc1_kernel`) and kernels
# [in, out]; the port's names are dotted (`...qkv.weight`, a flat
# `qkv_weight`) and its Linear and conv weights are [out, in, ...], so the
# output dim is dim 0 and the input dim is dim 1.
# ---------------------------------------------------------------------------

_COL_SHARDED = ("qkv", "fc1", "proj")  # 'proj' = GeM head 1x1 projection
_ROW_SHARDED = ("fc2",)  # (attn.proj also row-shards, matched before 'proj')


def _tagged(name: str, tags) -> bool:
    return any(f"{tag}.weight" in name or name.endswith(f"{tag}_weight") for tag in tags)


def infer_param_spec(name: str, value) -> Tuple:
    """A parameter name to its spec: one entry per dim, 'model' on the
    sharded one; () replicates (biases, norms, embeddings)."""
    ndim = getattr(value, "ndim", 0)
    if ndim < 2 or not name.endswith("weight"):
        return ()
    spec = [None] * ndim
    if _tagged(name, _ROW_SHARDED) or "attn.proj.weight" in name:
        spec[1] = "model"
        return tuple(spec)
    if _tagged(name, _COL_SHARDED):
        spec[0] = "model"
        return tuple(spec)
    return ()


def shard_dim(spec: Tuple) -> Optional[int]:
    """The dim a spec puts on 'model', or None."""
    return spec.index("model") if "model" in spec else None


def param_shardings(mesh, params) -> Dict[str, Tuple]:
    """{name: spec} for named parameters (a mapping, or `named_parameters()`
    pairs). A spec whose dim does not divide by the model axis replicates,
    and with a model axis of size 1 (or none) every spec does, so the same
    code serves pure data parallelism."""
    items = list(params.items() if isinstance(params, Mapping) else params)
    nm = mesh.shape.get("model", 1)
    if nm == 1:
        return {name: () for name, _ in items}
    out = {}
    for name, value in items:
        spec = infer_param_spec(name, value)
        dim = shard_dim(spec)
        out[name] = () if dim is not None and value.shape[dim] % nm else spec
    return out
