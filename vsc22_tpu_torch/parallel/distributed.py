"""Process-group initialisation and cross-process helpers on torch.distributed.

Counterpart of `vsc22_tpu/parallel/distributed.py`. The reference's
multi-node story is torch.distributed's env-var initialisation
(MASTER_ADDR/PORT/WORLD_SIZE/RANK, train_v68.sh:7) plus dist.barrier()
before rank-0 merges. Here:

  - `maybe_initialize()` reads the environment the JAX twin reads
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or the
    MASTER_ADDR[:MASTER_PORT] / WORLD_SIZE / RANK that `torchrun` sets) and
    forms the world over NCCL on the card, or gloo for `device="cpu"`; it
    does nothing for a world of one, so entry points call it
    unconditionally;
  - `initialize()` forms a world the caller describes (a backend, a size,
    a rank and a store or an init method): a world of one under NCCL, or
    gloo ranks that share one card;
  - `barrier()` and `process_allgather()` are no-ops in a world of one.

Nothing falls back: a card that is missing, a group that cannot form or a
collective that fails raises. `utils/observability.rank()` is this
process's rank.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vsc22_tpu_torch.core.device import resolve


def _env_world():
    """(coordinator "host:port", world size, rank) from the environment,
    each None where it is not set; the JAX names first."""
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    num = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT", "1234")
        coordinator = f"{os.environ['MASTER_ADDR']}:{port}"
        num = os.environ.get("WORLD_SIZE")
        pid = os.environ.get("RANK")
    return coordinator, num, pid


def initialize(
    backend: Optional[str] = None,
    world_size: int = 1,
    rank: int = 0,
    store: Optional[dist.Store] = None,
    init_method: Optional[str] = None,
    device="cuda",
) -> None:
    """Form the default process group: `backend` (NCCL for a CUDA
    `device`, gloo for the CPU, unless named), `world_size` ranks, this
    one `rank`, met through `store` or `init_method` (e.g.
    "tcp://host:port"). For a CUDA device it first selects the card
    LOCAL_RANK names (0 when unset), and raises without one."""
    dev = resolve(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world_size, rank=rank)


def maybe_initialize(device="cuda") -> bool:
    """Form the world from the environment (see the module docstring);
    no-op when it names a single process. Returns True when a
    multi-process world is (already) formed."""
    if dist.is_initialized():
        return True
    coordinator, num, pid = _env_world()
    if not (coordinator and num and pid and int(num) > 1):
        return False
    initialize(world_size=int(num), rank=int(pid), init_method=f"tcp://{coordinator}",
               device=device)
    return True


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (dist.barrier()).
    `name` is the JAX twin's label; torch's barrier takes none."""
    if _world() == 1:
        return
    dist.barrier()


def process_allgather(array: np.ndarray) -> np.ndarray:
    """Gather a per-process array to all processes, stacked on a leading
    axis (index = rank)."""
    if _world() == 1:
        return np.asarray(array)[None]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, np.asarray(array))
    return np.stack(out)
