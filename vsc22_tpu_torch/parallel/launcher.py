"""Local multi-process launcher.

Counterpart of `vsc22_tpu/parallel/launcher.py`, kept as the port's own
copy (the port imports nothing of the JAX package). Reference contract:
D1/infer/vsc/baseline/inference.py:81-150, the Meta harness's spawn
launcher: N worker processes, each given (rank, world_size), joined with
exit-code checks and a kill-all cleanup on failure.

It starts the ranks of a local `torch.distributed` world (`parallel/
dryrun.py`, the tests) and the host-side stages that want process
parallelism. Workers receive (process_index, process_count) and shard
their inputs by that.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def _worker(fn, index, count, args, queue):
    try:
        result = fn(index, count, *args)
        queue.put((index, "ok", result))
    except Exception:
        queue.put((index, "error", traceback.format_exc()))


def launch_local(
    fn: Callable,
    num_processes: int,
    args: Sequence[Any] = (),
    timeout: Optional[float] = None,
) -> List[Any]:
    """Run fn(process_index, process_count, *args) in N processes.

    Returns results ordered by process index. Any worker failure terminates
    the rest and raises — matching the reference's join + exitcode +
    kill-all contract (inference.py:111-120), which also catches workers
    that die *without* raising (segfault, OOM-kill): a dead process with a
    nonzero exitcode and no delivered result is reported as a crash.
    `timeout` is a single global deadline for all workers, not per-result.
    """
    if num_processes == 1:
        return [fn(0, 1, *args)]

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [
        ctx.Process(target=_worker, args=(fn, i, num_processes, tuple(args), queue))
        for i in range(num_processes)
    ]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    results: dict = {}
    try:
        while len(results) < num_processes:
            try:
                index, status, payload = queue.get(timeout=0.2)
            except queue_mod.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    missing = sorted(set(range(num_processes)) - set(results))
                    raise TimeoutError(
                        f"workers {missing} missed the {timeout}s deadline"
                    )
                for i, p in enumerate(procs):
                    if i not in results and not p.is_alive() and p.exitcode:
                        raise RuntimeError(
                            f"worker {i} died with exit code {p.exitcode} "
                            "without reporting a result"
                        )
                continue
            if status == "error":
                raise RuntimeError(f"worker {index} failed:\n{payload}")
            results[index] = payload
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
    return [results[i] for i in range(num_processes)]
