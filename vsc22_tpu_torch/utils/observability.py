"""Observability: process-0 logging, stage timing, device traces.

Counterpart of `vsc22_tpu/utils/observability.py`:
  - `setup_logging`: stream (+ file) logging on process 0 only, where the
    process index is `torch.distributed`'s rank when it is initialised;
  - `StageTimer`: accumulated wall-clock seconds per named stage, with an
    optional synchronisation at both edges of each stage (pass
    `torch.cuda.synchronize` to time the card's work rather than its
    launches);
  - `device_trace`: a `torch.profiler` window (CPU and, where there is a
    card, CUDA activity) written as a Chrome trace (Perfetto, chrome://tracing);
  - `annotate`: a named region in that trace (`record_function`), and an
    NVTX range when CUDA is present.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional

import torch


def rank() -> int:
    """This process's rank where `torch.distributed` is initialised, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def setup_logging(
    name: str = "vsc22",
    work_dir: Optional[str] = None,
    level: int = logging.INFO,
    process_index: Optional[int] = None,
) -> logging.Logger:
    """Stream (+ optional `work_dir/log.txt`) logging on process 0 only."""
    if process_index is None:
        process_index = rank()
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    if process_index != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter("[%(levelname)s: %(asctime)s] %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if work_dir:
        os.makedirs(work_dir, exist_ok=True)
        fh = logging.FileHandler(f"{work_dir}/log.txt")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class StageTimer:
    """Accumulates wall-clock per named stage; `report()` summarizes.
    `sync`, where given, is called at both edges of every stage. Stages
    may run on several threads at once (the batched pipeline's worker
    times its half beside the caller's): the sums are taken under a lock."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if self.sync is not None:
            self.sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            elapsed = time.perf_counter() - start
            with self._lock:
                self.totals[name] += elapsed
                self.counts[name] += 1

    def report(self) -> str:
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        lines = []
        for name in sorted(totals, key=lambda n: -totals[n]):
            total = totals[name]
            count = counts[name]
            lines.append(f"{name}: {total:.3f}s total, {count} calls, {total / count:.4f}s/call")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """A `torch.profiler` window over the block, written to
    `log_dir/trace.json` (Chrome trace format) when it ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a device trace (and an NVTX range on CUDA)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
