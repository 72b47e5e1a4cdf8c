"""Observability: process-0 logging, spans and counters, stage timing,
device traces.

Counterpart of `vsc22_tpu/utils/observability.py`:
  - `setup_logging`: stream (+ file) logging on process 0 only, where the
    process index is `torch.distributed`'s rank when it is initialised;
  - `span(name, timer=None, **ids)`: a named region of the program. It adds
    its host seconds to `timer` where one is given. While a
    `torch.profiler` session records in this process, or inside
    `recording()`, it is also a `vsc22::span/<name>` range in the
    profiler's trace (its ids as the range's argument) and one record in
    the process recorder: its name, start and end on the profiler's clock
    (`time.time_ns()`, the clock of Kineto's event times), thread, parent
    span on that thread and ids. Otherwise it costs one flag check.
    A profiler session traces the ranges of the thread that started it
    (of every thread with `profile_all_threads`, as `device_trace` sets);
    the recorder holds the spans of every thread;
  - `count(name, n)`: a counter in the same recorder, under the same gate;
    `recorded()` gives the spans, each with its self time (its duration
    less what its child spans cover), and the counters; `reset()` empties
    the recorder;
  - `StageTimer`: accumulated wall-clock seconds per named stage, each
    stage a span, with an optional synchronisation at both edges of each
    stage (pass `torch.cuda.synchronize` to time the card's work rather
    than its launches); `NullTimer`, the timer of a caller given none,
    whose stages are bare spans;
  - `device_trace`: a `torch.profiler` window (CPU and, where there is a
    card, CUDA activity) written as a Chrome trace (Perfetto,
    chrome://tracing), spans included.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

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


SPAN_PREFIX = "vsc22::span/"

_profiler = torch.autograd.profiler  # `_is_profiler_enabled` follows every session
_recording = 0  # open `recording()` blocks
_lock = threading.Lock()
_spans: List[dict] = []
_counters: Dict[str, int] = defaultdict(int)
_span_ids = itertools.count()
_open = threading.local()  # each thread's stack of open recorded span ids
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans and counters record inside the block, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


class _Span:
    __slots__ = ("name", "timer", "ids", "record", "t0", "start_ns", "sid", "parent",
                 "stack", "range")

    def __init__(self, name: str, timer, ids: dict, record: bool):
        self.name, self.timer, self.ids, self.record = name, timer, ids, record

    def __enter__(self):
        if self.record:
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            self.parent = stack[-1] if stack else None
            self.sid = next(_span_ids)
            stack.append(self.sid)
            self.stack = stack
            args = ",".join(f"{k}={v}" for k, v in self.ids.items()) or None
            self.range = torch.profiler.record_function(SPAN_PREFIX + self.name, args)
            self.range.__enter__()
            self.start_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self.t0
        if self.record:
            end_ns = time.time_ns()
            self.range.__exit__(*exc)
            self.stack.pop()
            rec = dict(name=self.name, start_ns=self.start_ns, end_ns=end_ns,
                       thread=threading.get_ident(), id=self.sid, parent=self.parent,
                       ids=self.ids)
            with _lock:
                _spans.append(rec)
        if self.timer is not None:
            self.timer.add(self.name, elapsed)
        return False


def span(name: str, timer=None, **ids):
    """A named region (see the module docstring): its host seconds go to
    `timer` (anything with `add(name, seconds)`) where one is given; it
    records only while a profiler session or `recording()` is open."""
    if _recording or _profiler._is_profiler_enabled:
        return _Span(name, timer, ids, True)
    if timer is None:
        return _NULL
    return _Span(name, timer, ids, False)


def count(name: str, n) -> None:
    """Add `n` to the recorder's counter `name` while a profiler session or
    `recording()` is open."""
    if _recording or _profiler._is_profiler_enabled:
        with _lock:
            _counters[name] += int(n)


def recorded() -> dict:
    """{"spans": [...], "counters": {name: total}}: every span closed
    since the last `reset()`, by start, each a dict of name, start_ns,
    end_ns, self_ns, thread, id, parent (the id of the span that held it
    on its thread, or None) and ids."""
    with _lock:
        spans = [dict(s) for s in _spans]
        counters = dict(_counters)
    child_ns: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s["parent"] is not None:
            child_ns[s["parent"]] += s["end_ns"] - s["start_ns"]
    for s in spans:
        s["self_ns"] = s["end_ns"] - s["start_ns"] - child_ns[s["id"]]
    spans.sort(key=lambda s: s["start_ns"])
    return dict(spans=spans, counters=counters)


def reset() -> None:
    """Empty the recorder."""
    with _lock:
        _spans.clear()
        _counters.clear()


class StageTimer:
    """Accumulates wall-clock per named stage; `report()` summarizes.
    Each stage is a `span` (with the given ids). `sync`, where given, is
    called at both edges of every stage. Stages may run on several
    threads at once (the batched pipeline's worker times its half beside
    the caller's): the sums are taken under a lock."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    @contextlib.contextmanager
    def stage(self, name: str, **ids) -> Iterator[None]:
        if self.sync is not None:
            self.sync()
        with span(name, self, **ids):
            try:
                yield
            finally:
                if self.sync is not None:
                    self.sync()

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


class NullTimer:
    """The timer of a caller that was given none: its stages are bare spans."""

    def stage(self, name: str, **ids):
        return span(name, **ids)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """A `torch.profiler` window over the block, written to
    `log_dir/trace.json` (Chrome trace format) when it ends. Every thread's
    ranges are traced (`profile_all_threads`), so the spans of a worker
    thread show too."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
