"""A traced window and what the per-layer readers take from it.

`capture` runs a function under `torch.profiler` (CPU and CUDA activities,
input shapes recorded) and reduces the raw Kineto events to a `Trace`:

- the device's busy intervals (kernels and copies; the profiler's GPU user
  annotations are not work), their union and the window's length;
- each device interval's launching CPU op (Kineto links a GPU activity to
  the op that was innermost on the launching thread), and so every range
  that holds that op on its thread: the benchmark's own `portbench::`
  ranges, the program's `vsc22::` custom ops (with their input shapes and
  dtypes) and autograd's backward functions.

Device time is attributed by op and by range, never by kernel name, so a
kernel that changes its name or is merged into another is still counted
where its work is.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List

import torch

RANGE_PREFIXES = ("portbench::", "vsc22::", "autograd::engine::evaluate_function")
# Records that are neither ops nor device work: CUPTI's markers of a full
# launch queue and of its own buffer requests and flushes, and CUDA runtime
# and driver calls (`cudaLaunchKernel`, `cuLaunchKernelEx`), whose correlation ids are
# CUPTI's and must not be taken for an op's.
NOT_OPS = re.compile(r"^(Command Buffer Full|Buffer Flush|Activity Buffer|cuda[A-Z]|cu[A-Z])")


class Trace:
    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.program_spans: Dict[str, float] = {}  # the program's own stage seconds
        self.counts: dict = {}  # what the window did (units, rows per range label)
        ops = {}  # correlation id -> (name, thread, start ns)
        ranges = defaultdict(lambda: defaultdict(list))  # prefix -> thread -> [(start, end, idx)]
        self.calls: List[dict] = []  # every range: name, shapes, dtypes, device ns
        device = []
        for e in events:
            name = e.name()
            if NOT_OPS.match(name):
                continue
            if e.device_type() == DeviceType.CPU:
                thread, start = e.start_thread_id(), e.start_ns()
                ops[e.correlation_id()] = (name, thread, start)
                prefix = next((p for p in RANGE_PREFIXES if name.startswith(p)), None)
                if prefix is not None:
                    ranges[prefix][thread].append((start, e.end_ns(), len(self.calls)))
                    shapes = e.shapes() if prefix == "vsc22::" else []
                    dtypes = e.dtypes() if prefix == "vsc22::" else []
                    self.calls.append(dict(name=name, shapes=shapes, dtypes=dtypes, device_ns=0))
            elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), name, e.linked_correlation_id()))
        for per_thread in ranges.values():
            for spans in per_thread.values():
                spans.sort()
        self.device_op_ns: Dict[str, int] = defaultdict(int)
        intervals = []
        for start, end, kname, link in device:
            dur = max(end - start, 0)
            intervals.append((start, end, link))
            op = ops.get(link)
            if op is None:
                self.device_op_ns["(unlinked) " + kname[:60]] += dur
                continue
            name, thread, at = op
            self.device_op_ns[name] += dur
            for prefix in RANGE_PREFIXES:
                for idx in _holding(ranges[prefix].get(thread, ()), at):
                    self.calls[idx]["device_ns"] += dur
        intervals.sort()
        self.busy_ns, gaps = _union(intervals)
        self.gaps = [(ns, self._where(ops.get(link), ranges)) for ns, link in gaps]

    def _where(self, op, ranges) -> str:
        """'before <op> [in <range>]': what the device waited for after a gap."""
        if op is None:
            return "before an unlinked op"
        name, thread, at = op
        for prefix in RANGE_PREFIXES:
            held = _holding(ranges[prefix].get(thread, ()), at)
            if held and self.calls[held[0]]["name"] != name:
                return f"before {name} in {self.calls[held[0]]['name']}"
        return f"before {name}"

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def ranges_device_s(self, prefix: str) -> float:
        """Device seconds launched inside the ranges whose names start with `prefix`."""
        return sum(c["device_ns"] for c in self.calls if c["name"].startswith(prefix)) / 1e9

    def op_calls(self, name: str) -> List[dict]:
        return [c for c in self.calls if c["name"] == name]

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.device_op_ns.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps, key=lambda g: -g[0])[:n]
        return {"device_ops": [[name, ns / 1e9] for name, ns in ops],
                "idle_gaps": [[name, ns / 1e9] for ns, name in gaps]}


def _holding(spans, at: int):
    """The index of the span (sorted by start; spans of one prefix on one
    thread do not overlap) that holds time `at`, as a list of none or one."""
    i = bisect.bisect_right(spans, (at, float("inf"), 0)) - 1
    if i >= 0 and spans[i][1] >= at:
        return [spans[i][2]]
    return []


def _union(intervals):
    """(ns covered by the union of sorted (start, end, link) intervals, the
    idle gaps between them as (ns, the link of the work after the gap))."""
    busy, gaps = 0, []
    cur_start = cur_end = None
    for start, end, link in intervals:
        if cur_end is None:
            cur_start, cur_end = start, end
        elif start > cur_end:
            busy += cur_end - cur_start
            gaps.append((start - cur_end, link))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy, gaps


def capture(run) -> Trace:
    """`run()` under the profiler, the device synchronised at both ends."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, record_shapes=True) as prof:
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        window_s = time.perf_counter() - t0
    return Trace(prof.profiler.kineto_results.events(), window_s)


class ModuleRanges:
    """Forward hooks that open a `portbench::<label>` profiler range around
    each call of the given modules and count the rows (the first input's
    leading dimension) each label's modules were called on."""

    def __init__(self, modules: Dict[str, list]):
        self.modules = modules
        self.rows: Dict[str, int] = defaultdict(int)
        self._handles = []
        self._open: Dict[int, list] = defaultdict(list)

    def __enter__(self):
        from torch.autograd.profiler import record_function

        for label, mods in self.modules.items():
            for m in mods:
                def pre(mod, args, label=label):
                    self.rows[label] += int(args[0].shape[0])
                    rf = record_function("portbench::" + label)
                    rf.__enter__()
                    self._open[id(mod)].append(rf)

                def post(mod, args, out):
                    self._open[id(mod)].pop().__exit__(None, None, None)

                self._handles.append(m.register_forward_pre_hook(pre))
                self._handles.append(m.register_forward_hook(post))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles.clear()
        return False
