"""One run of one cell: set-up, the measured or traced window, the check.

A run builds the cell's task (`tasks/<task>.py`, named by the
configuration) from the seed, which builds the program, its weights and
its traffic and warms up every shape the traffic uses; that is `setup_s`,
counted from the interpreter's start, less the seconds that the plain
reference takes in it (`task.reference_s`, where a task sets weights from
the reference's readings). Without `--trace` it then runs units of work
(passes, steps) back to back until `--seconds` have passed, the unit in
flight finished and counted, and reports the task's rates over the whole
window (`task.window_metrics`). With `--trace 1` it records the traffic's
`trace_units` units under the profiler instead and reports the cell's
per-layer metrics, each read by `metrics/<name>.py`.

After the window the device's peak memory is read, the task releases the
program's state (a trainer takes its checked step first) and the plain
reference runs; the task's judge compares, each number against its limit
in `limits/<workload>.json`. The last
lines of standard error name each number compared beside its limit, and
the last line of standard output is the result:
{"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}.

A run exits non-zero with no result where there is no CUDA device, or
fewer than the cell asks for, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vsc22_tpu"}


class Refused(Exception):
    """A run that must print no result."""


def forbidden_modules() -> list:
    return sorted(FORBIDDEN & {name.split(".")[0] for name in list(sys.modules)})


def load_benchmark(path: str = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` metrics the cell reports."""
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end":
            out.append(m)
        else:
            moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            if "workloads" not in moved or workload in moved["workloads"]:
                out.append(m)
    return out


def load_limits(workload: str, path: str = None) -> dict:
    """The cell's comparison limits, `limits/<workload>.json`."""
    with open(path or os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def make_task(cfg: dict, traffic: dict, seed: int, device):
    module = importlib.import_module(f"portbench.tasks.{cfg['task']}")
    return module.TASK(cfg, traffic, seed, device)


def build_libraries(names) -> ThreadPoolExecutor:
    """Start building (or loading) the task's kernel libraries, one thread
    each, beside the rest of set-up."""
    from vsc22_tpu_torch.kernels import build

    pool = ThreadPoolExecutor(max_workers=max(len(names), 1))
    pool.futures = [pool.submit(build.library, n) for n in names]
    return pool


def run(args, t0: float) -> dict:
    import torch

    from portbench.tasks import common
    from portbench.traffic import generate
    from portbench.yardstick import trace as tr

    bench = load_benchmark(args.benchmark)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        raise Refused(f"no workload {args.workload!r} in BENCHMARK.json")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
                          f"{cell['chips']}")
    cfg = common.load_config(cell["config"], args.config_file)
    cfg["limits"] = load_limits(args.workload, args.limits_file)
    traffic = generate.load(cell["traffic"], args.traffic_file)
    task = make_task(cfg, traffic, args.seed, device)
    pool = build_libraries(task.libraries) if device.type == "cuda" else None
    try:
        task.setup()
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
            for fut in pool.futures:
                fut.result()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0 - task.reference_s
    print(f"set-up {setup_s:.3f} s (and the reference's {task.reference_s:.3f} s)",
          file=sys.stderr, flush=True)

    metrics, breakdown, dev_extra = {}, None, {}
    work = units = 0
    if args.trace:
        from vsc22_tpu_torch.utils.observability import StageTimer

        timer = StageTimer()
        task.set_timer(timer)
        ranges = tr.ModuleRanges(task.trace_modules())
        done = []

        def window():
            with ranges:
                for _ in range(traffic.get("trace_units", 1)):
                    done.append(task.unit())
                task.finish_window()

        trace = tr.capture(window)
        trace.program_spans = timer.as_dict()
        trace.counts = dict(units=len(done), work=sum(done), rows=dict(ranges.rows),
                            flops=task.flops_per_row())
        units, work = len(done), sum(done)
        for m in cell_metrics(bench, args.workload, "per_layer"):
            value = load_reader(m["name"])(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = dict(busy_s=trace.busy_s, window_s=trace.window_s)
        breakdown = trace.breakdown()
        del trace
    else:
        sync()
        start = time.perf_counter()
        while True:
            work += task.unit()
            units += 1
            if time.perf_counter() - start >= args.seconds:
                break
        task.finish_window()
        sync()
        elapsed = time.perf_counter() - start
        rates = dict(task.window_metrics(work, elapsed), setup_s=setup_s)
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            if m["name"] in rates:
                metrics[m["name"]] = {"value": rates[m["name"]], "unit": m["unit"]}
        print(f"window {elapsed:.3f} s, {units} units, {work} of work",
              file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        raise Refused(f"loaded after the window: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    task.release()
    t_ref = time.perf_counter()
    verdict = task.judge(task.expected())
    print(f"reference and judge {time.perf_counter() - t_ref:.3f} s", file=sys.stderr, flush=True)
    checks = {name: {"value": value, "limit": cfg["limits"][name]}
              for name, value in verdict["readings"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": int(verdict["attempted"]),
        "failed": int(verdict["failed"]),
        "metrics": metrics,
        "device": dict(platform="gpu" if device.type == "cuda" else "cpu", kind=kind,
                       count=cell["chips"], memory_peak_bytes=int(peak), **dev_extra),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise Refused(f"loaded: {', '.join(found)}")
    return result


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # For the benchmark's own CPU tests: another BENCHMARK.json, configuration,
    # traffic or limits file, and the device (a benchmark run passes none of these).
    ap.add_argument("--benchmark", default=None)
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--traffic-file", default=None)
    ap.add_argument("--limits-file", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        result = run(args, t0)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    return 0
