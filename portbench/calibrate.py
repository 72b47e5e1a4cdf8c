"""The readings that a cell's comparison limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... [--units 1] \
        [--controls fp8 half_batch] [--control-seeds 3] [--out readings.jsonl]

For each seed: the program's set-up, `--units` units of work (passes,
steps) as a window would run them, the program's state freed as after a
window, then the plain reference and the judge, as a run does: the lower
readings. On the first `--control-seeds` seeds also each control, judged
against the same float32 reference: "fp8" is the reference computed in
float8 e4m3 (the precision below the configuration's bfloat16),
"half_batch" the reference trainer with half of every batch left out.
Their readings are the upper ones. One JSON line per reading set. Not part
of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.tasks import common  # noqa: E402
from portbench.traffic import generate  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--controls", nargs="*", default=["fp8"])
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--benchmark", default=None)
    ap.add_argument("--config-file", default=None)
    ap.add_argument("--traffic-file", default=None)
    ap.add_argument("--limits-file", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = harness.load_benchmark(args.benchmark)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = common.load_config(cell["config"], args.config_file)
    cfg["limits"] = harness.load_limits(args.workload, args.limits_file)
    traffic = generate.load(cell["traffic"], args.traffic_file)
    out = open(args.out, "a") if args.out else None
    built = False
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        task = harness.make_task(cfg, traffic, seed, args.device)
        if args.device == "cuda" and not built:
            harness.build_libraries(task.libraries).shutdown(wait=True)
            built = True
        task.setup()
        for _ in range(args.units):
            task.unit()
        task.finish_window()
        task.release()
        exp = task.expected()
        lines = [dict(variant="program", verdict=task.judge(exp))]
        if k < args.control_seeds:
            for control in args.controls:
                other = (task.expected("fp8") if control == "fp8"
                         else task.expected("f32", half_batch=True))
                lines.append(dict(variant=control,
                                  verdict=task.judge(exp, task.control_answers(other))))
        for line in lines:
            line.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
            text = json.dumps(line, default=float)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
        del task, exp
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
