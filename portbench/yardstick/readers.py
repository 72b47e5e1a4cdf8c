"""What the per-layer metric files compute from a `trace.Trace`.

Each returns None where the window gave it nothing to read (no call of the
op, no range), and never 0 for a share of a roofline or of a peak.
"""

from __future__ import annotations

from portbench.yardstick.roofline import PEAK_FLOPS, bound_s, work_mlp, work_swin_block

DTYPE_CODES = {"c10::BFloat16": "bf16", "c10::Half": "f16", "float": "f32"}


def _per(value: float, count) -> float:
    return None if not count else value / count


def device_ms_per(trace, prefix: str, per: str):
    """Device milliseconds launched inside the ranges named `prefix`*, per
    unit of `per` ("videos", "steps")."""
    if not any(c["name"].startswith(prefix) for c in trace.calls):
        return None
    count = trace.counts["work"] if per == "videos" else trace.counts["units"]
    return _per(1e3 * trace.ranges_device_s(prefix), count)


def program_span_ms_per(trace, stage: str):
    """The program's own stage timer, milliseconds per unit of work."""
    if stage not in trace.program_spans:
        return None
    return _per(1e3 * trace.program_spans[stage], trace.counts["work"])


def _swin_block_work(shapes, isz):
    w, n, c = shapes[0]
    f = shapes[7][0]
    h = shapes[13][0]
    nw = shapes[15][0]
    return work_swin_block(w, n, c, h, f, nw, isz)


def _ln_mlp_work(shapes, isz):
    m, c = shapes[0]
    return work_mlp(m, c, shapes[3][0], isz)


WORK = {"vsc22::swin_block": _swin_block_work, "vsc22::ln_mlp_residual": _ln_mlp_work}


def roofline_share(trace, op: str):
    """100 x the least time the card needs for every call of `op` in the
    window (each call's bound from its shapes and dtype) over the device
    time of those calls."""
    calls = [c for c in trace.op_calls(op) if c["device_ns"] > 0]
    if not calls:
        return None
    bound = 0.0
    for c in calls:
        dtype = DTYPE_CODES[c["dtypes"][0]]
        bound += bound_s(*WORK[op](c["shapes"], 2 if dtype in ("bf16", "f16") else 4), dtype)
    return 100.0 * bound / (sum(c["device_ns"] for c in calls) / 1e9)


def idle_share(trace):
    """100 x the share of the traced window in which no kernel or copy ran."""
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mfu(trace, passes: int = 1):
    """100 x the model FLOPs of the window (forward FLOPs of each ranged
    module x the rows it was called on, x `passes`: 3 for a training step,
    forward and backward) over the window at the bf16 dense peak."""
    flops = sum(trace.counts["rows"].get(label, 0) * f
                for label, f in trace.counts["flops"].items())
    if not flops:
        return None
    return 100.0 * passes * flops / trace.window_s / PEAK_FLOPS["bf16"]
