"""What the per-layer readers take from the program's own recorder.

The program (`vsc22_tpu_torch/utils/observability.py`) records its spans
and counters while a profiler session records in the process, so a
traced window leaves them in `observability.recorded()`:
{"spans": [{"name", "start_ns", "end_ns", "self_ns", "thread", "id",
"parent", "ids"}, ...], "counters": {name: total}}. A program that has no
recorder (one older than it) gives None here, and every reader then
returns None. A reader may be handed a recorder's dict instead (the
benchmark's tests build one by hand).
"""

from __future__ import annotations

SPAN_RANGE = "vsc22::span/"  # the profiler range of a program span


def program_recorded():
    """The program's recorder, or None where the program has none."""
    try:
        from vsc22_tpu_torch.utils import observability
    except ImportError:
        return None
    recorded = getattr(observability, "recorded", None)
    return None if recorded is None else recorded()


def _videos(trace):
    return trace.counts.get("work") or None


def span_ms_per_video(trace, name: str, rec=None):
    """Milliseconds of every span named `name` (its whole duration) per
    video of the window; None where no such span was recorded."""
    rec = program_recorded() if rec is None else rec
    videos = _videos(trace)
    if rec is None or not videos:
        return None
    spans = [s for s in rec["spans"] if s["name"] == name]
    if not spans:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6 / videos


def counter(name: str, rec=None):
    """A counter's total, or None where the program counted nothing under
    that name."""
    rec = program_recorded() if rec is None else rec
    if rec is None:
        return None
    return rec["counters"].get(name)


def counter_per_video(trace, name: str, scale: float = 1.0, rec=None):
    total, videos = counter(name, rec), _videos(trace)
    if total is None or not videos:
        return None
    return total * scale / videos


def gap_ms_per_video(trace, span: str):
    """Milliseconds of the device's idle gaps that end at work launched
    inside the program span `span` or a span whose name extends it
    (`score_norm` holds `score_norm.bias`), per video; None where the
    window holds no such span or no device work at all."""
    label = SPAN_RANGE + span
    videos = _videos(trace)
    if not videos or not trace.busy_ns or not any(c["name"] == label for c in trace.calls):
        return None
    held = f" in {label}"
    return sum(ns for ns, where in trace.gaps if held in where) / 1e6 / videos
