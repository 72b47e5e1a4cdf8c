"""The port's span primitive (`vsc22_tpu_torch/utils/observability.py`): a
span records nothing with no profiler and no `recording()` block, and one
record (and a `vsc22::span/<name>` range in the profiler's trace) under
either; its recorded start and end lie on the clock of the profiler's
events; parents and self time of nested spans; counters under the same
gate; a `StageTimer` stage is a span. Imports neither JAX nor the JAX
package, so it runs on the card too (`--noconftest`), where the profiler
also records CUDA activity.
"""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vsc22_tpu_torch.utils import observability as obs

CLOCK_TOL_NS = 1_000_000  # 1 ms between a recorded edge and its profiler event's


@pytest.fixture(autouse=True)
def empty_recorder():
    obs.reset()
    yield
    obs.reset()


def activities():
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])


def events(prof, prefix=obs.SPAN_PREFIX):
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith(prefix)]


def test_span_records_nothing_without_a_profiler():
    with obs.span("idle", batch=1):
        obs.count("rows", 3)
    assert obs.recorded() == {"spans": [], "counters": {}}
    # untimed and unrecorded: the one shared null context, nothing built
    assert obs.span("a") is obs.span("b", batch=2)


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_span_records_under_a_profiler_and_under_recording(mode):
    timer = obs.StageTimer()
    if mode == "profiler":
        with profile(activities=activities()) as prof:
            with timer.stage("outer", batch=2):
                obs.count("rows", 5)
                obs.count("rows", 2)
        assert [e.name() for e in events(prof)] == ["vsc22::span/outer"]
    else:
        with obs.recording():
            with timer.stage("outer", batch=2):
                obs.count("rows", 5)
                obs.count("rows", 2)
    with obs.span("after"):  # the session or block is over: not recorded
        obs.count("rows", 1)
    rec = obs.recorded()
    (s,) = rec["spans"]
    assert s["name"] == "outer" and s["ids"] == {"batch": 2} and s["parent"] is None
    assert s["thread"] == threading.get_ident()
    assert rec["counters"] == {"rows": 7}
    assert timer.counts["outer"] == 1 and timer.totals["outer"] >= 0.0


def test_span_edges_are_on_the_profilers_clock():
    """Each recorded start and end lies within 1 ms of its range's event in
    the profiler's trace, which is what lets a reader set spans beside
    kernels."""
    with profile(activities=activities()) as prof:
        for i in range(3):
            with obs.span(f"edge{i}"):
                torch.ones(64).sum()
                time.sleep(0.002)
    by_name = {e.name(): e for e in events(prof)}
    spans = obs.recorded()["spans"]
    assert len(spans) == 3
    for s in spans:
        e = by_name[obs.SPAN_PREFIX + s["name"]]
        assert abs(s["start_ns"] - e.start_ns()) < CLOCK_TOL_NS, (s, e.start_ns())
        assert abs(s["end_ns"] - e.end_ns()) < CLOCK_TOL_NS, (s, e.end_ns())


def test_nested_spans_give_parent_and_self_time():
    """The inner span's parent is the outer one; the outer's self time is
    its duration less the inner's. A span on another thread opened while
    the outer is open has no parent: the stack is per thread."""
    other = []

    def elsewhere():
        with obs.span("other"):
            other.append(threading.get_ident())

    with obs.recording():
        with obs.span("outer"):
            time.sleep(0.01)
            with obs.span("inner", batch=0):
                time.sleep(0.02)
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    spans = {s["name"]: s for s in obs.recorded()["spans"]}
    outer, inner, away = spans["outer"], spans["inner"], spans["other"]
    dur = lambda s: s["end_ns"] - s["start_ns"]  # noqa: E731
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert away["parent"] is None and away["thread"] == other[0] != outer["thread"]
    assert inner["self_ns"] == dur(inner) >= 20_000_000
    assert outer["self_ns"] == dur(outer) - dur(inner)
    assert 10_000_000 <= outer["self_ns"] < dur(outer)
