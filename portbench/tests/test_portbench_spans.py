"""The readers of the program's spans and counters (`yardstick/spans.py` and
the five metrics that use it) on hand-built recorders and traces, None
where their span or counter is absent; the program's `vsc22::span/` ranges
leave what the trace gives the other readers as it was; and the tiny query
cell's traced run reporting the new metrics."""

import json
import os

import pytest
from torch.autograd import DeviceType

from portbench import harness
from portbench.yardstick import readers, spans, trace

HERE = os.path.dirname(os.path.abspath(__file__))
NEW = ("scorenorm_host_ms_per_video.query", "scorenorm_idle_ms_per_video.query",
       "gate_wait_ms_per_video.query", "h2d_mb_per_video.query", "fsd_flagged_share.query")


class Ev:
    """A Kineto event as `trace.Trace` reads one."""

    def __init__(self, name, start, end, corr=0, link=0, cpu=True, thread=1):
        self._n, self._s, self._e = name, start, end
        self._c, self._l, self._cpu, self._t = corr, link, cpu, thread

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CPU if self._cpu else DeviceType.CUDA

    def start_thread_id(self):
        return self._t

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def shapes(self):
        return [[4, 8]]

    def dtypes(self):
        return ["float"]

    def is_user_annotation(self):
        return False


def events(with_spans: bool):
    """One thread: an extract member's range holding a K2 call and a copy;
    score-norm's spans, its operand copy and K3; the device's work."""
    ops = [Ev("portbench::extract/v68", 150, 900, corr=1),
           Ev("vsc22::ln_mlp_residual", 200, 300, corr=10),
           Ev("aten::copy_", 400, 410, corr=11),
           Ev("aten::copy_", 3100, 3200, corr=12),
           Ev("vsc22::row_max", 3300, 3400, corr=13)]
    span_ranges = [Ev("vsc22::span/preprocess_384", 100, 1000, corr=2),
                   Ev("vsc22::span/score_norm", 2000, 5000, corr=3),
                   Ev("vsc22::span/score_norm.prepare", 2010, 3000, corr=4),
                   Ev("vsc22::span/score_norm.bias", 3000, 4900, corr=5)]
    device = [Ev("ln_mlp_kernel", 500, 600, link=10, cpu=False),
              Ev("Memcpy HtoD", 650, 700, link=11, cpu=False),
              Ev("Memcpy HtoD", 3500, 3600, link=12, cpu=False),
              Ev("row_max_kernel", 3700, 3800, link=13, cpu=False)]
    return ops + (span_ranges if with_spans else []) + device


def make_trace(with_spans: bool, work=2):
    t = trace.Trace(events(with_spans), window_s=1e-5)
    t.counts = dict(units=1, work=work, rows={}, flops={})
    return t


def test_span_ranges_leave_the_other_readers_alone():
    """With the program's spans among the ranges, every op call keeps its
    device time, the members' ranges theirs, the idle union its value."""
    plain, spanned = make_trace(False), make_trace(True)
    for name in ("vsc22::ln_mlp_residual", "vsc22::row_max"):
        assert [c["device_ns"] for c in spanned.op_calls(name)] == \
            [c["device_ns"] for c in plain.op_calls(name)] == [100]
    assert spanned.ranges_device_s("portbench::") == plain.ranges_device_s("portbench::")
    assert spanned.busy_ns == plain.busy_ns == 350
    assert readers.idle_share(spanned) == readers.idle_share(plain)
    assert sorted(ns for ns, _ in spanned.gaps) == sorted(ns for ns, _ in plain.gaps)
    assert ("before aten::copy_ in vsc22::span/score_norm.bias"
            in {w for _, w in spanned.gaps})


def test_scorenorm_idle_reads_the_gaps_inside_score_norm():
    read = harness.load_reader("scorenorm_idle_ms_per_video.query")
    assert read(make_trace(True)) == pytest.approx(2800 / 1e6 / 2)
    assert read(make_trace(False)) is None  # no score_norm span in the window
    assert read(make_trace(True, work=0)) is None


def recorder(counters=None):
    def s(name, ms, sid, parent=None):
        return dict(name=name, start_ns=0, end_ns=int(ms * 1e6), self_ns=int(ms * 1e6),
                    thread=1, id=sid, parent=parent, ids={})
    return dict(spans=[s("score_norm", 3, 0), s("score_norm.bias", 1, 1, 0),
                       s("score_norm", 5, 2), s("gate_wait", 7, 3)],
                counters=dict(counters or {}))


def test_span_readers_on_a_hand_built_recorder():
    t = make_trace(False, work=4)
    host = harness.load_reader("scorenorm_host_ms_per_video.query")
    wait = harness.load_reader("gate_wait_ms_per_video.query")
    assert host(t, recorder()) == pytest.approx((3 + 5) / 4)
    assert wait(t, recorder()) == pytest.approx(7 / 4)
    empty = dict(spans=[], counters={})
    assert host(t, empty) is None and wait(t, empty) is None
    assert spans.span_ms_per_video(make_trace(False, work=0), "gate_wait", recorder()) is None


def test_counter_readers_on_a_hand_built_recorder():
    t = make_trace(False, work=2)
    h2d = harness.load_reader("h2d_mb_per_video.query")
    flagged = harness.load_reader("fsd_flagged_share.query")
    rec = recorder(dict(h2d_bytes=55_000_000, videos_gated_in=12, fsd_flagged=3))
    assert h2d(t, rec) == pytest.approx(27.5)
    assert flagged(t, rec) == pytest.approx(25.0)
    assert flagged(t, recorder(dict(videos_gated_in=12, fsd_flagged=0))) == 0.0
    assert h2d(t, recorder()) is None
    assert flagged(t, recorder(dict(fsd_flagged=3))) is None
    assert flagged(t, recorder(dict(videos_gated_in=0, fsd_flagged=0))) is None


def test_tiny_query_cell_reports_the_new_metrics(tmp_path, capsys):
    """The tiny query cell traced on the CPU with the five metrics listed:
    each reads something but the idle gaps, which need a device."""
    from vsc22_tpu_torch.utils import observability

    with open(os.path.join(HERE, "tiny_benchmark.json")) as f:
        bench = json.load(f)
    units = dict(zip(NEW, ("ms", "ms", "ms", "MB", "%")))
    bench["per_layer"] += [dict(name=n, unit=units[n], better="lower", source="program_span",
                                layer="x", moves="query_videos_per_s", workloads=["tiny.query"])
                           for n in NEW]
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    args = ["--workload", "tiny.query", "--seed", "11", "--seconds", "0.2", "--trace", "1",
            "--benchmark", str(path),
            "--config-file", os.path.join(HERE, "tiny_ensemble.json"),
            "--traffic-file", os.path.join(HERE, "tiny_videos.json"),
            "--limits-file", os.path.join(HERE, "limits", "tiny.query.json"), "--device", "cpu"]
    observability.reset()
    try:
        assert harness.main(args) == 0
    finally:
        observability.reset()
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metrics = res["metrics"]
    assert res["correct"] is True
    assert set(NEW) - set(metrics) == {"scorenorm_idle_ms_per_video.query"}
    assert metrics["h2d_mb_per_video.query"]["value"] > 0
    assert 0 <= metrics["fsd_flagged_share.query"]["value"] <= 100
    assert metrics["scorenorm_host_ms_per_video.query"]["value"] > 0
    assert "fsd_host_ms_per_video.query" in metrics
