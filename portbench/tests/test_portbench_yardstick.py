"""The yardstick against hand counts: operation and byte counts, FLOP
counters, rooflines from recorded shapes, the idle union; and the
benchmark's data files against BENCHMARK.json."""

import json
import os
import re

import pytest

from portbench import harness
from portbench.tasks import common
from portbench.traffic import generate
from portbench.yardstick import readers, roofline, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def test_work_swin_block_by_hand():
    # SwinV2-B stage 3 in bf16: 128 frames x 16 windows of 256 tokens, C 512, 16 heads
    w, n, c, h, f, nw = 2048, 256, 512, 16, 2048, 16
    flops, nbytes = roofline.work_swin_block(w, n, c, h, f, nw, 2)
    m = w * n
    assert flops == 2 * m * (4 * c * c + 2 * c * f) + 4 * w * h * n * n * 32
    assert nbytes == 2 * (2 * m * c + 4 * c * c + 2 * c * f) + 4 * (9 * c + f + h * n * n + h
                                                                   + nw * n * n)
    # unshifted (one mask): no mask bytes
    assert roofline.work_swin_block(w, n, c, h, f, 1, 2)[1] == nbytes - 4 * nw * n * n


def test_work_mlp_and_bound_by_hand():
    flops, nbytes = roofline.work_mlp(32896, 1024, 4096, 2)
    assert flops == 4 * 32896 * 1024 * 4096
    assert nbytes == (2 * 32896 * 1024 + 2 * 1024 * 4096) * 2 + 4 * (4096 + 3 * 1024)
    assert roofline.bound_s(flops, nbytes, "bf16") == pytest.approx(flops / 989e12)
    assert roofline.bound_s(1.0, 3.35e12, "bf16") == pytest.approx(1.0)  # bytes bound


def test_forward_flops_by_hand():
    vit = common.load_config("desc_ensemble")["models"]["vit_b32_384"]["dims"]
    # ViT-B/32@384: 144 patches + CLS
    l, c, f = 145, 768, 3072
    block = 2 * l * c * 3 * c + 4 * l * l * c + 2 * l * c * c + 4 * l * c * f
    want = 2 * 144 * 3 * 32 * 32 * c + 12 * block + 2 * l * c * 2048 + 2 * 2048 * 512
    assert roofline.vit_forward_flops(vit) == want
    assert 24e9 < want < 27e9
    clip = common.load_config("desc_ensemble")["models"]["clip"]["dims"]
    l, c = 257, 1024
    block = 2 * l * c * 3 * c + 4 * l * l * c + 2 * l * c * c + 4 * l * c * 4 * c
    assert roofline.clip_forward_flops(clip) == 2 * 256 * 3 * 14 * 14 * c + 24 * block
    swin = common.load_config("desc_ensemble")["models"]["swinv2_b_256"]["dims"]
    total = 2 * 64 * 64 * 48 * 128
    for s, (depth, res) in enumerate(zip((2, 2, 18, 2), (64, 32, 16, 8))):
        c, l, n = 128 * 2 ** s, res * res, min(16, res) ** 2
        total += depth * (2 * l * c * 3 * c + 4 * l * n * c + 2 * l * c * c + 8 * l * c * c * 4 // 2)
        if s < 3:
            total += 2 * (l // 4) * 4 * c * 2 * c
    assert roofline.swin_forward_flops(swin) == total + 2 * 1024 * 512
    vsm = common.load_config("desc_ensemble")["models"]["vsm"]["dims"]
    l, h = 258, 768
    block = 2 * l * h * 3 * h + 4 * l * l * h + 2 * l * h * h + 4 * l * h * 4 * h
    assert roofline.vsm_forward_flops(vsm) == 2 * 256 * 1024 * h + 12 * block + 4 * h


class FakeTrace:
    def __init__(self, calls, busy_s=1.0, window_s=2.0, counts=None):
        self.calls, self.busy_s, self.window_s = calls, busy_s, window_s
        self.counts = counts or {}
        self.program_spans = {}

    def op_calls(self, name):
        return [c for c in self.calls if c["name"] == name]

    def ranges_device_s(self, prefix):
        return sum(c["device_ns"] for c in self.calls if c["name"].startswith(prefix)) / 1e9


def test_roofline_share_from_recorded_shapes():
    shapes = [[2048, 256, 512], [1536, 512], [1536], [512, 512], [512], [512], [512],
              [2048, 512], [2048], [512, 2048], [512], [512], [512], [16, 256, 256], [16],
              [16, 256, 256], [], []]
    flops, nbytes = roofline.work_swin_block(2048, 256, 512, 16, 2048, 16, 2)
    bound = roofline.bound_s(flops, nbytes, "bf16")
    call = dict(name="vsc22::swin_block", shapes=shapes, dtypes=["c10::BFloat16"] * 16,
                device_ns=int(4 * bound * 1e9))
    share = readers.roofline_share(FakeTrace([call, dict(call)]), "vsc22::swin_block")
    assert share == pytest.approx(25.0, rel=1e-6)
    assert readers.roofline_share(FakeTrace([]), "vsc22::swin_block") is None
    mlp = dict(name="vsc22::ln_mlp_residual", shapes=[[18560, 768], [768], [768], [3072, 768],
                                                      [3072], [768, 3072], [768], [], []],
               dtypes=["c10::BFloat16"], device_ns=10 ** 6)
    want = roofline.bound_s(*roofline.work_mlp(18560, 768, 3072, 2), "bf16") / 1e-3
    assert readers.roofline_share(FakeTrace([mlp]), "vsc22::ln_mlp_residual") == \
        pytest.approx(100 * want)


def test_mfu_and_idle_by_hand():
    t = FakeTrace([], busy_s=1.5, window_s=2.0,
                  counts=dict(rows={"a": 100, "b": 10}, flops={"a": 1e12, "b": 2e12}))
    assert readers.idle_share(t) == pytest.approx(25.0)
    assert readers.mfu(t) == pytest.approx(100 * 120e12 / 2.0 / 989e12)
    assert readers.mfu(t, passes=3) == pytest.approx(300 * 120e12 / 2.0 / 989e12)


def test_idle_union_of_overlapping_intervals():
    spans = sorted([(0, 10, 1), (5, 15, 2), (20, 30, 3), (22, 25, 4), (30, 31, 5)])
    assert trace._union(spans)[0] == 26
    assert trace._union([]) == (0, [])
    busy, gaps = trace._union([(0, 10, 1), (5, 15, 2), (20, 30, 3)])
    assert busy == 25 and gaps == [(5, 3)]


def test_holding_finds_the_enclosing_range():
    spans = [(0, 10, 0), (20, 30, 1), (40, 50, 2)]
    assert trace._holding(spans, 25) == [1]
    assert trace._holding(spans, 15) == []
    assert trace._holding(spans, 50) == [2]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_files_are_found_by_name():
    bench = harness.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = common.load_config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, "portbench", "tasks", cfg["task"] + ".py"))
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        generate.load(w["traffic"])
        assert harness.load_limits(w["name"])
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
        harness.load_reader(m["name"])
    for w in bench["workloads"]:
        assert harness.cell_metrics(bench, w["name"], "per_layer")
        assert len(harness.cell_metrics(bench, w["name"], "end_to_end")) >= 2
    assert len(json.dumps(bench)) < 64 * 1024
