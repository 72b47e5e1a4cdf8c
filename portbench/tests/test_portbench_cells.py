"""Every cell's tiny CPU form end to end, its last line, and what must
refuse: the fp8 control, the planted faults, JAX in the process.

The tiny forms (`tests/tiny_*.json`) run the program's plain paths in
float32 on the CPU against the reference; their limits are set for that.
Run with `python -m pytest portbench/tests -q`.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tasks import common
from portbench.traffic import generate

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CELLS = {
    "tiny.query": ("tiny_ensemble.json", "tiny_videos.json"),
    "tiny.train": ("tiny_train.json", "tiny_pairs.json"),
}


def args(cell, seed=3, trace=0):
    cfg, traffic = CELLS[cell]
    return ["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace),
            "--benchmark", os.path.join(HERE, "tiny_benchmark.json"),
            "--config-file", os.path.join(HERE, cfg),
            "--traffic-file", os.path.join(HERE, traffic),
            "--limits-file", os.path.join(HERE, "limits", f"{cell}.json"), "--device", "cpu"]


def tiny_task(cell, seed):
    cfg_file, traffic_file = CELLS[cell]
    cfg = common.load_config(None, os.path.join(HERE, cfg_file))
    cfg["limits"] = harness.load_limits(None, os.path.join(HERE, "limits", f"{cell}.json"))
    traffic = generate.load(None, os.path.join(HERE, traffic_file))
    return harness.make_task(cfg, traffic, seed, "cpu")


def last_line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]) if out else None


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_runs_and_prints_the_result_line(cell, trace, capsys):
    assert harness.main(args(cell, trace=trace)) == 0
    res = last_line(capsys)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    bench = harness.load_benchmark(os.path.join(HERE, "tiny_benchmark.json"))
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in harness.cell_metrics(bench, cell, kind)}
    assert set(res["metrics"]) <= want and res["metrics"]
    if not trace:
        assert set(res["metrics"]) == want
    else:
        assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(res["device"])
        assert "breakdown" in res


def test_fp8_control_is_not_correct():
    """The control: the reference computed in float8 fails the tiny limits."""
    task = tiny_task("tiny.query", 5)
    task.setup()
    exp = task.expected()
    verdict = task.judge(exp, task.control_answers(task.expected("fp8")))
    over = [k for k, v in verdict["readings"].items() if v > task.cfg["limits"][k]]
    assert over, verdict["readings"]

    task = tiny_task("tiny.train", 5)
    task.setup()
    task.release()
    verdict = task.judge(task.expected(), task.control_answers(task.expected("fp8")))
    assert any(v > task.cfg["limits"][k] for k, v in verdict["readings"].items()), verdict


def _altered_finalize(monkeypatch):
    from vsc22_tpu_torch.pipelines import batch_query

    original = batch_query.BatchedQueryPipeline._finalize

    def finalize(self, ctx, pending, fetched):
        out = original(self, ctx, pending, fetched)
        out[-1].feature[0, 1] += 0.05  # one answer altered where it is produced
        return out

    monkeypatch.setattr(batch_query.BatchedQueryPipeline, "_finalize", finalize)


def _unchanged_state(monkeypatch):
    from vsc22_tpu_torch.train import contrastive

    monkeypatch.setattr(contrastive.TrainState, "apply_gradients",
                        lambda self, tx, grads, decay, clip=True: self)


def _half_batch(monkeypatch):
    from vsc22_tpu_torch.train import contrastive

    make = contrastive.make_train_step

    def make_half(model, tx, cfg, mesh=None):
        step = make(model, tx, cfg, mesh)

        def half(state, batch, generator):
            n = batch["img_a"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, generator)

        return half

    monkeypatch.setattr(contrastive, "make_train_step", make_half)


@pytest.mark.parametrize("cell,fault", [("tiny.query", _altered_finalize),
                                        ("tiny.train", _unchanged_state),
                                        ("tiny.train", _half_batch)])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    assert harness.main(args(cell)) == 0
    assert last_line(capsys)["correct"] is False


def _reversed_after_setup(monkeypatch):
    """Every update after the set-up's checked steps goes the wrong way."""
    from vsc22_tpu_torch.train import contrastive

    apply = contrastive.AdamW.apply

    def reversed_apply(self, grads, state, params, clip=True):
        before = [p.clone() for p in params]
        apply(self, grads, state, params, clip)
        if state.count > 3:
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(2 * b - p)

    monkeypatch.setattr(contrastive.AdamW, "apply", reversed_apply)


def test_a_fault_after_setup_is_caught_in_the_checked_step(monkeypatch, capsys):
    _reversed_after_setup(monkeypatch)
    assert harness.main(args("tiny.train")) == 0
    res = last_line(capsys)
    assert res["correct"] is False
    over = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert over and all(k.startswith("window_") for k in over), res["checks"]


def test_heads_come_from_the_reference_alone():
    """The heads that set-up sets are worked out from the float32
    reference's readings of the seed's videos, not from the program: the
    same as the reference alone gives, and every video's reference gate
    logit lies 8 or more above the threshold's."""
    from portbench.reference import query as ref_query

    task = tiny_task("tiny.query", 9)
    task.setup()
    cal = ref_query.calibrate(task.cfg, task.reference_weights(heads=False), task.videos, "cpu")
    for m in task.cfg["members"]:
        np.testing.assert_array_equal(cal.head_means[m["name"]].numpy(),
                                      task.cal.head_means[m["name"]].numpy())
    exp = task.expected()
    thr = task.cfg["query"]["score_threshold"]
    assert float(exp.logits.min()) >= np.log(thr / (1 - thr)) + 7.9
    task.unit()
    assert min(task.passes[-1]["scores"].values()) >= thr


def test_jax_in_the_process_refuses_the_run(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.main(args("tiny.train")) == 2
    assert capsys.readouterr().out.strip() == ""


def test_run_loads_no_jax_module():
    """A whole run in a fresh interpreter ends with its result, which the
    harness prints only where no module whose top-level name is jax,
    jaxlib, flax, optax or vsc22_tpu was loaded (names compared whole: the
    port's name starts with the JAX package's)."""
    done = subprocess.run([sys.executable, "portbench/run.py"] + args("tiny.query"), cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1])["correct"] is True
    assert harness.forbidden_modules() == []


def test_no_card_refuses_the_run(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    argv = args("tiny.query")
    argv[argv.index("--device") + 1] = "cuda"
    assert harness.main(argv) == 2
    assert capsys.readouterr().out.strip() == ""


def test_a_directory_with_only_the_benchmark_refuses(tmp_path):
    """BENCHMARK.json and portbench/ alone: the program is missing."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "query_ensemble_b24", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
