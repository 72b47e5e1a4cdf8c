"""The port's descriptor-training CLI (`vsc22_tpu_torch/train/descriptor_cli.py`)
on `configs/tiny_smoke.py` with `--device cpu`, and the utilities it runs
on (`utils/config.py`, `utils/observability.py`) against the JAX package's.

The JAX CLI itself is not run (XLA compiling its train step is most of a
half-minute); its test's expectations of the files are held here, the step
is held against JAX by `test_torch_train.py`, and the EMA snapshot is read
back by the JAX package's `load_params_snapshot`."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vsc22_tpu.models import vit as jvit  # noqa: E402
from vsc22_tpu.train import checkpoint as jckpt  # noqa: E402
from vsc22_tpu.utils import config as jconfig  # noqa: E402
from vsc22_tpu.utils import observability as jobs  # noqa: E402
from vsc22_tpu_torch.data.datasets import DataLoader, FramePairDataset  # noqa: E402
from vsc22_tpu_torch.data.store import FrameStore  # noqa: E402
from vsc22_tpu_torch.models import vit  # noqa: E402
from vsc22_tpu_torch.models.layers import reset_parameters  # noqa: E402
from vsc22_tpu_torch.pipelines.preprocess import encode_jpegs  # noqa: E402
from vsc22_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from vsc22_tpu_torch.train import contrastive as tc  # noqa: E402
from vsc22_tpu_torch.train import descriptor_cli  # noqa: E402
from vsc22_tpu_torch.utils import config as pconfig  # noqa: E402
from vsc22_tpu_torch.utils import observability as pobs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "tiny_smoke.py")
DESC_TOL = 1e-5  # f32 descriptors, JAX against the port on the CPU
# 4 videos x 5 frames at batch 4: 5 steps an epoch
FLAGS = ["--config", TINY, "--batch_size", "4", "--num_workers", "1", "--entropy_weight", "1.0",
         "--print_freq", "1", "--do_ema", "--do_fgm", "--lr", "1e-3", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """(store path, GT csv path): 4 videos of 5 noise frames, 64x64, and one
    planted pair for the labeled sampler."""
    root = tmp_path_factory.mktemp("cli_store")
    rng = np.random.default_rng(0)
    vids = [("Q000000", "R000001", "R000002", "R000003")[i] for i in range(4)]
    path = str(root / "f.rec")
    FrameStore.build(path, [(v, encode_jpegs(rng.integers(0, 255, (5, 64, 64, 3), np.uint8)))
                            for v in vids])
    gt = root / "gt.csv"
    gt.write_text("query_id,ref_id,query_start,query_end,ref_start,ref_end,score\n"
                  "Q000000,R000002,0,4,1.0,5.0,1.0\n")
    return path, str(gt)


def run_cli(store_path, work_dir, *extra):
    return descriptor_cli.main([*FLAGS, "--store", store_path, "--work_dir", str(work_dir),
                                *extra])


class LossLog(logging.Handler):
    """The CLI's logged (epoch, batch, loss, ici, entropy) records."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def emit(self, record):
        if record.msg.startswith("Epoch %d Batch %d Loss"):
            self.rows.append(record.args)


@pytest.fixture
def loss_log():
    handler = LossLog()
    logging.getLogger().addHandler(handler)
    yield handler
    logging.getLogger().removeHandler(handler)


def test_cli_files_as_the_jax_cli_test_expects(store, tmp_path, loss_log):
    """`tests/test_infra.py::test_descriptor_cli_end_to_end`'s checks, on
    the labeled sampler (`--ann_path`): the state's step, log.txt, the EMA
    snapshot, a checkpoint; the log lines in the JAX CLI's format."""
    work = tmp_path / "run"
    state = run_cli(store[0], work, "--epochs", "1", "--ann_path", store[1])
    assert state.step == 5
    assert (work / "log.txt").exists()
    assert (work / "epoch_0_ema.npz").exists()
    assert len(os.listdir(work / "checkpoints")) >= 1
    assert [r[:2] for r in loss_log.rows] == [(0, b) for b in range(5)]
    assert all(np.isfinite(r[2:]).all() for r in loss_log.rows)
    text = (work / "log.txt").read_text()
    assert "Epoch 0 Batch 4 Loss " in text and ", ICI Loss " in text and "timing:" in text
    for stage in ("data", "train_step", "checkpoint"):
        assert f"{stage}: " in text


def test_ann_csv_reads_as_pandas_does(store):
    """The stdlib reader of the GT csv gives the rows the JAX CLI's pandas
    read gives."""
    pd = pytest.importorskip("pandas")
    want = pd.read_csv(store[1])[list(descriptor_cli.ANN_COLUMNS)].values.tolist()
    got = descriptor_cli.read_annotations(store[1])
    assert got == want and [type(v) for v in got[0][:2]] == [str, str]


def test_first_logged_loss_is_the_train_step_on_the_first_batch(store, tmp_path, loss_log):
    run_cli(store[0], tmp_path / "run", "--epochs", "1", "--seed", "7")
    model = vit.vit_tiny_test_descriptor()
    reset_parameters(model, torch.Generator().manual_seed(7))
    cfg = tc.ContrastiveConfig(temperature=0.05, entropy_weight=1.0, learning_rate=1e-3,
                               total_steps=5, ema_decay=0.999, fgm_epsilon=0.1)
    state, tx = tc.create_train_state(model, cfg)
    loader = DataLoader(FramePairDataset(FrameStore(store[0]), width=64, preset="vit"),
                        batch_size=4, seed=7, num_workers=1)
    batch = next(iter(loader.epoch(0)))
    _, metrics = tc.make_train_step(model, tx, cfg)(
        state, {k: torch.from_numpy(batch[k]) for k in ("img_a", "img_b")},
        torch.Generator().manual_seed(7))
    assert loss_log.rows[0][2:] == tuple(metrics[k].item()
                                         for k in ("loss", "ici_loss", "entropy_loss"))


def params_equal(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[k], b[k]) for k in a)


def test_resumed_run_ends_where_the_unbroken_run_does(store, tmp_path, monkeypatch):
    """Two epochs in one run, against a run cut after its first epoch's
    checkpoint (its loader failing in the second epoch) and resumed with
    the same flags: the same parameters, EMA and step at the end. (A first
    run with `--epochs 1` would train on another learning-rate schedule,
    which spans `--epochs`.)"""
    whole = run_cli(store[0], tmp_path / "whole", "--epochs", "2")
    epoch = DataLoader.epoch

    def cut(self, e=0):
        if e == 1:
            raise KeyboardInterrupt("cut")
        return epoch(self, e)

    with monkeypatch.context() as m:
        m.setattr(DataLoader, "epoch", cut)
        with pytest.raises(KeyboardInterrupt):
            run_cli(store[0], tmp_path / "cut", "--epochs", "2")
    assert tckpt.CheckpointManager(str(tmp_path / "cut" / "checkpoints")).all_steps() == [5]
    resumed = run_cli(store[0], tmp_path / "cut", "--epochs", "2", "--resume")
    assert resumed.step == whole.step == 10 and resumed.opt_state.count == 10
    assert params_equal(resumed.params, whole.params)
    assert params_equal(resumed.ema_params, whole.ema_params)
    for name in ("epoch_0_ema.npz", "epoch_1_ema.npz"):
        a, b = np.load(tmp_path / "whole" / name), np.load(tmp_path / "cut" / name)
        assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)


def test_resume_extends_a_finished_run(store, tmp_path, caplog):
    """`--epochs 1`, then `--epochs 2 --resume` (as the card's smoke run
    does): the second run starts at the first's last step and adds an
    epoch, with both epochs' checkpoints and snapshots."""
    caplog.set_level(logging.INFO)
    run_cli(store[0], tmp_path, "--epochs", "1")
    state = run_cli(store[0], tmp_path, "--epochs", "2", "--resume")
    assert state.step == 10
    assert "resumed from step 5 (epoch 1)" in caplog.text
    assert tckpt.CheckpointManager(str(tmp_path / "checkpoints")).all_steps() == [5, 10]
    assert (tmp_path / "epoch_0_ema.npz").exists() and (tmp_path / "epoch_1_ema.npz").exists()


def test_ema_snapshot_loads_in_both_packages(store, tmp_path):
    run_cli(store[0], tmp_path, "--epochs", "1")
    path = str(tmp_path / "epoch_0_ema.npz")
    imgs = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    model = vit.vit_tiny_test_descriptor()
    tckpt.load_params_snapshot(path, model)
    with torch.no_grad():
        want = model(torch.from_numpy(imgs)).numpy()
    jm = jvit.vit_tiny_test_descriptor()
    params = jckpt.load_params_snapshot(path, jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs)))
    got = np.asarray(jm.apply(params, jnp.asarray(imgs)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=DESC_TOL, rtol=DESC_TOL)


def test_two_stores_concatenate(store, tmp_path):
    state = run_cli(store[0], tmp_path, "--epochs", "1", "--store", store[0])
    assert state.step == 10  # 40 frames at batch 4


def test_cli_runs_on_the_card_unless_told_otherwise(store, tmp_path):
    if torch.cuda.is_available():
        return
    args = [a for a in FLAGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        descriptor_cli.main([*args, "--store", store[0], "--work_dir", str(tmp_path)])


# --- the utilities ------------------------------------------------------------------

CONFIG_TEXT = """
import math
img_width = 384
preprocess = "efficientnet"
model = dict(type="vit_base_patch32_384", extra=dict(depth=12, scale=math.sqrt(2.0)))
data = dict(probs=(0.8, 0.2), crop=0.5)
_private = 1
def helper():
    return 1
"""


def test_config_matches_jax(tmp_path):
    path = tmp_path / "cfg.py"
    path.write_text(CONFIG_TEXT)
    flags = ["model.type=vit_tiny_test", "--data.crop=0.25", "data.new.deep=[1, 2]",
             "preprocess=vit", "note=not a literal"]
    cfgs = [m.Config.fromfile(str(path)) for m in (jconfig, pconfig)]
    assert cfgs[0].to_dict() == cfgs[1].to_dict()
    assert cfgs[1].model.extra.depth == 12 and cfgs[1].data.probs == (0.8, 0.2)
    assert "_private" not in cfgs[1] and "helper" not in cfgs[1] and "math" not in cfgs[1]
    overrides = [m.parse_override_args(flags) for m in (jconfig, pconfig)]
    assert overrides[0] == overrides[1]
    merged = [c.merge_flags(o) for c, o in zip(cfgs, overrides)]
    assert merged[0].to_dict() == merged[1].to_dict()
    assert merged[1].data.crop == 0.25 and merged[1].data.new.deep == [1, 2]
    assert merged[1].note == "not a literal" and cfgs[1].data.crop == 0.5
    assert merged[1] == merged[1].to_dict() and repr(merged[1]).startswith("Config(")
    for m in (jconfig, pconfig):
        with pytest.raises(ValueError, match="not key=value"):
            m.parse_override_args(["novalue"])
    with pytest.raises(AttributeError):
        cfgs[1].missing


def test_stage_timer_and_logging_match_jax(tmp_path, capsys):
    timers = [jobs.StageTimer(), pobs.StageTimer()]
    for t in timers:
        for name, s in (("a", 0.5), ("b", 1.25), ("a", 0.25)):
            t.totals[name] += s
            t.counts[name] += 1
    assert timers[0].report() == timers[1].report()
    assert timers[0].as_dict() == timers[1].as_dict()
    calls = []
    timer = pobs.StageTimer(sync=lambda: calls.append(1))
    with timer.stage("x"):
        pass
    assert calls == [1, 1] and timer.counts["x"] == 1 and timer.totals["x"] >= 0.0

    log = pobs.setup_logging("port_obs_test", str(tmp_path / "w"))
    log.info("hello %d", 3)
    assert "hello 3" in (tmp_path / "w" / "log.txt").read_text()
    assert "hello 3" in capsys.readouterr().out
    quiet = pobs.setup_logging("port_obs_quiet", str(tmp_path / "q"), process_index=1)
    assert [type(h) for h in quiet.handlers] == [logging.NullHandler]
    assert pobs.rank() == 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with pobs.device_trace(str(tmp_path)):
        with pobs.annotate("tiny_region"):
            torch.ones(4).sum()
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    assert any(e.get("name") == "tiny_region" for e in trace["traceEvents"])
