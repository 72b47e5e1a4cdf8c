"""The port's matching CLI against the JAX package's on the CPU: both run
stages 2-6 on the same npz feature files (written by the JAX
`store_features`) with the same classify and refine weights (JAX
`save_cnn_snapshot` files) and must write the same CSV rows.

The classify folds are random full-width MobileNetV3-Small variables
(`test_torch_matching_models.jax_variables`, calibrated on small sim
blocks padded with zeros, so most pairs pass the default threshold). The
refine folds are the tiny SAM (`--tiny`) with weights set by hand so that
its heatmap reads the similarity image, sigmoid(12 * relu(sim - 0.6) - 3):
a random SAM's maps hold no line for the decode, and the CSV would be
empty.

Comparison: the same header and rows in the same order, every cell but
the score equal as text (ids, and the float64 starts and ends as pandas
writes them), scores within 1e-4 (each is max - std * ratio of heatmap
values that agree to ~1e-6 in float32).

The JAX CLI builds its templates with an eager `model.init` (tens of
seconds of op-by-op compiles on the CPU); the test hands it the same
templates from `jax.eval_shape`, which `load_cnn_snapshot` fills the
same way (it reads only their shapes and dtypes).
"""

import csv
import json

import jax
import numpy as np
import pytest

from test_torch_matching_models import jax_variables
from vsc22_tpu.core.storage import store_features
from vsc22_tpu.core.types import VideoFeature
from vsc22_tpu.models import hrnet as jhrnet
from vsc22_tpu.models import mobilenetv3 as jmnv3
from vsc22_tpu.pipelines import matching_cli as jcli
from vsc22_tpu.train.checkpoint import load_cnn_snapshot, save_cnn_snapshot
from vsc22_tpu_torch.pipelines import matching_cli
from vsc22_tpu_torch.utils import jax_params

SCORE_TOL = 1e-4


def normed(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def write_corpus(tmp_path):
    """4 query, 5 ref and 6 noise videos (16-d); Q0 copies R0 frames
    3-12, Q1 (two segments of 12 by the length map) R1 frames 2-9."""
    rng = np.random.default_rng(8)
    refs = [normed(rng.standard_normal((22 + 2 * i, 16))) for i in range(5)]
    qs = [normed(rng.standard_normal((n, 16))) for n in (20, 24, 16, 18)]
    qs[0][4:14] = refs[0][3:13]
    qs[1][14:22] = refs[1][2:10]
    noise = [normed(rng.standard_normal((10, 16))) for _ in range(6)]

    def vids(prefix, feats, start=0):
        return [VideoFeature(video_id=f"{prefix}{start + i:06d}", feature=f,
                             timestamps=np.arange(len(f), dtype=np.float32))
                for i, f in enumerate(feats)]

    paths = {k: str(tmp_path / f"{k}.npz") for k in ("q", "r", "noise")}
    store_features(paths["q"], vids("Q", qs))
    store_features(paths["r"], vids("R", refs))
    store_features(paths["noise"], vids("R", noise, start=100))
    paths["len_map"] = str(tmp_path / "lens.json")
    with open(paths["len_map"], "w") as f:
        json.dump({"Q000000": 20, "Q000001": 12, "Q000002": 16, "Q000003": 18}, f)
    return paths


def sim_reading_sam(model, sample):
    """Variables of the tiny SAM whose class-1 logit is
    12 * relu(sim - 0.6) - 3: stem channel 0 passes the image's centre
    tap through an identity BN, fuse1 channel 0 reads it with bias -0.6,
    fuse2 scales it; every other weight is zero."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), sample))

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        return np.full(s.shape, 1.0 if name in ("scale", "var") else 0.0, np.float32)

    v = jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))
    p = v["params"]
    p["backbone"]["stem1"]["Conv_0"]["kernel"][1, 1, 0, 0] = 1.0
    v["batch_stats"]["backbone"]["stem1"]["BatchNorm_0"]["var"][:] = 1.0 - 1e-5
    p["fuse1"]["kernel"][0, 0, 0, 0] = 1.0
    p["fuse1"]["bias"][0] = -0.6
    p["fuse2"]["kernel"][0, 0, 0, 1] = 12.0
    p["fuse2"]["bias"][1] = -3.0
    return v


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    d = tmp_path_factory.mktemp("snapshots")
    # calibrated on images like the CLI's: a small sim block, zeros around
    rng = np.random.default_rng(9)
    cls_x = np.zeros((4, 160, 160, 3), np.float32)
    for i, n in enumerate((12, 18, 22, 26)):
        cls_x[i, :n, : n + 4] = rng.normal(0, 0.25, (n, n + 4, 1))
    paths = {"cls": [], "refine": []}
    for fold in range(2):
        v = jax_variables(jmnv3.mobilenetv3_small(), cls_x, seed=30 + fold, last="classifier")
        paths["cls"].append(str(d / f"cls{fold}.npz"))
        save_cnn_snapshot(paths["cls"][-1], v["params"], v["batch_stats"])
    v = sim_reading_sam(jhrnet.sam_hrnet_tiny_test(), np.zeros((1, 32, 32, 3), np.float32))
    for fold in range(2):
        paths["refine"].append(str(d / f"refine{fold}.npz"))
        save_cnn_snapshot(paths["refine"][-1], v["params"], v["batch_stats"])
    return paths


def fast_jax_load_cnn(model, sample_shape, params_paths):
    template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), np.zeros(
        sample_shape, np.float32), train=False))
    return [(model, load_cnn_snapshot(p, template)) for p in params_paths]


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_matching_cli_writes_the_jax_rows(tmp_path, snapshots, monkeypatch):
    paths = write_corpus(tmp_path)
    common = ["--query_features", paths["q"], "--ref_features", paths["r"],
              "--norm_refs", paths["noise"], "--query_len_map", paths["len_map"], "--tiny",
              "--cls_params", *snapshots["cls"], "--refine_params", *snapshots["refine"]]
    monkeypatch.setattr(jcli, "_load_cnn", fast_jax_load_cnn)
    jcli.main(common + ["--out", str(tmp_path / "jax.csv")])
    matching_cli.main(common + ["--out", str(tmp_path / "port.csv"), "--device", "cpu"])
    want, got = read_csv(tmp_path / "jax.csv"), read_csv(tmp_path / "port.csv")
    assert got[0] == want[0] == matching_cli.COLUMNS
    assert len(got) == len(want) > 1
    for g, w in zip(got[1:], want[1:]):
        assert g[:6] == w[:6]
        assert abs(float(g[6]) - float(w[6])) <= SCORE_TOL
    found = {(r[0], r[1]) for r in got[1:]}
    assert {("Q000000", "R000000"), ("Q000001", "R000001")} <= found
    assert open(tmp_path / "port.csv").read().endswith("\n")


def test_snapshot_reader_rebuilds_the_variable_tree(snapshots):
    tree = jax_params.npz_tree(snapshots["refine"][0])
    assert set(tree) == {"params", "batch_stats"}
    assert tree["params"]["fuse2"]["kernel"][0, 0, 0, 1] == 12.0
    assert tree["batch_stats"]["backbone"]["stem1"]["BatchNorm_0"]["mean"].shape == (8,)


def test_matching_cli_random_weights_on_the_cpu(tmp_path):
    """`-` weights (seeded random), the default classify threshold: the
    CLI runs through and writes a well-formed CSV."""
    paths = write_corpus(tmp_path)
    out = str(tmp_path / "m.csv")
    matching_cli.main(["--query_features", paths["q"], "--ref_features", paths["r"],
                       "--norm_refs", paths["noise"], "--out", out, "--tiny", "--device", "cpu"])
    rows = read_csv(out)
    assert rows[0] == matching_cli.COLUMNS
    for r in rows[1:]:
        assert float(r[2]) <= float(r[3]) and float(r[4]) <= float(r[5])
