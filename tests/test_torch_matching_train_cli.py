"""The port's matching training CLI (`vsc22_tpu_torch/train/matching_cli.py`)
end to end on the CPU with its tiny models, on the planted corpus of
`tests/test_matching_train.py` (8 query and 8 ref videos, 4 planted
copies, 16 candidates): the files it writes, that its four snapshots load
into the JAX package's `load_cnn_snapshot` (the JAX CLI's flax `TinyCNN`
and the tiny SAM) and hold exactly the keys of its variables, that the port's `TinyCNN`
computes what the flax one does on the same weights (logits within 1e-5:
float32, other summation orders), and that the refine snapshots drive the
port's inference CLI (`pipelines/matching_cli --tiny`).
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vsc22_tpu.models import hrnet as jhrnet
from vsc22_tpu.train.checkpoint import load_cnn_snapshot
from vsc22_tpu_torch.core.storage import store_features
from vsc22_tpu_torch.core.types import Match, VideoFeature, _read_rows, _write_rows
from vsc22_tpu_torch.pipelines import matching_cli as infer_cli
from vsc22_tpu_torch.train import matching_cli
from vsc22_tpu_torch.utils import jax_params


class FlaxTinyCNN(fnn.Module):
    """The JAX training CLI's `--tiny` classifier (`matching_cli.py:181-187`)."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = fnn.Conv(8, (3, 3), strides=(4, 4))(x)
        x = fnn.BatchNorm(use_running_average=not train)(x)
        x = fnn.relu(x).mean(axis=(1, 2))
        return fnn.Dense(2)(x)


def planted_corpus(tmp_path):
    rng = np.random.default_rng(0)
    dim = 16

    def normed(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    refs, queries, gt, cands, noise = [], [], [], [], []
    for i in range(8):
        refs.append(VideoFeature(video_id=f"R{i:06d}", feature=normed(rng.standard_normal((24, dim))),
                                 timestamps=np.arange(24.0)))
    for i in range(8):
        f = normed(rng.standard_normal((20, dim)))
        if i < 4:  # planted copies
            f[5:15] = refs[i].feature[3:13]
            gt.append(Match(query_id=f"Q{i:06d}", ref_id=f"R{i:06d}", score=1.0,
                            query_start=5.0, query_end=15.0, ref_start=3.0, ref_end=13.0))
        queries.append(VideoFeature(video_id=f"Q{i:06d}", feature=f, timestamps=np.arange(20.0)))
        cands.append((f"Q{i:06d}", f"R{i:06d}"))
        cands.append((f"Q{i:06d}", f"R{(i + 4) % 8:06d}"))
    for i in range(6):
        noise.append(VideoFeature(video_id=f"R{100 + i:06d}",
                                  feature=normed(rng.standard_normal((24, dim))),
                                  timestamps=np.arange(24.0)))
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("q", "r", "noise")}
    for k, v in (("q", queries), ("r", refs), ("noise", noise)):
        store_features(paths[k], v)
    paths["gt"] = str(tmp_path / "gt.csv")
    Match.write_csv(gt, paths["gt"])
    paths["cands"] = str(tmp_path / "cands.csv")
    _write_rows(paths["cands"], ["query_id", "ref_id", "score"], ([q, r, "1.0"] for q, r in cands))
    return paths, len(cands)


def test_training_cli_end_to_end(tmp_path):
    paths, n_cands = planted_corpus(tmp_path)
    run = tmp_path / "run"
    result = matching_cli.main([
        "--query_features", paths["q"], "--ref_features", paths["r"],
        "--candidates", paths["cands"], "--gt", paths["gt"], "--work_dir", str(run), "--tiny",
        "--cls_epochs", "8", "--refine_epochs", "4", "--cls_resolution", "32",
        "--refine_resolution", "32", "--cls_threshold", "0.0", "--lr", "3e-3", "--device", "cpu",
    ])
    scores = _read_rows(str(run / "candidate_scores.csv"))
    assert list(scores[0]) == ["query_id", "ref_id", "prob", "label"]
    assert len(scores) == 2 * n_cands  # each candidate's map and its transpose
    assert all(0.0 <= float(r["prob"]) <= 1.0 and r["label"] in ("0", "1") for r in scores)
    assert sum(r["label"] == "1" for r in scores) == 8
    matches = _read_rows(str(run / "val_matches.csv"))
    assert matches and list(matches[0]) == infer_cli.COLUMNS
    summary = json.loads((run / "summary.json").read_text())
    assert set(summary) == {"classify_ap", "segment_ap", "pairs"} and summary["pairs"] == n_cands
    assert result["classify_ap"] == summary["classify_ap"] and 0.0 <= summary["classify_ap"] <= 1.0
    assert result["match_file"] == str(run / "val_matches.csv")

    # The snapshots in the JAX package's loader (keys and shapes checked there).
    x = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    flax_cnn = FlaxTinyCNN()
    tiny_template = flax_cnn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    sam_template = jhrnet.sam_hrnet_tiny_test().init(jax.random.PRNGKey(0), jnp.asarray(x))
    def keys(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path)
                for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}

    for tag in ("h1", "h2"):
        for kind, template in (("classify", tiny_template), ("refine", sam_template)):
            with np.load(run / f"{kind}_{tag}.npz") as data:
                assert set(data.files) == keys(template), (kind, tag)
        variables = load_cnn_snapshot(str(run / f"classify_{tag}.npz"), tiny_template)
        want = np.asarray(flax_cnn.apply(variables, jnp.asarray(x)))
        port = matching_cli.TinyCNN()
        jax_params.load_entries(port.entries(), variables)
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        refine = load_cnn_snapshot(str(run / f"refine_{tag}.npz"), sam_template)
        assert jax.tree.structure(refine) == jax.tree.structure(sam_template)

    # The refine snapshots drive the port's inference CLI.
    out = tmp_path / "infer.csv"
    infer_cli.main(["--query_features", paths["q"], "--ref_features", paths["r"],
                    "--norm_refs", paths["noise"], "--out", str(out), "--tiny", "--device", "cpu",
                    "--refine_params", str(run / "refine_h1.npz"), str(run / "refine_h2.npz")])
    assert out.read_text().splitlines()[0].split(",") == infer_cli.COLUMNS


def test_cross_fold_predictions_match_jax():
    """`cross_fold_classify_predict` (TinyCNN) and `cross_fold_refine_predict`
    (the tiny SAM; the port batches each fold's pairs, JAX runs them one
    at a time) on the same fold weights as the JAX CLI's functions: the
    same rows, probabilities and heatmaps within 1e-5."""
    from test_torch_matching_models import jax_variables
    from vsc22_tpu.train import matching_cli as jcli
    from vsc22_tpu.train.matching import CNNTrainState
    from vsc22_tpu_torch.models import hrnet

    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    meta, features, infos = [], [], []
    for i in range(5):
        q = rng.standard_normal((20 + i, 8)).astype(np.float32)
        r = rng.standard_normal((26 - i, 8)).astype(np.float32)
        meta.append((f"Q{i:06d}", f"R{i:06d}", q, r, []))
        features += [q @ r.T, (q @ r.T).T.copy()]
        infos += [[f"Q{i:06d}", f"R{i:06d}", i % 2]] * 2
    fold_a = {"Q000001", "Q000003"}
    jstates, pstates = {"cls": [], "sam": []}, {"cls": [], "sam": []}
    for seed in (0, 1):
        for kind, jmodel, port, last in (
                ("cls", FlaxTinyCNN(), matching_cli.TinyCNN(), "Dense_0"),
                ("sam", jhrnet.sam_hrnet_tiny_test(), hrnet.sam_hrnet_tiny_test(), "fuse2")):
            v = jax_variables(jmodel, x, seed=10 + seed, last=last)
            jstates[kind].append((jmodel, CNNTrainState(v["params"], v["batch_stats"], None)))
            entries = port.entries() if kind == "cls" else jax_params.sam_hrnet_entries(port)
            jax_params.load_entries(entries, v)
            pstates[kind].append((port, None))
    want = jcli.cross_fold_classify_predict(jstates["cls"], features, infos, fold_a, 32)
    got = matching_cli.cross_fold_classify_predict(pstates["cls"], features, infos, fold_a, 32)
    assert [r[:2] + r[3:] for r in got] == [
        (q, r, int(label)) for q, r, label in zip(want.query_id, want.ref_id, want.label)]
    np.testing.assert_allclose([r[2] for r in got], want.prob.to_numpy(), rtol=0, atol=1e-5)
    want = jcli.cross_fold_refine_predict(jstates["sam"], meta, fold_a, 32)
    got = matching_cli.cross_fold_refine_predict(pstates["sam"], meta, fold_a, 32, batch=2)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-5)
