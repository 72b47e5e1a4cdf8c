"""Snapshots of the legacy zoo across the two packages, and `query_cli` with
legacy members, on the CPU:
- a BatchNorm member (`efficientnet_tiny_test`) and a plain one
  (`swin_v1_tiny_test`), each written by the port and read by the JAX
  package's `load_params_snapshot` (into the whole variables tree, as the
  JAX `query_cli` reads a member) or `load_cnn_snapshot`, and written by
  the JAX package and read by the port's `load_params_snapshot` (running
  statistics included) or `load_cnn_snapshot`: the same descriptors;
- the JAX and the port `query_cli` on the same mp4 files with the three
  tiny legacy descriptor members (Swin v1, EfficientNet, MAE) from the same
  JAX npz snapshots: the same per-member and fused query features.
"""

import types

import jax
import numpy as np
import pytest
import torch

from test_torch_legacy_models import apply, init, lively
from vsc22_tpu.core.storage import load_features, store_features
from vsc22_tpu.core.types import VideoFeature
from vsc22_tpu.models import efficientnet as jeff
from vsc22_tpu.models import mae as jmae
from vsc22_tpu.models import swin_v1 as jswin
from vsc22_tpu.pipelines import query_cli as jquery
from vsc22_tpu.train import checkpoint as jckpt
from vsc22_tpu_torch.models import efficientnet, swin_v1
from vsc22_tpu_torch.pipelines import query_cli as pquery
from vsc22_tpu_torch.train import checkpoint as tckpt
from vsc22_tpu_torch.train import contrastive as tc
from vsc22_tpu_torch.utils import jax_params

DESC_TOL = 1e-5  # f32 descriptors, the same arithmetic on both sides
FEAT_TOL = 1e-3  # f32 query features: the bar of tests/test_torch_offline_cli.py

MEMBERS = {  # name: (JAX model, port constructor, loader)
    "eff": (jeff.efficientnet_tiny_test, efficientnet.efficientnet_tiny_test,
            jax_params.load_efficientnet),
    "swin1": (jswin.swin_v1_tiny_test, swin_v1.swin_v1_tiny_test, jax_params.load_swin_v1),
}


def images(seed):
    return np.random.default_rng(seed).standard_normal((3, 32, 32, 3)).astype(np.float32)


def port_forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name,writer", [("eff", "ema"), ("eff", "cnn"), ("swin1", "ema")])
def test_port_snapshot_reads_in_jax(tmp_path, name, writer):
    """The port's `save_ema_snapshot` (of a train state's masters; a
    BatchNorm member's running statistics beside them) read by the JAX
    `load_params_snapshot` into `model.init`'s whole tree, as the JAX
    `query_cli` reads a member, or its `save_cnn_snapshot` read by
    `load_cnn_snapshot`: the JAX model gives the port's descriptors."""
    make_j, make_p, load = MEMBERS[name]
    x = images(1)
    jm = make_j()
    pm = load(make_p(), lively(init(jm, x), 2))
    path = str(tmp_path / "port.npz")
    if writer == "ema":
        state, _ = tc.create_train_state(pm, tc.ContrastiveConfig())
        tckpt.save_ema_snapshot(path, state, pm)
    else:
        tckpt.save_cnn_snapshot(path, pm)
    template = jax.device_get(init(jm, x))
    read = jckpt.load_params_snapshot if writer == "ema" else jckpt.load_cnn_snapshot
    variables = read(path, template)
    assert set(variables) == set(template)
    np.testing.assert_allclose(np.asarray(apply(jm, variables, x)), port_forward(pm, x),
                               atol=DESC_TOL, rtol=DESC_TOL)


@pytest.mark.parametrize("name", list(MEMBERS))
def test_jax_snapshot_reads_in_the_port(tmp_path, name):
    """The JAX package's snapshot of a member's variables (`save_cnn_snapshot`
    of a BatchNorm member's params and batch_stats, `save_ema_snapshot` of a
    plain one's) read by the port's `load_params_snapshot` into a fresh
    member, the running statistics too: the JAX model's descriptors, and
    masters a train state can start from."""
    make_j, make_p, _ = MEMBERS[name]
    x = images(3)
    jm = make_j()
    variables = lively(init(jm, x), 4)
    path = str(tmp_path / "jax.npz")
    if "batch_stats" in variables:
        jckpt.save_cnn_snapshot(path, variables["params"], variables["batch_stats"])
    else:
        jckpt.save_ema_snapshot(path, types.SimpleNamespace(params=variables, ema_params=None))
    pm = make_p()
    masters = tckpt.load_params_snapshot(path, pm)
    np.testing.assert_allclose(port_forward(pm, x), np.asarray(apply(jm, variables, x)),
                               atol=DESC_TOL, rtol=DESC_TOL)
    if name == "eff":
        np.testing.assert_array_equal(pm.stem_bn.var.numpy(),
                                      variables["batch_stats"]["stem_bn"]["var"])
        fresh = tckpt.load_cnn_snapshot(path, make_p())
        for (n, a), b in zip(pm.state_dict().items(), fresh.state_dict().values()):
            assert torch.equal(a, b), n
    state, _ = tc.create_train_state(pm, tc.ContrastiveConfig(), params=masters)
    assert all(torch.equal(state.params[n], p) for n, p in pm.named_parameters())


@pytest.fixture(scope="module")
def legacy_files(tmp_path_factory):
    """Three query mp4 files, JAX npz snapshots of the three tiny legacy
    members (an EfficientNet's with its batch_stats, as the JAX
    `query_cli` reads it) and a noise corpus of their fused width."""
    from test_torch_offline_cli import write_video

    root = tmp_path_factory.mktemp("legacy_cli")
    (root / "query").mkdir()
    for i in range(3):
        write_video(root / "query" / f"Q{i:06d}.mp4", seed=300 + i, letterbox=i == 1)
    x = np.zeros((1, 32, 32, 3), np.float32)
    specs, dim = [], 0
    for i, (name, jm, key, out_dim) in enumerate((
            ("swin1", jswin.swin_v1_tiny_test(), "swin_v1_tiny_test", 8),
            ("eff", jeff.efficientnet_tiny_test(), "efficientnet_tiny_test", 16),
            ("mae", jmae.mae_tiny_test(), "mae_tiny_test", 16))):
        variables = lively(init(jm, x), 20 + i)
        path = str(root / f"{name}.npz")
        if "batch_stats" in variables:
            jckpt.save_cnn_snapshot(path, variables["params"], variables["batch_stats"])
        else:
            jckpt.save_ema_snapshot(path, types.SimpleNamespace(params=variables,
                                                                ema_params=None))
        specs.append(f"{name}:{key}:{path}:32:efficientnet")
        dim += out_dim
    rng = np.random.default_rng(30)
    noise = [VideoFeature(f"R{i:06d}", np.arange(4.0), rng.standard_normal((4, dim)).astype(
        np.float32)) for i in range(6)]
    store_features(str(root / "noise.npz"), noise)
    return root, specs


@pytest.fixture(scope="module")
def legacy_queries(legacy_files):
    """`query_cli --model name:<legacy key>:<JAX npz>:32:efficientnet` x 3
    in both packages (the port on the CPU), FSD on, no PCA, OpenCV's IPP
    route off on the JAX side's decode and resize (the port computes
    OpenCV's generic arithmetic): {package: its fused output path}."""
    cv2 = pytest.importorskip("cv2")
    root, specs = legacy_files
    out = {}
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for pkg, module, extra in (("jax", jquery, ()), ("port", pquery, ("--device", "cpu"))):
            argv = ["--videos", str(root / "query"), "--out_dir", str(root / pkg),
                    "--norm_refs", str(root / "noise.npz"), "--fps", "4", *extra]
            for spec in specs:
                argv += ["--model", spec]
            out[pkg] = module.main(argv)
    finally:
        cv2.ipp.setUseIPP(saved)
    return root, out


@pytest.mark.parametrize("name", ["fused", "swin1", "eff", "mae"])
def test_query_cli_with_legacy_members(legacy_queries, name):
    """The same per-member features and score-normalized fused features."""
    root, out = legacy_queries
    if name == "fused":
        got, want = load_features(out["port"]), load_features(out["jax"])
    else:
        got, want = (load_features(str(root / pkg / name / "test_query.npz"))
                     for pkg in ("port", "jax"))
    assert [f.video_id for f in got] == [f.video_id for f in want] and len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        np.testing.assert_allclose(g.feature, w.feature, atol=FEAT_TOL, rtol=0)
