"""The port's offline CLIs against the JAX package's, on the same mp4 files
and the same JAX npz snapshots, f32 tiny models on the CPU: `ref_cli` (two
shards and the merge) for a tiny ViT and a tiny SwinV2 member,
`ensemble_cli` (PCA fit, projection, mutual ref score-norm), `query_cli`
(FSD, the ensemble, dedup, PCA, query score-norm against the fused train
refs), `clip_features`' zip; `read_frames`, the PCA npz both ways, and the
`dev_tools` flows. The JAX side runs with OpenCV's IPP route off
(`cv2.ipp.setUseIPP`), whose resize rounds ~4% of values one level off
OpenCV's generic arithmetic, which the port computes."""

import io
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_torch_swinv2 import randomized_params  # noqa: E402
from vsc22_tpu.core.storage import load_features, store_features  # noqa: E402
from vsc22_tpu.core.types import VideoFeature  # noqa: E402
from vsc22_tpu.data import frames as jframes  # noqa: E402
from vsc22_tpu.models.clip import clip_tiny_test  # noqa: E402
from vsc22_tpu.models.swinv2 import SWINV2_TINY_TEST, SwinTransformerV2  # noqa: E402
from vsc22_tpu.models.vit import vit_tiny_test_descriptor  # noqa: E402
from vsc22_tpu.ops import pca as jpca  # noqa: E402
from vsc22_tpu.pipelines import clip_features as jclip  # noqa: E402
from vsc22_tpu.pipelines import dev_tools as jdev  # noqa: E402
from vsc22_tpu.pipelines import ensemble_cli as jens  # noqa: E402
from vsc22_tpu.pipelines import query_cli as jquery  # noqa: E402
from vsc22_tpu.pipelines import ref_cli as jref  # noqa: E402
from vsc22_tpu.train.checkpoint import save_ema_snapshot  # noqa: E402
from vsc22_tpu_torch.data import frames as pframes  # noqa: E402
from vsc22_tpu_torch.models import clip as pclip_models  # noqa: E402
from vsc22_tpu_torch.ops import pca as ppca  # noqa: E402
from vsc22_tpu_torch.pipelines import clip_features as pclip  # noqa: E402
from vsc22_tpu_torch.pipelines import dev_tools as pdev  # noqa: E402
from vsc22_tpu_torch.pipelines import ensemble_cli as pens  # noqa: E402
from vsc22_tpu_torch.pipelines import query_cli as pquery  # noqa: E402
from vsc22_tpu_torch.pipelines import ref_cli as pref  # noqa: E402
from vsc22_tpu_torch.utils import jax_params  # noqa: E402

FEAT_TOL = 1e-3  # f32 descriptors: the bar of tests/test_ref_parity.py
PCA_TOL = 1e-4  # the port fits in float64, JAX in float32 (ROADMAP §C)
FPS = "4"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: these tests run beside other test workers,
    and the Canny flood's many small ops thrash an oversubscribed pool."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def write_video(path, seed, n_seconds=4, size=(64, 48), letterbox=False):
    """8 fps of moving-gradient content with noise (each frame differs)."""
    rng = np.random.default_rng(seed)
    w, h = size
    base = (np.linspace(0, 160, h)[:, None, None] + np.linspace(0, 80, w)[None, :, None])
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8, size)
    for t in range(8 * n_seconds):
        f = np.clip(base + 40 * np.sin(seed + t / 3) + rng.normal(0, 25, (h, w, 3)), 0, 255)
        f = f.astype(np.uint8)
        if letterbox:
            f[: h // 6] = 0
            f[h - h // 6 :] = 0
        out.write(f)
    out.release()


@pytest.fixture(scope="module")
def ipp_off():
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(saved)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline")
    dirs = {k: root / k for k in ("train", "test", "query")}
    for d in dirs.values():
        d.mkdir()
    for i in range(4):
        write_video(dirs["train"] / f"{i:06d}.mp4", seed=i)
    for i in range(2):
        write_video(dirs["test"] / f"R{100 + i:06d}.mp4", seed=100 + i)
    for i in range(3):
        write_video(dirs["query"] / f"Q{i:06d}.mp4", seed=200 + i, letterbox=i == 1)
    vit_j = vit_tiny_test_descriptor()
    vit_p = jax.device_get(vit_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    swin_j = SwinTransformerV2(cfg=SWINV2_TINY_TEST)
    swin_init = swin_j.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)))
    swin_p = {"params": randomized_params(swin_init["params"], 12)}
    specs = {}
    for name, params, size in (("vit", vit_p, 64), ("swin", swin_p, 32)):
        path = str(root / f"{name}.params.npz")
        save_ema_snapshot(path, types.SimpleNamespace(params=params, ema_params=None))
        kind = "vit_tiny_test" if name == "vit" else "swinv2_tiny_test"
        specs[name] = f"{kind}:{path}:{size}:vit"
    return dict(root=root, dirs=dirs, specs=specs)


def run_ref_cli(module, files, out, split, model, extra=()):
    """Both shards of a two-process run, then the merge (process 0's)."""
    argv = ["--videos", str(files["dirs"][split]), "--out", str(out),
            "--model", files["specs"][model], "--fps", FPS, *extra]
    module.main(argv + ["--process_index", "1", "--process_count", "2", "--no_merge"])
    return module.main(argv + ["--process_index", "0", "--process_count", "2"])


@pytest.fixture(scope="module")
def flow(files, ipp_off):
    """The offline flow in each package: ref_cli for each member over the
    train and test videos, ensemble_cli, query_cli with the fitted PCA and
    the fused train refs as the noise corpus. Both packages' ensemble_cli
    and query_cli read the JAX package's ref files, so each step is
    compared on the same inputs."""
    root = files["root"]
    out = {}
    for pkg, ref_mod, ens_mod, query_mod, extra in (
        ("jax", jref, jens, jquery, ()), ("port", pref, pens, pquery, ("--device", "cpu")),
    ):
        (root / pkg).mkdir()
        refs = {(split, m): run_ref_cli(ref_mod, files, root / pkg / f"{m}_{split}_refs",
                                        split, m, extra)
                for split in ("train", "test") for m in ("vit", "swin")}
        out[pkg] = dict(refs=refs)
    jrefs = out["jax"]["refs"]
    for pkg, ens_mod, query_mod, extra in (("jax", jens, jquery, ()),
                                           ("port", pens, pquery, ("--device", "cpu"))):
        fused = root / pkg / "fused"
        ens_mod.main(["--train_refs", jrefs["train", "vit"], jrefs["train", "swin"],
                      "--test_refs", jrefs["test", "vit"], jrefs["test", "swin"],
                      "--out_dir", str(fused), "--components", "8", *extra])
        out[pkg]["fused"] = fused
        out[pkg]["query"] = query_mod.main(
            ["--videos", str(files["dirs"]["query"]), "--out_dir", str(root / pkg / "query"),
             "--model", f"m1:{files['specs']['vit']}", "--model", f"m2:{files['specs']['swin']}",
             "--pca", str(root / "jax" / "fused" / "pca_model.npz"),
             "--norm_refs", str(root / "jax" / "fused" / "train_refs.npz"), "--fps", FPS,
             *extra])
        out[pkg]["query_dir"] = root / pkg / "query"
    return out


def assert_same_features(got_path, want_path, tol=FEAT_TOL):
    got, want = load_features(str(got_path)), load_features(str(want_path))
    assert [f.video_id for f in got] == [f.video_id for f in want] and got
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        assert g.feature.shape == w.feature.shape
        np.testing.assert_allclose(g.feature, w.feature, atol=tol, rtol=0)


@pytest.mark.parametrize("key", [("train", "vit"), ("train", "swin"), ("test", "vit"),
                                 ("test", "swin")], ids="-".join)
def test_ref_cli_two_shards_and_merge(flow, key):
    assert_same_features(flow["port"]["refs"][key], flow["jax"]["refs"][key])
    ids = [f.video_id for f in load_features(flow["port"]["refs"][key])]
    assert ids == sorted(ids) and all(v.startswith("R") for v in ids)


def test_ensemble_cli_pca(flow):
    want = jpca.PCAModel.load(str(flow["jax"]["fused"] / "pca_model.npz"))
    got = ppca.PCAModel.load(str(flow["port"]["fused"] / "pca_model.npz"))
    np.testing.assert_allclose(got.mean, want.mean, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.components, want.components, atol=PCA_TOL, rtol=0)
    np.testing.assert_allclose(got.explained_variance, want.explained_variance,
                               rtol=PCA_TOL, atol=1e-7)


@pytest.mark.parametrize("name", ["train_refs", "test_refs", "train_refs_sn", "test_refs_sn"])
def test_ensemble_cli_outputs(flow, name):
    assert_same_features(flow["port"]["fused"] / f"{name}.npz",
                         flow["jax"]["fused"] / f"{name}.npz")


def test_query_cli_outputs(flow):
    assert_same_features(flow["port"]["query"], flow["jax"]["query"])
    for m in ("m1", "m2"):
        assert_same_features(flow["port"]["query_dir"] / m / "test_query.npz",
                             flow["jax"]["query_dir"] / m / "test_query.npz")


def test_pca_npz_loads_in_both_packages(tmp_path):
    x = np.random.default_rng(0).standard_normal((64, 12)).astype(np.float32)
    jm, pm = jpca.pca_fit(x, 4), ppca.pca_fit(x, 4, "cpu")
    jm.save(str(tmp_path / "j.npz"))
    pm.save(str(tmp_path / "p.npz"))
    for mod, path, src in ((ppca, "j.npz", jm), (jpca, "p.npz", pm)):
        back = mod.PCAModel.load(str(tmp_path / path))
        for field in ("mean", "components", "explained_variance"):
            np.testing.assert_array_equal(getattr(back, field), getattr(src, field))


def test_read_frames_same_frames(files):
    for path in sorted(files["dirs"]["query"].iterdir()):
        want = jframes.read_frames(str(path), fps=2.0)
        got = pframes.read_frames(str(path), fps=2.0)
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert pframes.read_frames(str(files["root"] / "missing.mp4")) == []


def test_read_frames_raises_without_a_backend(monkeypatch, files):
    monkeypatch.setattr(pframes, "_cv2", lambda: None)
    monkeypatch.setattr(pframes, "ffmpeg_binary", lambda: None)
    with pytest.raises(RuntimeError, match="no video decoder"):
        pframes.read_frames(str(next(files["dirs"]["query"].iterdir())))


def test_clis_default_to_the_card(files, tmp_path):
    if torch.cuda.is_available():
        return
    for run in (
        lambda: pref.main(["--videos", str(files["dirs"]["test"]), "--out", str(tmp_path / "r"),
                           "--model", files["specs"]["vit"]]),
        lambda: pquery.main(["--videos", str(files["dirs"]["query"]), "--out_dir",
                             str(tmp_path / "q"), "--model", f"m:{files['specs']['vit']}",
                             "--norm_refs", "unused.npz"]),
        lambda: pens.main(["--train_refs", "a.npz", "--test_refs", "b.npz", "--out_dir",
                           str(tmp_path / "e")]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_clip_features_zip(files, ipp_off, tmp_path):
    model = clip_tiny_test()
    params = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    videos = [(p.stem, jframes.read_frames(str(p), fps=2.0))
              for p in sorted(files["dirs"]["query"].iterdir())]
    want_path = jclip.extract_clip_features(
        videos, jclip.ClipFeatureExtractor(model, params, chunk=4), str(tmp_path / "j.zip"))
    pm = jax_params.load_clip_visual(pclip_models.clip_tiny_test(), params)
    got_path = pclip.extract_clip_features(
        videos, pclip.ClipFeatureExtractor(pm, chunk=4, device="cpu"), str(tmp_path / "p.zip"))
    with zipfile.ZipFile(got_path) as g, zipfile.ZipFile(want_path) as w:
        assert g.namelist() == w.namelist()
        for name in w.namelist():
            gb, wb = g.read(name), w.read(name)
            assert gb[:128] == wb[:128]  # the .npy header: dtype <f2, shape
            np.testing.assert_allclose(np.load(io.BytesIO(gb)).astype(np.float32),
                                       np.load(io.BytesIO(wb)).astype(np.float32),
                                       atol=2e-3, rtol=2e-3)  # f16 of f32 within 1e-6
    back = pclip.read_feats_zip(want_path)
    want = jclip.read_feats_zip(want_path)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


# --- dev_tools ------------------------------------------------------------------


def _features(n=4, rows=6, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = rng.standard_normal((rows, dim)).astype(np.float32)
        f[1] = f[0] + 1e-3  # a near duplicate
        out.append(VideoFeature(video_id=f"Q{i:06d}", timestamps=np.arange(rows, dtype=np.float32),
                                feature=f))
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.video_id == w.video_id
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        np.testing.assert_array_equal(g.feature, w.feature)


def test_dev_tools_filter_and_dedup():
    feats = _features()
    scores = {"Q000000": 0.05, "Q000001": 0.5, "Q000003": 0.01}
    _same(pdev.filter_features_by_score(feats, scores, 0.1, seed=3),
          jdev.filter_features_by_score(feats, scores, 0.1, seed=3))
    got, n_got = pdev.dedup_video_features(feats, 0.95)
    want, n_want = jdev.dedup_video_features(feats, 0.95)
    assert n_got == n_want > 0
    _same(got, want)


@pytest.mark.parametrize("stack", [False, True])
def test_dev_tools_refine_subimages(stack):
    feats = _features()
    rng = np.random.default_rng(1)
    sub = {"Q000001": rng.standard_normal((6, 3, 8)).astype(np.float32)}
    weights = {"Q000001": rng.standard_normal((3, 6, 1)).astype(np.float32)}
    _same(pdev.refine_subimage_features(feats, sub, weights, stack=stack),
          jdev.refine_subimage_features(feats, sub, weights, stack=stack))


def test_dev_tools_zips(tmp_path):
    rng = np.random.default_rng(2)
    items = [(f"k{i}", rng.integers(0, 255, (5, 4, 4, 3), dtype=np.uint8)) for i in range(5)]

    def emb(frames):
        return frames.reshape(len(frames), -1).mean(axis=1, keepdims=True)

    def overlay(frames):
        return frames.mean(axis=(1, 2, 3)), frames[..., 0].astype(np.float32)

    for k in range(2):
        for mod, tag in ((pdev, "p"), (jdev, "j")):
            mod.extract_features_to_zip(items, emb, str(tmp_path / f"{tag}{k}.zip"), k, 2)
            mod.extract_overlay_maps(items, overlay, str(tmp_path / f"{tag}o{k}.zip"), k, 2,
                                     chunk=2)
    for tag, mod in (("p", pdev), ("j", jdev)):
        assert mod.merge_feature_zips([str(tmp_path / f"{tag}{k}.zip") for k in range(2)],
                                      str(tmp_path / f"{tag}.zip")) == 5
    for a, b in (("p.zip", "j.zip"), ("po0.zip", "jo0.zip"), ("po1.zip", "jo1.zip")):
        with zipfile.ZipFile(tmp_path / a) as g, zipfile.ZipFile(tmp_path / b) as w:
            assert g.namelist() == w.namelist()
            for name in w.namelist():
                assert g.read(name) == w.read(name)
    np.testing.assert_array_equal(pdev.read_feature_zip(str(tmp_path / "j.zip"), "k3"),
                                  jdev.read_feature_zip(str(tmp_path / "p.zip"), "k3"))
