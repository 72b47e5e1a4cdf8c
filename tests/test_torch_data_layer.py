"""The port's training data layer against the JAX package's on the CPU: the
record store both ways (and its native reader against the plain numpy
one), `build_frame_store`, every augmentation op and the four pipelines
bit for bit from the same `default_rng(seed)`, every dataset's `sample`,
and the first two epochs of both loaders at process counts 1 and 2.

The JAX side reads its stores with its numpy reader
(`vsc22_tpu.native.load_library` patched to None): its native library
builds unlocked, which races under parallel test workers."""

import functools
import inspect
import pickle
import queue

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vsc22_tpu.data import augment as jaug  # noqa: E402
from vsc22_tpu.data import datasets as jds  # noqa: E402
from vsc22_tpu.data import store as jstore  # noqa: E402
from vsc22_tpu.pipelines import preprocess as jpre  # noqa: E402
from vsc22_tpu_torch.data import augment as paug  # noqa: E402
from vsc22_tpu_torch.data import datasets as pds  # noqa: E402
from vsc22_tpu_torch.data import store as pstore  # noqa: E402
from vsc22_tpu_torch.pipelines import preprocess as ppre  # noqa: E402

H, W = 96, 128  # the augmentations' test image
SEEDS = range(20)


@pytest.fixture(autouse=True)
def jax_numpy_reader(monkeypatch):
    import vsc22_tpu.native

    monkeypatch.setattr(vsc22_tpu.native, "load_library", lambda: None)


def frames_of(seed: int, n: int, h: int = H, w: int = W):
    """n smooth RGB frames with noise (JPEG-friendly, not flat)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 255, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
    base = 0.4 * yy + 0.4 * xx + rng.uniform(0, 50, 3).astype(np.float32)
    return [np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
            for _ in range(n)]


VIDS = ["Q000000", "Q000001", "R000002", "R000003", "R000004"]


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    """A port-written frame store of 5 videos x 6 frames, 96x128."""
    path = str(tmp_path_factory.mktemp("store") / "frames.rec")
    pstore.FrameStore.build(
        path, [(v, ppre.encode_jpegs(frames_of(i, 6))) for i, v in enumerate(VIDS)])
    return path


# --- the record store -----------------------------------------------------------


def records(seed=3, n=17):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 300, n)
    sizes[4] = 0  # an empty record
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_record_store_reads_in_the_other_package(tmp_path, writer):
    recs = records()
    path = str(tmp_path / "r.rec")
    w = (jstore if writer == "jax" else pstore).RecordStoreWriter(path)
    for r in recs:
        w.append(r)
    w.close()
    port, jax_side = pstore.RecordStore(path), jstore.RecordStore(path)
    assert not jax_side.using_native
    assert len(port) == len(jax_side) == len(recs)
    assert [port[i] for i in range(len(recs))] == [jax_side[i] for i in range(len(recs))] == recs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frame_store_reads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "f.rec")
    videos = [(v, ppre.encode_jpegs(frames_of(i, 2 + i))) for i, v in enumerate(VIDS[:3])]
    (jstore if writer == "jax" else pstore).FrameStore.build(path, videos)
    port, jax_side = pstore.FrameStore(path), jstore.FrameStore(path)
    assert port.vids == jax_side.vids == VIDS[:3]
    np.testing.assert_array_equal(port.intervals, jax_side.intervals)
    for v in port.vids:
        assert port.num_frames(v) == jax_side.num_frames(v)
        for f in range(port.num_frames(v)):
            assert port.get_frame_bytes(v, f) == jax_side.get_frame_bytes(v, f)
            np.testing.assert_array_equal(port.get_frame(v, f), jax_side.get_frame(v, f))


def test_native_reader_equals_plain_reader(tmp_path):
    recs = records(seed=5, n=40)
    path = str(tmp_path / "r.rec")
    with pstore.RecordStoreWriter(path) as w:
        for r in recs:
            w.append(r)
    native, plain = pstore.RecordStore(path), pstore.NumpyRecordReader(path)
    assert len(native) == len(plain) == 40
    assert [native[i] for i in range(40)] == [plain[i] for i in range(40)]
    idx = np.random.default_rng(0).integers(0, 40, 64)
    for threads in (1, 4):
        assert native.read_batch(idx, threads) == plain.read_batch(idx) == [recs[i] for i in idx]
    assert native.read_batch([]) == []
    native.close()


def test_out_of_range_reads_raise(tmp_path, store_path):
    path = str(tmp_path / "r.rec")
    with pstore.RecordStoreWriter(path) as w:
        for r in records(n=5):
            w.append(r)
    for reader in (pstore.RecordStore(path), pstore.NumpyRecordReader(path)):
        for i in (-1, 5, 100):
            with pytest.raises(IndexError):
                reader[i]
        with pytest.raises(IndexError):
            reader.read_batch([0, 5])
    fs = pstore.FrameStore(store_path)
    with pytest.raises(IndexError):
        fs.get_frame_bytes("Q000000", 6)
    with pytest.raises(IndexError):
        fs.get_frame_bytes("Q000000", -1)


def test_record_store_raises_without_its_library(tmp_path, monkeypatch, store_path):
    """No fallback: a missing library, a foreign file or a truncated one
    raise, where the JAX class would read with numpy."""
    from vsc22_tpu_torch.kernels import build

    def no_gxx(name):
        raise RuntimeError("g++ not found: the host library cannot be built here")

    with monkeypatch.context() as m:
        m.setattr(build, "host_library", no_gxx)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            pstore.RecordStore(store_path)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            pstore.FrameStore(store_path)
    foreign = tmp_path / "foreign.rec"
    foreign.write_bytes(b"NOTASTORE" * 4)
    with pytest.raises(ValueError, match="cannot be opened"):
        pstore.RecordStore(str(foreign))
    whole = open(store_path, "rb").read()
    truncated = tmp_path / "truncated.rec"
    truncated.write_bytes(whole[: len(whole) // 2])
    with pytest.raises(ValueError, match="cannot be opened"):
        pstore.RecordStore(str(truncated))


def test_frame_store_pickles_by_path(store_path):
    fs = pstore.FrameStore(store_path)
    back = pickle.loads(pickle.dumps(fs))
    assert back.vids == fs.vids and back.get_frame_bytes("R000003", 2) == \
        fs.get_frame_bytes("R000003", 2)


def test_build_frame_store_matches_jax(tmp_path, monkeypatch):
    """Both packages' `build_frame_store` over the same decoded frames (one
    video failing to decode is skipped), threaded: the same store file,
    byte for byte, and the same jpg zips; then the port's CLI."""
    decoded = {f"/videos/{v}.mp4": frames_of(i, 3) for i, v in enumerate(VIDS)}
    decoded["/videos/R000003.mp4"] = []  # a video that fails
    fake = lambda path, fps=1.0, timeout_s=60.0: decoded[path]  # noqa: E731
    monkeypatch.setattr(jpre, "read_frames", fake)
    monkeypatch.setattr(ppre, "read_frames", fake)
    pairs = [(v, f"/videos/{v}.mp4") for v in VIDS]
    out = {}
    for name, mod in (("jax", jpre), ("port", ppre)):
        root = tmp_path / name
        root.mkdir()
        fs = mod.build_frame_store(pairs, str(root / "f.rec"), workers=3,
                                   jpg_zip_root=str(root / "zips"))
        assert fs.vids == ["Q000000", "Q000001", "R000002", "R000004"]
        out[name] = root
    for rel in ("f.rec", "zips/00/Q000000.zip", "zips/04/R000004.zip"):
        if rel.endswith(".zip"):
            zj, zp = (pstore.ZipFrameStore(str(out[k] / "zips")) for k in ("jax", "port"))
            vid = rel.split("/")[-1][:-4]
            for a, b in zip(zj.read_video(vid), zp.read_video(vid)):
                np.testing.assert_array_equal(a, b)
        else:
            assert (out["jax"] / rel).read_bytes() == (out["port"] / rel).read_bytes()
    meta = [np.load(str(out[k] / "f.rec.meta.npz")) for k in ("jax", "port")]
    for key in ("vids", "intervals"):
        np.testing.assert_array_equal(meta[0][key], meta[1][key])

    video_dir = tmp_path / "videos"
    video_dir.mkdir()
    for v in VIDS:
        (video_dir / f"{v}.mp4").write_bytes(b"")
    by_file = {str(video_dir / f"{v}.mp4"): decoded[f"/videos/{v}.mp4"] for v in VIDS}
    monkeypatch.setattr(ppre, "read_frames", lambda path, fps, timeout_s: by_file[path])
    fs = ppre.main(["--videos", str(video_dir), "--store", str(tmp_path / "cli.rec"),
                    "--workers", "2"])
    assert (tmp_path / "cli.rec").read_bytes() == (out["jax"] / "f.rec").read_bytes()
    assert len(fs.store) == 12


# --- augmentations -------------------------------------------------------------


def op_cases():
    """{name: factory(module, frame_source) -> op} for every op at p=1."""
    return {
        "HorizontalFlip": lambda m, fs: m.HorizontalFlip(p=1),
        "VerticalFlip": lambda m, fs: m.VerticalFlip(p=1),
        "RandomRotate90": lambda m, fs: m.RandomRotate90(p=1),
        "RandomResizedCrop": lambda m, fs: m.RandomResizedCrop(64, 64, scale=(0.5, 1), p=1),
        "RandomScale": lambda m, fs: m.RandomScale(p=1),
        "Rotate": lambda m, fs: m.Rotate(45, p=1),
        "Perspective": lambda m, fs: m.Perspective(p=1),
        "AspectRatio": lambda m, fs: m.AspectRatio(p=1),
        "CropAndPad_pad": lambda m, fs: m.CropAndPad(percent=(0.0, 0.4), p=1),
        "CropAndPad_crop": lambda m, fs: m.CropAndPad(percent=(-0.4, 0.0), p=1),
        "GaussNoise": lambda m, fs: m.GaussNoise(p=1),
        "GaussianBlur": lambda m, fs: m.GaussianBlur(p=1),
        "ImageCompression": lambda m, fs: m.ImageCompression(20, 100, p=1),
        "ColorJitter": lambda m, fs: m.ColorJitter(p=1),
        "RandomBrightness": lambda m, fs: m.RandomBrightness(p=1),
        "ToGray": lambda m, fs: m.ToGray(p=1),
        "HueSaturationValue": lambda m, fs: m.HueSaturationValue(p=1),
        "RandomBrightnessContrast": lambda m, fs: m.RandomBrightnessContrast(p=1),
        "RandomSnow": lambda m, fs: m.RandomSnow(p=1),
        "Opacity": lambda m, fs: m.Opacity(p=1),
        "OverlayEmoji": lambda m, fs: m.OverlayEmoji(p=1),
        "SquareEmoji": lambda m, fs: m.SquareEmoji(p=1),
        "OverlayText": lambda m, fs: m.OverlayText(p=1),
        "RandomOverlayImages": lambda m, fs: m.RandomOverlayImages(fs, p=1),
        "RandomOverlayCorners": lambda m, fs: m.RandomOverlayCorners(fs, p=1),
        "RandomOverlayCorners_solid": lambda m, fs: m.RandomOverlayCorners(None, p=1),
        "RandomStackImages": lambda m, fs: m.RandomStackImages(fs, width=48, p=1),
        "OneOf": lambda m, fs: m.OneOf([m.ToGray(p=1), m.Rotate(p=1), m.Opacity(p=1)], p=1),
        "Compose": lambda m, fs: m.Compose([m.GaussNoise(p=0.5), m.HorizontalFlip(p=0.5)]),
        "RandomCompose": lambda m, fs: m.RandomCompose(
            [m.ToGray(p=0.5), m.Rotate(p=0.5), m.AspectRatio(p=0.5)]),
    }


def frame_source(pool):
    return lambda rng: pool[int(rng.integers(len(pool)))]


def test_every_op_is_ported():
    ops = lambda m: sorted(  # noqa: E731
        n for n, c in inspect.getmembers(m, inspect.isclass)
        if issubclass(c, m.Augmentation) and c.__module__ == m.__name__)
    assert ops(paug) == ops(jaug)
    covered = {name.split("_")[0] for name in op_cases()}
    assert covered == set(ops(jaug)) - {"Augmentation"}


@pytest.mark.parametrize("name", sorted(op_cases()))
def test_op_matches_jax_bit_for_bit(name):
    make = op_cases()[name]
    pool = frames_of(99, 3, 72, 100)
    ops = {m.__name__: make(m, frame_source(pool)) for m in (jaug, paug)}
    for seed in range(6):
        img = frames_of(seed, 1)[0]
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        want = ops[jaug.__name__](img.copy(), rj)
        got = ops[paug.__name__](img.copy(), rp)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert rp.bit_generator.state == rj.bit_generator.state  # the same draws


def pipelines(m, pool):
    hard = m.build_hard_pipelines(64, crop=0.5, mixup=0.5, frame_source=frame_source(pool))
    return {"hard1": hard[0], "hard2": hard[1], "easy": m.build_easy_pipeline(64, crop=0.5),
            "native": m.build_native_pipeline(64, crop=0.5)}


@pytest.mark.parametrize("which", ["hard1", "hard2", "easy", "native"])
def test_pipeline_matches_jax_bit_for_bit(which):
    pool = frames_of(98, 4, 72, 100)
    pj, pp = pipelines(jaug, pool)[which], pipelines(paug, pool)[which]
    shapes = set()
    for seed in SEEDS:
        img = frames_of(100 + seed, 1)[0]
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        want, got = pj(img.copy(), rj), pp(img.copy(), rp)
        np.testing.assert_array_equal(got, want)
        assert rp.bit_generator.state == rj.bit_generator.state
        shapes.add(got.shape)
    assert (64, 64, 3) in shapes


# --- datasets and loaders ------------------------------------------------------

# The labeled sampler's three branches: annotated videos (Q000000 and
# R000002), a Q-prefixed one (Q000001) and plain ones (R000003, R000004);
# the last row names a video the store lacks, and is dropped.
ANN = [["Q000000", "R000002", 1.0, 5.0, 0.0, 4.0], ["Q000000", "R000004", 0, 3, 2, 5],
       ["Q000009", "R000002", 0.0, 3.0, 2.0, 5.0]]
KWARGS = dict(width=48, preset="efficientnet", crop=0.5, mixup=0.3, probs=(0.6, 0.4))


def make_dataset(mod, store_mod, path, kind):
    fs = store_mod.FrameStore(path)
    if kind == "pair":
        return mod.FramePairDataset(fs, **KWARGS)
    if kind == "labeled":
        return mod.LabeledFramePairDataset(fs, ANN, **KWARGS)
    if kind == "overlay":
        return mod.OverlayImagePairDataset(fs, overlay_prob=0.5, vids=VIDS[1:4], **KWARGS)
    if kind == "concat":
        return mod.ConcatDataset([mod.FramePairDataset(fs, vids=VIDS[:2], **KWARGS),
                                  mod.LabeledFramePairDataset(fs, ANN, **KWARGS)])
    raise ValueError(kind)


def assert_same_batch(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["pair", "labeled", "overlay", "concat"])
def test_dataset_samples_match_jax_bit_for_bit(store_path, kind):
    dj = make_dataset(jds, jstore, store_path, kind)
    dp = make_dataset(pds, pstore, store_path, kind)
    assert len(dj) == len(dp)
    if kind == "labeled":
        assert sorted(dp.ann) == ["Q000000", "R000002", "R000004"]
    for seed in range(2):
        rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
        for idx in range(len(dp)):
            assert_same_batch(dp.sample(idx, rp), dj.sample(idx, rj))
        assert rp.bit_generator.state == rj.bit_generator.state


def test_feature_sequence_dataset_matches_jax():
    rng = np.random.default_rng(0)
    feats = {f"V{i}": rng.standard_normal((int(rng.integers(3, 12)), 5)).astype(np.float32)
             for i in range(6)}
    dj = jds.FeatureSequenceDataset(feats, ["V1", "V4"], max_frames=8)
    dp = pds.FeatureSequenceDataset(feats, ["V1", "V4"], max_frames=8)
    assert len(dp) == len(dj) == 6
    for i in range(6):
        g, w = dp.sample(i), dj.sample(i)
        assert g["vid"] == w["vid"] and g["label"] == w["label"]
        np.testing.assert_array_equal(g["feats"], w["feats"])


def test_resize_norm_host_matches_jax():
    for img in frames_of(7, 3, 90, 70):
        for preset in ("vit", "imagenet", "clip"):
            np.testing.assert_array_equal(pds._resize_norm_host(img, 64, preset),
                                          jds._resize_norm_host(img, 64, preset))


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_threaded_loader_matches_jax(store_path, process_index, process_count):
    kw = dict(batch_size=3, seed=11, num_workers=1, process_index=process_index,
              process_count=process_count)
    lj = jds.DataLoader(make_dataset(jds, jstore, store_path, "labeled"), **kw)
    lp = pds.DataLoader(make_dataset(pds, pstore, store_path, "labeled"), **kw)
    for epoch in (0, 1):
        want, got = list(lj.epoch(epoch)), list(lp.epoch(epoch))
        assert len(got) == len(want) == 30 // process_count // 3
        for g, w in zip(got, want):
            assert_same_batch(g, w)


def jax_process_batches(path, epoch, num_workers, **kw):
    """The JAX `ProcessDataLoader`'s batches of `epoch`: its spawned
    worker's function run in this process for each worker id, reordered
    as the loader yields them."""
    q = queue.Queue()
    factory = functools.partial(make_dataset, jds, jstore, path, "pair")
    for w in range(num_workers):
        jds._process_loader_worker(factory, w, num_workers, kw["batch_size"], kw["seed"],
                                   epoch, True, kw["process_index"], kw["process_count"],
                                   True, q)
    out = {}
    while not q.empty():
        tag, payload = q.get()
        assert tag != "error", payload
        if tag != "done":
            out[tag] = payload
    return [out[i] for i in sorted(out)]


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_process_loader_matches_jax(store_path, process_index, process_count):
    """The port's `ProcessDataLoader` with 2 spawned workers (the factory
    pickles the store by path) gives the JAX loader's batches."""
    kw = dict(batch_size=4, seed=5, process_index=process_index, process_count=process_count)
    factory = functools.partial(pds.FramePairDataset, pstore.FrameStore(store_path), **KWARGS)
    loader = pds.ProcessDataLoader(factory, num_workers=2, dataset_len=30, **kw)
    for epoch in (0, 1):
        want = jax_process_batches(store_path, epoch, 2, **kw)
        got = list(loader.epoch(epoch))
        assert len(got) == len(want) == (30 // process_count) // 4
        for g, w in zip(got, want):
            assert_same_batch(g, w)
