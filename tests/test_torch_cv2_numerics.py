"""The port's own OpenCV arithmetic against OpenCV: the INTER_CUBIC resize
of uint8 frames (`transforms.resize_cubic_u8` and the host twins on it)
and cv2.Canny(50, 400) on colour frames (`fsd.canny_edges`), then the
exact host FSD path built on them against the JAX package's.

OpenCV's resize takes Intel IPP's route by default, which rounds ~4% of
the values one level off OpenCV's own generic arithmetic; the port
follows the generic route, so the resize and everything after it are held
to cv2 with IPP switched off (a runtime switch of cv2, `cv2.ipp.setUseIPP`),
and to the IPP route at one level on at most 5% of the values."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vsc22_tpu.data import fsd as jfsd  # noqa: E402
from vsc22_tpu.data import transforms as jt  # noqa: E402
from vsc22_tpu_torch.data import fsd  # noqa: E402
from vsc22_tpu_torch.data import transforms as pt  # noqa: E402

H, W, N = 180, 320, 12


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: these tests run beside other test workers,
    and the Canny flood's many small ops thrash an oversubscribed pool."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def ipp_off():
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(saved)


# The edit-type corpus of `tests/test_fsd_fidelity.py` (a copy of its generator).


def _content(rng, n, h, w, noise=14.0):
    """Moving-gradient content with temporal noise (realistic variance)."""
    yy = np.linspace(0, 200, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 200, w, dtype=np.float32)[None, :, None]
    base = 0.5 * yy + 0.5 * xx + 20.0
    phase = rng.uniform(0, 2 * np.pi)
    frames = []
    for t in range(n):
        drift = 25.0 * np.sin(phase + 2 * np.pi * t / n)
        f = base + drift + rng.normal(0, noise, (h, w, 3))
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames


def _pad_into(frames, top, left, h=H, w=W, fill=0):
    out = []
    for f in frames:
        v = np.full((h, w, 3), fill, np.uint8)
        v[top : top + f.shape[0], left : left + f.shape[1]] = f
        out.append(v)
    return out


def make_video(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "plain":
        return _content(rng, N, H, W)
    if kind == "static":
        f = _content(rng, 1, H, W)[0]
        return [f.copy() for _ in range(N)]
    if kind == "letterbox":
        return _pad_into(_content(rng, N, H - 2 * (H // 6), W), H // 6, 0)
    if kind == "letterbox_gray":
        return _pad_into(_content(rng, N, H - 2 * (H // 5), W), H // 5, 0, fill=28)
    if kind == "pillarbox":
        return _pad_into(_content(rng, N, H, W - 2 * (W // 5)), 0, W // 5)
    if kind == "vstack":
        gap, half = 14, (H - 14) // 2
        a, b = _content(rng, N, half, W), _content(rng, N, half, W)
        return [np.concatenate([fa, np.zeros((gap, W, 3), np.uint8), fb,
                                np.zeros((H - 2 * half - gap, W, 3), np.uint8)])
                for fa, fb in zip(a, b)]
    if kind == "hstack":
        gap, half = 14, (W - 14) // 2
        a, b = _content(rng, N, H, half), _content(rng, N, H, half)
        return [np.concatenate([fa, np.zeros((H, gap, 3), np.uint8), fb,
                                np.zeros((H, W - 2 * half - gap, 3), np.uint8)], axis=1)
                for fa, fb in zip(a, b)]
    if kind == "grid2x2":
        gy, gx = 12, 12
        hh, hw = (H - gy) // 2, (W - gx) // 2
        quads = [_content(rng, N, hh, hw) for _ in range(4)]
        out = []
        for t in range(N):
            v = np.zeros((H, W, 3), np.uint8)
            v[:hh, :hw] = quads[0][t]
            v[:hh, hw + gx :] = quads[1][t][:, : W - hw - gx]
            v[hh + gy :, :hw] = quads[2][t][: H - hh - gy]
            v[hh + gy :, hw + gx :] = quads[3][t][: H - hh - gy, : W - hw - gx]
            out.append(v)
        return out
    if kind == "text_overlay":
        frames = _content(rng, N, H, W)
        y0 = H - 30
        for f in frames:
            for k in range(6):
                x0 = 20 + 45 * k
                f[y0 : y0 + 14, x0 : x0 + 30] = 245
        return frames
    raise ValueError(kind)


KINDS = [
    "plain", "static", "letterbox", "letterbox_gray", "pillarbox",
    "vstack", "hstack", "grid2x2", "text_overlay",
]


def test_corpus_copy_is_the_fidelity_corpus():
    from test_fsd_fidelity import make_video as reference

    for kind in KINDS:
        for a, b in zip(make_video(kind, 3), reference(kind, 3)):
            np.testing.assert_array_equal(a, b)


# --- the cubic resize -----------------------------------------------------------

# (in h, in w, out h, out w): the per-video path's shapes (360x640 to the
# members' squares, CLIP's shortest side, an FSD crop), upscales, odd
# sizes, tails of the 8-lane vector loop.
RESIZE_SHAPES = [
    (360, 640, 384, 384), (360, 640, 256, 256), (360, 640, 224, 398),
    (120, 640, 224, 1195), (148, 301, 256, 256), (48, 64, 64, 64), (48, 64, 32, 32),
    (100, 37, 224, 224), (13, 7, 5, 3), (57, 91, 223, 97),
]


def frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("shape", RESIZE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_is_cv2_generic_bit_for_bit(shape, ipp_off):
    """Every value equal (so also on random shapes:
    `scripts/torch_cv2_probe.py`)."""
    h, w, oh, ow = shape
    x = frames(2, h, w, seed=h * w)
    got = pt.resize_cubic_u8(torch.from_numpy(x), oh, ow).numpy()
    for i in range(2):
        want = cv2.resize(x[i], (ow, oh), interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(got[i], want)


def test_resize_against_cv2_ipp_route():
    """cv2's IPP route (its default) differs by one level on ~4% of the
    values at 360x640 -> 384^2 (`scripts/torch_cv2_probe.py` prints the
    share)."""
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(True)
    try:
        x = frames(1, 360, 640, seed=5)[0]
        want = cv2.resize(x, (384, 384), interpolation=cv2.INTER_CUBIC).astype(int)
    finally:
        cv2.ipp.setUseIPP(saved)
    got = pt.resize_cubic_u8(torch.from_numpy(x), 384, 384).numpy().astype(int)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.05


@pytest.mark.parametrize("preset", ["vit", "efficientnet", "imagenet"])
def test_host_twins_equal_jax_bit_for_bit(preset, ipp_off):
    for h, w in [(360, 640), (148, 301), (300, 200)]:
        img = frames(1, h, w, seed=h)[0]
        for size in (64, 224):
            np.testing.assert_array_equal(
                pt.resize_normalize_host(img, size, preset).numpy(),
                jt.resize_normalize_host(img, size, preset))
        np.testing.assert_array_equal(pt.clip_preprocess_host(img, 224).numpy(),
                                      jt.clip_preprocess_host(img, 224))


def test_device_resize_normalize_and_batch_frames():
    import jax.numpy as jnp

    x = frames(3, 50, 70)
    want = np.asarray(jt.resize_normalize(jnp.asarray(x), 32, "imagenet"))
    got = pt.resize_normalize(torch.from_numpy(x), 32, "imagenet").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)  # f32 sums, other order
    for a, b in zip(pt.batch_frames(list(frames(7, 4, 5)), 3),
                    jt.batch_frames(list(frames(7, 4, 5)), 3)):
        np.testing.assert_array_equal(a, b)


# --- Canny ----------------------------------------------------------------------


@pytest.mark.parametrize("blur", [0, 1, 3])
def test_canny_on_random_frames_is_cv2(blur):
    x = frames(3, 90, 160, seed=blur)
    if blur:
        x = np.stack([cv2.GaussianBlur(f, (5, 5), blur) for f in x])
    got = fsd.canny_edges(torch.from_numpy(x)).numpy()
    want = np.stack([cv2.Canny(f, 50, 400) > 0 for f in x])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_canny_on_the_edit_corpus_is_cv2(kind):
    video = make_video(kind, 0)[:6]
    got = fsd.canny_edges(torch.from_numpy(np.stack(video))).numpy()
    want = np.stack([cv2.Canny(f, 50, 400) > 0 for f in video])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_exact_host_fsd_equals_jax(kind):
    """The float64 variance, the average Canny map, the crop boxes and the
    frames `image_process` returns on those maps, all equal to the JAX
    package's."""
    video = make_video(kind, 1)
    want_var, want_edges = jfsd.variance_and_edges_host(video)
    got_var, got_edges = fsd.variance_and_edges_host(video, "cpu")
    np.testing.assert_array_equal(got_var, want_var)
    np.testing.assert_array_equal(got_edges, want_edges)
    want = jfsd.image_process(video, precomputed_maps=(want_var, want_edges))
    got = fsd.image_process(video, "cpu", precomputed_maps=(got_var, got_edges))
    assert got[0] == want[0] and len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    imgs, v, e = fsd.remove_edges(video, got_var, got_edges)
    jimgs, jv, je = jfsd.remove_edges(video, want_var, want_edges)
    assert [i.shape for i in imgs] == [i.shape for i in jimgs]
    np.testing.assert_array_equal(v, jv)
    assert [[f.shape for f in s[0]] for s in fsd.split_imgs(imgs, v, e)] == \
        [[f.shape for f in s[0]] for s in jfsd.split_imgs(jimgs, jv, je)]
    assert [[f.shape for f in s] for s in fsd.clean_imgs(video, got_var, got_edges)] == \
        [[f.shape for f in s] for s in jfsd.clean_imgs(video, want_var, want_edges)]


def test_image_process_takes_device_frames_and_keeps_raw_on_failure(monkeypatch):
    video = make_video("letterbox", 2)
    changed, crops = fsd.image_process(torch.from_numpy(np.stack(video)).unbind(0), "cpu")
    assert changed and isinstance(crops[0], torch.Tensor) and crops[0].shape[0] < H

    def boom(*a, **k):
        raise ValueError("cut logic failed")

    monkeypatch.setattr(fsd, "image_process_boxes", boom)
    changed, out = fsd.image_process(video, "cpu", precomputed_maps=(np.zeros((H, W)),) * 2)
    assert not changed and len(out) == len(video) and out[0] is video[0]
