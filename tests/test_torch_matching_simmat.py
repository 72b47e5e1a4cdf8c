"""The matching track's similarity images, heatmap decode and noise
statistics in the port against the JAX package on the CPU.

- host oracles (`select_best_split_segment`, `candidate_sim_matrices`,
  `pad_sim_matrix`): both sides are the same numpy arithmetic, so equal
  bit for bit;
- `DeviceSimBuilder.images` / `crop_hw` at res 160 and 224 on a corpus
  with split queries (two and three segments, a partial trailing one),
  single-segment queries longer than `res`, refs shorter and longer than
  `res`, and chunks with padded tails: the same segment offsets, the same
  crop shapes, images within 1e-5 (both are float32 products of unit
  vectors, JAX's in XLA's summation order); and the builder's valid
  prefixes equal the host oracle's padded images within 1e-5;
- a query with more than `MAX_SEGS` (8) segments makes the builder
  unusable in both packages;
- decode (`generate_matching_result`, `decode_all_settings`): identical
  rows from identical heatmaps;
- `calculate_low_var_dim`: the same dimension.
"""

import numpy as np
import pytest

from vsc22_tpu.matching import decode as jdecode
from vsc22_tpu.matching import simmat as jsimmat
from vsc22_tpu.pipelines.query_extract import calculate_low_var_dim as j_low_var_dim
from vsc22_tpu.core.types import VideoFeature as JVideoFeature
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.matching import decode, simmat
from vsc22_tpu_torch.pipelines.query_extract import calculate_low_var_dim

IMG_TOL = 1e-5


def unit(rng, n, d=16):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def mixed_corpus(seed=0):
    """(query map, ref map, query num_frames map): Q0 two segments of 30,
    Q1 three of 40 with a partial last (100 rows), Q2 one of 180 (> 160),
    Q3 one of 20; refs of 25, 170 and 240 frames, R1 holding a copy of a
    piece of Q1's second segment."""
    rng = np.random.default_rng(seed)
    q = {"Q0": unit(rng, 60), "Q1": unit(rng, 100), "Q2": unit(rng, 180), "Q3": unit(rng, 20)}
    r = {"R0": unit(rng, 25), "R1": unit(rng, 170), "R2": unit(rng, 240)}
    r["R1"][30:42] = q["Q1"][45:57]
    nf = {"Q0": 30, "Q1": 40, "Q2": 180, "Q3": 20}
    return q, r, nf


PAIRS = [(q, r) for q in ("Q0", "Q1", "Q2", "Q3") for r in ("R0", "R1", "R2")]


def test_host_oracles_equal_jax():
    q, r, nf = mixed_corpus()
    for qid, rid in PAIRS:
        assert np.array_equal(simmat.select_best_split_segment(q[qid], r[rid], nf[qid]),
                              jsimmat.select_best_split_segment(q[qid], r[rid], nf[qid]))
    cands = [(a, b, 0.5) for a, b in PAIRS]
    got_f, got_i = simmat.candidate_sim_matrices(q, r, cands, nf)
    want_f, want_i = jsimmat.candidate_sim_matrices(q, r, cands, nf)
    assert got_i == want_i and len(got_f) == 2 * len(PAIRS)
    for g, w in zip(got_f, want_f):
        assert np.array_equal(g, w)
        for size in (160, 224):
            assert np.array_equal(simmat.pad_sim_matrix(g, size), jsimmat.pad_sim_matrix(w, size))
    # Q1's best segment is the second (rows 40-79), where the copy sits.
    assert np.array_equal(simmat.select_best_split_segment(q["Q1"], r["R1"], 40), q["Q1"][40:80])


@pytest.mark.parametrize("res, chunk", [(160, 5), (224, 4)])
def test_device_sim_builder_matches_jax(res, chunk):
    q, r, nf = mixed_corpus()
    builder = simmat.DeviceSimBuilder(q, r, nf, device="cpu")
    jbuilder = jsimmat.DeviceSimBuilder(q, r, nf)
    assert builder.usable() and jbuilder.usable()
    assert (builder.fq, builder.fr) == (jbuilder.fq, jbuilder.fr)
    got = builder.images(PAIRS, res, chunk=chunk)
    want = jbuilder.images(PAIRS, res, chunk=chunk)
    assert [n for _, _, n in got] == [n for _, _, n in want]
    assert all(imgs.shape == (chunk, res, res) for imgs, _, _ in got)
    g_img = np.concatenate([i.numpy()[:n] for i, _, n in got])
    w_img = np.concatenate([np.asarray(i)[:n] for i, _, n in want])
    g_off = np.concatenate([o.numpy()[:n] for _, o, n in got])
    w_off = np.concatenate([np.asarray(o)[:n] for _, o, n in want])
    assert np.array_equal(g_off, w_off)
    np.testing.assert_allclose(g_img, w_img, atol=IMG_TOL, rtol=0)
    assert np.array_equal(g_img == 0, w_img == 0)  # the same padding
    assert builder.crop_hw(PAIRS, res, g_off) == jbuilder.crop_hw(PAIRS, res, w_off)
    # The valid prefixes are the host path's padded images.
    for (qid, rid), img in zip(PAIRS, g_img):
        seg = simmat.select_best_split_segment(q[qid], r[rid], nf[qid])
        host = simmat.pad_sim_matrix(seg @ r[rid].T, res, channels=1)[..., 0]
        np.testing.assert_allclose(img, host, atol=IMG_TOL, rtol=0)
    assert g_off[PAIRS.index(("Q1", "R1"))] == 40


def test_more_than_eight_segments_leaves_the_device_path():
    rng = np.random.default_rng(1)
    q = {"Q0": unit(rng, 90), "Q1": unit(rng, 20)}
    r = {"R0": unit(rng, 30)}
    nf = {"Q0": 10, "Q1": 20}  # 9 segments
    assert not simmat.DeviceSimBuilder(q, r, nf, device="cpu").usable()
    assert not jsimmat.DeviceSimBuilder(q, r, nf).usable()
    nf["Q0"] = 12  # 8 segments, the last partial
    builder = simmat.DeviceSimBuilder(q, r, nf, device="cpu")
    assert builder.usable() and jsimmat.DeviceSimBuilder(q, r, nf).usable()
    (imgs, offs, n), = builder.images([("Q0", "R0")], 160, chunk=2)
    (jimgs, joffs, _), = jsimmat.DeviceSimBuilder(q, r, nf).images([("Q0", "R0")], 160, chunk=2)
    assert n == 1 and int(offs[0]) == int(joffs[0])
    np.testing.assert_allclose(imgs.numpy()[0], np.asarray(jimgs)[0], atol=IMG_TOL, rtol=0)


def heatmaps(seed=3):
    """(qid, rid, heatmap, raw) rows: diagonal bands (one long, one short
    and off-diagonal, one at slope 2), noise, an empty map, and a blob."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(4):
        h = rng.uniform(0, 0.05, (40, 50)).astype(np.float32)
        if i == 0:
            for t in range(30):
                h[5 + t, 8 + t] = 0.9 - 0.01 * t
        elif i == 1:
            for t in range(12):
                h[20 + t, 2 + t] = 0.5
                h[20 + t, 3 + t] = 0.2
        elif i == 2:
            for t in range(15):
                h[3 + t, 5 + 2 * t] = 0.6
        else:
            h[10:14, 10:14] = 0.8
        rows.append((f"Q{i:06d}", f"R{i:06d}", h, h.copy()))
    rows.append(("Q000009", "R000009", np.zeros((12, 12), np.float32),
                 np.zeros((12, 12), np.float32)))
    return rows


def test_decode_rows_identical_to_jax():
    res = heatmaps()
    for threshold, std_ratio in decode.DECODE_SETTINGS:
        got = decode.generate_matching_result(res, threshold=threshold, std_ratio=std_ratio)
        want = jdecode.generate_matching_result(res, threshold=threshold, std_ratio=std_ratio)
        assert got == want
    got = decode.decode_all_settings(res)
    assert got == jdecode.decode_all_settings(res) and len(got) >= 3
    x = np.arange(20.0)
    assert decode._ransac_line(x, 2 * x + 1, np.ones(20)) == jdecode._ransac_line(
        x, 2 * x + 1, np.ones(20))


def test_calculate_low_var_dim_matches_jax():
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((7, 12)).astype(np.float32) for _ in range(5)]
    for f in feats:
        f[:, 9] *= 0.01
    port = [VideoFeature(video_id=f"R{i}", timestamps=np.arange(7.0), feature=f)
            for i, f in enumerate(feats)]
    jax_side = [JVideoFeature(video_id=f"R{i}", timestamps=np.arange(7.0), feature=f)
                for i, f in enumerate(feats)]
    assert calculate_low_var_dim(port) == j_low_var_dim(jax_side) == 9
