"""The port's descriptor-track eval path against the JAX package on the CPU:
CSV and npz interop both ways, `CandidateGeneration`, TN localization,
the metrics, and `descriptor_eval.run` end to end on a planted corpus.

Inputs are made from numpy seeds and fed to both packages. Tolerances:
- scores 1e-5: the JAX searcher multiplies in bf16x3 (Precision.HIGH),
  the port in exact f32, on unit vectors; the order of candidates may
  differ only between scores that close ("ties aside");
- alignment boxes and metrics exactly: both packages run the same numpy
  algorithms on the same maps.

The JAX side's TN runs its numpy path here (`_tn_numpy`): its native C++
twin builds with g++ into the source tree at first use, unlocked, and a
worker that loads the library while another writes it fails. That twin is
held against `_tn_numpy` by `tests/test_align.py`; the port's own build
(`kernels/build.py`) writes each library whole under a new name.
"""

import io

import numpy as np
import pytest

from vsc22_tpu.align import localization as jloc
from vsc22_tpu.align import vta as jvta
from vsc22_tpu.core import metrics as jmetrics
from vsc22_tpu.core import storage as jstorage
from vsc22_tpu.core import types as jtypes
from vsc22_tpu.pipelines import descriptor_eval as jeval
from vsc22_tpu.retrieval import index as jindex
from vsc22_tpu_torch.align import localization as ploc
from vsc22_tpu_torch.align import vta as pvta
from vsc22_tpu_torch.core import metrics as pmetrics
from vsc22_tpu_torch.core import storage as pstorage
from vsc22_tpu_torch.core import types as ptypes
from vsc22_tpu_torch.pipelines import descriptor_eval as peval
from vsc22_tpu_torch.retrieval import index as pindex

ATOL = 1e-5


@pytest.fixture(autouse=True)
def jax_tn_in_numpy(monkeypatch):
    """Keep every JAX call in this file off `vsc22_tpu.native`'s lazy build:
    its callers import `load_library` at call time and take their numpy
    path when it returns None."""
    import vsc22_tpu.native

    monkeypatch.setattr(vsc22_tpu.native, "load_library", lambda: None)


def normalize(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def videos(mod, prefix, count, frames, dim, rng, start=0):
    return [mod.VideoFeature(video_id=f"{prefix}{start + i:06d}",
                             timestamps=np.arange(frames, dtype=np.float32),
                             feature=normalize(rng.normal(size=(frames, dim))))
            for i in range(count)]


def to_jax(vs):
    return [jtypes.VideoFeature(video_id=v.video_id, timestamps=v.timestamps, feature=v.feature)
            for v in vs]


def assert_candidates_match(got, want):
    """Same pairs with scores within ATOL, in the same order except among
    scores within ATOL of each other."""
    assert len(got) == len(want)
    want_score = {(c.query_id, c.ref_id): c.score for c in want}
    assert {(c.query_id, c.ref_id) for c in got} == set(want_score)
    for c in got:
        assert abs(c.score - want_score[(c.query_id, c.ref_id)]) <= ATOL
    ranked = np.array([want_score[(c.query_id, c.ref_id)] for c in got])
    assert (np.diff(ranked) <= 2 * ATOL).all()


# --- CSV and npz interop -------------------------------------------------------


def csv_text(write, rows):
    buf = io.StringIO()
    write(rows, buf)
    return buf.getvalue()


def test_candidate_csv_interop_both_ways():
    rng = np.random.default_rng(0)
    rows = [(f"Q{rng.integers(1e6):06d}", f"R{rng.integers(1e6):06d}", float(s))
            for s in rng.normal(size=20).astype(np.float32)]
    rows.append(("Q000001", "R000002", 0.1))
    port = [ptypes.CandidatePair(*r) for r in rows]
    jax = [jtypes.CandidatePair(*r) for r in rows]
    port_text = csv_text(ptypes.CandidatePair.write_csv, port)
    assert port_text == csv_text(jtypes.CandidatePair.write_csv, jax)
    assert port_text.splitlines()[0] == "query_id,ref_id,score"
    # pandas' default float parser may land one ulp off the written repr;
    # the port's reader parses it exactly.
    back = jtypes.CandidatePair.read_csv(io.StringIO(port_text))
    assert_rows_equal([dataclass_row(c) for c in back], rows, rel=1e-14)
    back = ptypes.CandidatePair.read_csv(io.StringIO(csv_text(jtypes.CandidatePair.write_csv,
                                                              jax)))
    assert [dataclass_row(c) for c in back] == rows


def dataclass_row(c):
    return c.query_id, c.ref_id, c.score


def assert_rows_equal(got, want, rel):
    assert [r[:-1] for r in got] == [r[:-1] for r in want]
    np.testing.assert_allclose([r[-1] for r in got], [r[-1] for r in want], rtol=rel)


def test_candidate_csv_reads_integer_ids_alike():
    """A file of bare integer ids: both readers add the dataset prefix."""
    text = "query_id,ref_id,score\n12,345,0.5\n7,8,1.5\n"
    want = jtypes.CandidatePair.read_csv(io.StringIO(text))
    got = ptypes.CandidatePair.read_csv(io.StringIO(text))
    assert [dataclass_row(c) for c in got] == [dataclass_row(c) for c in want]
    assert got[0].query_id == "Q000012" and got[0].ref_id == "R000345"


@pytest.mark.parametrize("is_gt", [False, True])
def test_match_csv_interop_both_ways(tmp_path, is_gt):
    rng = np.random.default_rng(1)
    rows = [dict(query_id=f"Q{i:06d}", ref_id=f"R{i + 3:06d}", score=float(s),
                 query_start=float(a), query_end=float(a + 4.5), ref_start=float(b),
                 ref_end=float(b + 4.25))
            for i, (s, a, b) in enumerate(zip(rng.normal(size=12), rng.uniform(0, 60, 12),
                                              rng.uniform(0, 60, 12)))]
    port_file, jax_file = tmp_path / "port.csv", tmp_path / "jax.csv"
    ptypes.Match.write_csv([ptypes.Match(**r) for r in rows], str(port_file))
    jtypes.Match.write_csv([jtypes.Match(**r) for r in rows], str(jax_file))
    assert port_file.read_text() == jax_file.read_text()
    assert port_file.read_text().splitlines()[0] == (
        "query_id,ref_id,query_start,query_end,ref_start,ref_end,score")
    want = [tuple((dict(r, score=1.0) if is_gt else r).values()) for r in rows]
    got = [tuple(m) for m in ptypes.Match.read_csv(str(jax_file), is_gt=is_gt)]
    assert got == [w[:2] + (w[2],) + w[3:] for w in want]
    # pandas' default float parser may land one ulp off the written repr
    back = jtypes.Match.read_csv(str(port_file), is_gt=is_gt)
    np.testing.assert_allclose([tuple(m)[2:] for m in back], [w[2:] for w in want], rtol=1e-14)
    assert [tuple(m)[:2] for m in back] == [w[:2] for w in want]


def test_match_csv_rejects_nan_like_jax():
    text = "query_id,ref_id,query_start,query_end,ref_start,ref_end,score\nQ1,R2,0.0,,1.0,2.0,1.0\n"
    for mod in (jtypes, ptypes):
        with pytest.raises(ValueError, match="NaN"):
            mod.Match.read_csv(io.StringIO(text))


@pytest.mark.parametrize("spans", [False, True], ids=["instants", "spans"])
def test_npz_interop_both_ways(tmp_path, spans):
    rng = np.random.default_rng(2)
    vids = []
    for i, n in enumerate((3, 1, 5)):
        ts = np.arange(n, dtype=np.float32)
        if spans:
            ts = np.stack([ts, ts + 1.0], axis=1)
        vids.append((i, ts, rng.normal(size=(n, 6)).astype(np.float32)))
    port = [ptypes.VideoFeature(video_id=i, timestamps=t, feature=f) for i, t, f in vids]
    jax = [jtypes.VideoFeature(video_id=i, timestamps=t, feature=f) for i, t, f in vids]
    pstorage.store_features(str(tmp_path / "p.npz"), port, ptypes.Dataset.REFS)
    jstorage.store_features(str(tmp_path / "j.npz"), jax, jtypes.Dataset.REFS)
    for loader, name, ds in ((jstorage.load_features, "p.npz", jtypes.Dataset.REFS),
                             (pstorage.load_features, "j.npz", ptypes.Dataset.REFS)):
        back = loader(str(tmp_path / name), ds)
        assert [v.video_id for v in back] == ["R000000", "R000001", "R000002"]
        for v, (_, t, f) in zip(back, vids):
            np.testing.assert_array_equal(v.feature, f)
            np.testing.assert_array_equal(v.timestamps, t)
    a, b = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])
        assert a[key].dtype == b[key].dtype


# --- candidate generation ------------------------------------------------------


@pytest.fixture(scope="module")
def index_corpus():
    rng = np.random.default_rng(3)
    refs = videos(ptypes, "R", 30, 12, 24, rng)
    queries = videos(ptypes, "Q", 10, 9, 24, rng)
    for i in range(5):  # query i copies frames of ref 2i
        queries[i].feature[2:6] = normalize(refs[2 * i].feature[4:8]
                                            + 0.05 * rng.normal(size=(4, 24)))
    return queries, refs


@pytest.mark.parametrize("global_k", [300, 2000, -3])
@pytest.mark.parametrize("transfer", [np.float32, np.float16], ids=["f32", "f16"])
def test_candidate_generation_matches_jax(index_corpus, global_k, transfer):
    queries, refs = index_corpus
    got = pindex.CandidateGeneration(refs, pindex.MaxScoreAggregation(), device="cpu",
                                     transfer_dtype=transfer).query(queries, global_k)
    want = jindex.CandidateGeneration(to_jax(refs), jindex.MaxScoreAggregation(),
                                      transfer_dtype=transfer).query(to_jax(queries), global_k)
    assert_candidates_match(got, want)
    assert {(f"Q{i:06d}", f"R{2 * i:06d}") for i in range(5)} <= {
        (c.query_id, c.ref_id) for c in got[:5]}


class MeanScore(pindex.ScoreAggregation):
    def aggregate(self, match):
        return float(np.mean([m.score for m in match.matches]))


class JaxMeanScore(jindex.ScoreAggregation):
    def aggregate(self, match):
        return float(np.mean([m.score for m in match.matches]))


def test_video_index_search_groups_frame_matches_like_jax(index_corpus):
    """The per-frame path (`VideoIndex.search`) behind any aggregation
    other than max: the same frame matches per pair, the same ranking."""
    queries, refs = index_corpus
    gi = pindex.VideoIndex(24, device="cpu")
    gi.add(refs)
    ji = jindex.VideoIndex(24)
    ji.add(to_jax(refs))
    got = {(p.query_id, p.ref_id): p.matches for p in gi.search(queries, 400)}
    want = {(p.query_id, p.ref_id): p.matches for p in ji.search(to_jax(queries), 400)}
    assert got.keys() == want.keys()
    for key, ms in got.items():
        assert sorted(m[:2] for m in ms) == sorted(m[:2] for m in want[key])
    g = pindex.CandidateGeneration(refs, MeanScore(), device="cpu").query(queries, 400)
    w = jindex.CandidateGeneration(to_jax(refs), JaxMeanScore()).query(to_jax(queries), 400)
    assert_candidates_match(g, w)
    with pytest.raises(ValueError):
        gi.add(videos(ptypes, "R", 1, 3, 8, np.random.default_rng(0), start=99))


# --- TN localization -----------------------------------------------------------


def tn_maps():
    rng = np.random.default_rng(12)
    maps = []
    for q, r in ((40, 60), (25, 25), (33, 17)):
        sims = rng.normal(0, 0.1, (q, r))
        d = min(q, r) // 2
        sims[np.arange(d), np.arange(d) + 3 if r > d + 3 else np.arange(d)] += 0.9
        sims[np.arange(5, d), np.arange(5, d)] += 0.4
        maps.append(sims)
    maps.append(rng.normal(0, 0.3, (48, 48)))  # noise
    maps.append(np.zeros((10, 10)))  # degenerate
    return maps


@pytest.mark.parametrize("kwargs", [{}, {"tn_max_step": 5, "tn_top_k": 3},
                                    {"max_path": 3, "min_sim": 0.1, "min_length": 3,
                                     "max_iou": 0.5}])
def test_tn_matches_jax(kwargs):
    for sims in tn_maps():
        assert pvta.tn(sims, **kwargs) == jvta._tn_numpy(sims, **kwargs)
    boxes = pvta.tn(tn_maps()[0], tn_max_step=5)
    assert boxes and boxes[0][2] - boxes[0][0] > 10


def test_vta_model_pool_matches_sequential():
    sims = [(f"k{i}", m) for i, m in enumerate(tn_maps())]
    seq = pvta.build_vta_model("TN", tn_max_step=5).forward_sim(sims)
    model = pvta.build_vta_model("TN", concurrency=2, tn_max_step=5)
    assert model.forward_sim(sims) == seq  # a pool for the call
    with model:  # one pool for both calls
        assert model.forward_sim(sims[:3]) + model.forward_sim(sims[3:]) == seq
    assert model._pool is None
    want = jvta.build_vta_model("TN", tn_max_step=5).forward_sim(sims)
    assert seq == want
    # DTW, the default method of both packages, in the pool too.
    dtw = pvta.build_vta_model(concurrency=2).forward_sim(sims)
    assert dtw == jvta.build_vta_model().forward_sim(sims) and any(b for _, b in dtw)


@pytest.mark.parametrize("similarity_type", ["cos", "chamfer"])
def test_vta_model_forward_builds_maps_like_jax(similarity_type):
    """`forward` makes the maps itself: cos over [N, D] rows, or the
    normalized chamfer similarity over [N, m, D] local descriptor sets."""
    rng = np.random.default_rng(13)
    shape = (3, 8) if similarity_type == "cos" else (3, 4, 8)
    data = [(f"Q{i}", f"R{i}", rng.normal(size=(20,) + shape[1:]),
             rng.normal(size=(18,) + shape[1:])) for i in range(3)]
    data[0][3][2:14] = data[0][2][5:17]  # a copied run
    kw = dict(tn_max_step=5, min_length=2, min_sim=0.1)
    got = pvta.build_vta_model("TN", **kw).forward(data, normalize_input=True,
                                                   similarity_type=similarity_type)
    want = jvta.build_vta_model("TN", **kw).forward(data, normalize_input=True,
                                                    similarity_type=similarity_type)
    assert got == want and got[0][1]
    for args in data:
        np.testing.assert_allclose(pvta.sim_map(*args, True, similarity_type)[2],
                                   jvta.sim_map(*args, True, similarity_type)[2])
    with pytest.raises(ValueError):
        pvta.sim_map("q", "r", data[0][2], data[0][3], similarity_type="l1")


@pytest.mark.parametrize("max_sim", [True, False], ids=["max_sim", "candidate_score"])
def test_localization_matches_jax(index_corpus, max_sim):
    queries, refs = index_corpus
    cands = [ptypes.CandidatePair(f"Q{i:06d}", f"R{2 * i + j:06d}", 0.5 + 0.1 * i)
             for i in range(5) for j in (0, 1)]
    jcands = [jtypes.CandidatePair(c.query_id, c.ref_id, c.score) for c in cands]
    kw = dict(model_type="TN", tn_max_step=5, min_length=1)
    if max_sim:
        got = ploc.VCSLLocalizationMaxSim(queries, refs, similarity_bias=0.5, **kw)
        want = jloc.VCSLLocalizationMaxSim(to_jax(queries), to_jax(refs),
                                           similarity_bias=0.5, **kw)
    else:
        got = ploc.VCSLLocalizationCandidateScore(queries, refs, **kw)
        want = jloc.VCSLLocalizationCandidateScore(to_jax(queries), to_jax(refs), **kw)
    g, w = got.localize_all(cands), want.localize_all(jcands)
    assert len(g) >= 5
    assert [m._asdict() for m in g] == [m._asdict() for m in w]


# --- metrics -------------------------------------------------------------------


def random_pairs(mod, rng, n, n_q=15, n_r=15):
    keys = rng.choice(n_q * n_r, n, replace=False)
    scores = np.round(rng.normal(size=n), 1)  # tied scores, grouped at one threshold
    return [mod.CandidatePair(f"Q{k // n_r:06d}", f"R{k % n_r:06d}", float(s))
            for k, s in zip(keys, scores)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_average_precision_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gt_keys = random_pairs(ptypes, rng, 20)
    preds = random_pairs(ptypes, rng, 120)
    want = jmetrics.average_precision(
        [jtypes.CandidatePair(c.query_id, c.ref_id, 1.0) for c in gt_keys],
        [jtypes.CandidatePair(c.query_id, c.ref_id, c.score) for c in preds])
    got = pmetrics.average_precision(
        [ptypes.CandidatePair(c.query_id, c.ref_id, 1.0) for c in gt_keys], preds)
    assert got.ap == want.ap and got.simple_ap == want.simple_ap
    for field in ("precisions", "recalls", "scores"):
        np.testing.assert_array_equal(getattr(got.pr_curve, field),
                                      getattr(want.pr_curve, field))
    with pytest.raises(AssertionError):
        pmetrics.average_precision(gt_keys, preds + preds[:1])


def random_matches(mod, rng, n):
    out = []
    for _ in range(n):
        # quarters: exact in binary, so pandas' parser reads them exactly too
        q0, r0, lq, lr = np.round(4 * rng.uniform((0, 0, 1, 1), (50, 50, 20, 20))) / 4
        out.append(mod.Match(f"Q{rng.integers(4):06d}", f"R{rng.integers(4):06d}",
                             float(np.round(rng.uniform(), 2)), float(q0), float(q0 + lq),
                             float(r0), float(r0 + lr)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_matching_track_matches_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    gt = random_matches(ptypes, rng, 10)
    preds = random_matches(ptypes, rng, 40) + [m._replace(score=0.7) for m in gt[:6]]
    gt_file, pred_file = str(tmp_path / "gt.csv"), str(tmp_path / "pred.csv")
    ptypes.Match.write_csv(gt, gt_file)
    ptypes.Match.write_csv(preds, pred_file)
    got = pmetrics.evaluate_matching_track(gt_file, pred_file)
    want = jmetrics.evaluate_matching_track(gt_file, pred_file)
    assert got.segment_ap.ap == want.segment_ap.ap > 0
    assert got.pairwise_micro_ap.ap == want.pairwise_micro_ap.ap
    seg = pmetrics.match_metric(gt, preds)
    assert seg.ap == jmetrics.match_metric(
        [jtypes.Match(*m) for m in gt], [jtypes.Match(*m) for m in preds]).ap


# --- descriptor_eval end to end --------------------------------------------------


@pytest.fixture(scope="module")
def eval_corpus(tmp_path_factory):
    """20 queries / 40 refs of 32-d frames; queries 0..9 copy ten frames of
    ref i (lightly noised); 20 noise videos; written by the JAX package."""
    tmp = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(42)
    refs = videos(jtypes, "R", 40, 30, 32, rng)
    queries = videos(jtypes, "Q", 20, 25, 32, rng)
    gt = []
    for i in range(10):
        queries[i].feature[8:18] = normalize(refs[i].feature[5:15]
                                             + 0.05 * rng.normal(size=(10, 32)))
        gt.append(jtypes.Match(f"Q{i:06d}", f"R{i:06d}", 1.0, 8.0, 18.0, 5.0, 15.0))
    noise = videos(jtypes, "R", 20, 30, 32, rng, start=900)
    paths = {name: str(tmp / f"{name}.npz") for name in ("q", "r", "noise")}
    for name, vs in (("q", queries), ("r", refs), ("noise", noise)):
        jstorage.store_features(paths[name], vs)
    paths["gt"] = str(tmp / "gt.csv")
    jtypes.Match.write_csv(gt, paths["gt"])
    return tmp, paths


@pytest.mark.parametrize("score_norm", [True, False], ids=["score_norm", "plain"])
def test_descriptor_eval_run_matches_jax(eval_corpus, score_norm):
    tmp, p = eval_corpus
    tag = "sn" if score_norm else "plain"
    noise = p["noise"] if score_norm else None
    want = jeval.run(p["q"], p["r"], str(tmp / f"jax_{tag}"), noise, p["gt"])
    got = peval.run(p["q"], p["r"], str(tmp / f"port_{tag}"), noise, p["gt"], device="cpu")
    assert_candidates_match(ptypes.CandidatePair.read_csv(got.candidate_file),
                            jtypes.CandidatePair.read_csv(want.candidate_file))
    gm = ptypes.Match.read_csv(got.match_file)
    wm = jtypes.Match.read_csv(want.match_file)
    assert len(gm) == len(wm) >= 5
    for g, w in zip(gm, wm):
        assert g[:2] == w[:2] and g[3:] == w[3:] and abs(g.score - w.score) <= ATOL
    assert got.candidate_uap == pytest.approx(want.candidate_uap, abs=1e-9)
    assert got.candidate_uap > 0.9
    assert got.segment_ap == pytest.approx(want.segment_ap, abs=1e-9)


def test_descriptor_eval_cli_refuses_to_overwrite(eval_corpus):
    tmp, p = eval_corpus
    out = tmp / "cli"
    argv = ["--query_features", p["q"], "--ref_features", p["r"], "--output_path", str(out),
            "--device", "cpu"]
    peval.main(argv)
    assert (out / "candidates.csv").exists() and (out / "matches.csv").exists()
    with pytest.raises(SystemExit, match="overwrite"):
        peval.main(argv)
    peval.main(argv + ["--overwrite"])
