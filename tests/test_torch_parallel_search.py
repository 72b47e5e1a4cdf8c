"""The port's row-sharded search, score-norm and frame-sharded extractor at
2 and 4 gloo ranks on the CPU, against the JAX package's sharded
functions on a mesh of the same shape (the conftest's virtual CPU
devices) and against the port's one-rank results.

Each world is spawned once (`torch_parallel_workers.search_rank`, no
JAX). Random unit vectors carry no ties within 1e-5 but the planted ones,
so index arrays must agree exactly; the integer corpus with duplicate
rows scores exactly in any order, so its scores agree bit for bit and
each returned index must score what it is returned with (duplicates may
swap)."""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
import torch_parallel_workers as workers
from test_torch_search import ATOL, burst_corpus, unit
from vsc22_tpu.core.types import VideoFeature as JaxVideoFeature
from vsc22_tpu.models import vit as jvit
from vsc22_tpu.pipelines import descriptor_eval as jeval
from vsc22_tpu.pipelines import matching_infer as jmatch
from vsc22_tpu.pipelines.query_extract import DescriptorExtractor as JaxExtractor
from vsc22_tpu.retrieval import score_norm as jsn
from vsc22_tpu.retrieval import search as jsearch
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.models import vit
from vsc22_tpu_torch.parallel.launcher import launch_local
from vsc22_tpu_torch.pipelines import descriptor_eval as peval
from vsc22_tpu_torch.pipelines import matching_infer as pmatch
from vsc22_tpu_torch.pipelines.query_extract import DescriptorExtractor
from vsc22_tpu_torch.retrieval import score_norm as psn
from vsc22_tpu_torch.retrieval import search as psearch
from vsc22_tpu_torch.utils import jax_params

cv2 = pytest.importorskip("cv2")

EXTRACT_TOL = 1e-4
WORLDS = (2, 4)


def jax_mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "model"))


@pytest.fixture(scope="module")
def data():
    refs, q = burst_corpus(9, 2048, 24, 96, 700, 30, 3e-2)
    rng = np.random.default_rng(3)
    int_refs = rng.integers(-1, 2, (512, 32)).astype(np.float32)
    int_refs[300:310] = int_refs[17]  # duplicate rows across the shards
    int_refs[100] = int_refs[400] = 3.0
    int_q = rng.integers(0, 3, (24, 32)).astype(np.float32)
    b5_refs, b5_q = burst_corpus(21, 65536, 32, 48, 40000, 20, 1e-2)

    def vids(n, frames, d=32):
        return [unit(rng, frames + i % 3, d) for i in range(n)]

    jm = jvit.vit_tiny_test_descriptor()
    params = jm.init(jax.random.PRNGKey(1), np.zeros((1, 64, 64, 3), np.float32), train=False)
    pm = vit.vit_tiny_test_descriptor()
    jax_params.load_vit_descriptor(pm, params)
    frames = [(np.random.default_rng(i).random((72, 96, 3)) * 255).astype(np.uint8)
              for i in range(11)]
    return dict(refs=refs, q=q, int_refs=int_refs, int_q=int_q, b5_refs=b5_refs, b5_q=b5_q,
                sn_q=vids(6, 8), sn_r=vids(4, 10), sn_noise=vids(10, 40),
                vit={k: v.detach().numpy() for k, v in pm.state_dict().items()},
                frames=frames, chunk=7, jax_vit=(jm, params))


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    """{world size: rank 0's results}; every rank's results equal."""
    shipped = {k: v for k, v in data.items() if k != "jax_vit"}
    out = {}
    for n in WORLDS:
        root = tmp_path_factory.mktemp(f"search{n}")
        got = launch_local(workers.search_rank, n, args=(str(root / "store"), shipped),
                           timeout=300.0)
        tiles = [r.pop("tile") for r in got]
        shard = tiles[0][0]
        assert tiles == [(shard, tiles[0][1], i * shard, min(max(2048 - i * shard, 0), shard))
                         for i in range(n)]
        for r in got[1:]:
            assert_trees_equal(r, got[0])
        out[n] = dict(got[0], tile=tiles[0])
    return out


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def assert_rows_match(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_row_topk_matches_jax_and_one_rank(ranks, data, n, monkeypatch):
    """Per-shard fast scan (k 4) and exact path (k 40), padded shards as
    JAX pads them, against JAX's shard_map searcher and the port's one-rank
    searcher at the same tiles."""
    res = ranks[n]
    assert res["tile"][:2] == (-(-2048 // (n * 128)) * 128, 256)
    jax_s = jsearch.SimilaritySearcher(data["refs"], mesh=jax_mesh(n), ref_tile=256, extract_e=4)
    assert (jax_s.shard_rows, jax_s.ref_tile) == res["tile"][:2]
    monkeypatch.setattr(psearch, "REF_TILE", 256)
    monkeypatch.setattr(psearch, "EXTRACT_E", 4)
    one = psearch.SimilaritySearcher(data["refs"], device="cpu")
    for key, k in (("row_topk", 4), ("row_topk_exact", 40)):
        assert_rows_match(res[key], jax_s.row_topk(data["q"], k))
        assert_rows_match(res[key], one.row_topk(data["q"], k))


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_global_topk_and_threshold_match_jax(ranks, data, n, monkeypatch):
    res = ranks[n]
    jax_s = jsearch.SimilaritySearcher(data["refs"], mesh=jax_mesh(n), ref_tile=256, extract_e=4)
    monkeypatch.setattr(psearch, "REF_TILE", 256)
    monkeypatch.setattr(psearch, "EXTRACT_E", 4)
    one = psearch.SimilaritySearcher(data["refs"], device="cpu")
    for gk, got in zip((50, 700, 5000), res["global_topk"]):  # 5000 doubles the budget
        for want in (jax_s.global_topk(data["q"], gk), one.global_topk(data["q"], gk)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[2], want[2], atol=ATOL)
    got, want = res["threshold"], jax_s.threshold_search(data["q"], 0.45, k0=8)
    assert len(got[0]) > 30
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_search_on_an_integer_corpus_with_duplicates(ranks, data, n):
    """Exact products: the scores equal JAX's sharded and the port's
    one-rank scores bit for bit; each index scores its score, once a row."""
    res = ranks[n]
    q, refs = data["int_q"], data["int_refs"]
    exact = q @ refs.T
    jax_s = jsearch.SimilaritySearcher(refs, mesh=jax_mesh(n))
    one = psearch.SimilaritySearcher(refs, device="cpu")
    s, i = res["int_row_topk"]
    for want in (jax_s.row_topk(q, 8), one.row_topk(q, 8)):
        np.testing.assert_array_equal(s, want[0])
    np.testing.assert_array_equal(np.take_along_axis(exact, i.astype(np.int64), 1), s)
    assert all(len(set(row)) == len(row) for row in i.tolist())
    qi, ri, sc = res["int_global_topk"]
    for want in (jax_s.global_topk(q, 100), one.global_topk(q, 100)):
        np.testing.assert_array_equal(sc, want[2])
    np.testing.assert_array_equal(exact[qi, ri], sc)
    assert len(set(zip(qi.tolist(), ri.tolist()))) == len(qi) == 100


@pytest.mark.parametrize("n", WORLDS)
def test_b5_serves_each_shard(ranks, data, n):
    """65,536 refs over n shards: the B5 rule holds on each shard's rows
    (32,768 at 2 ranks; at 4 the 16,384-row shards take the fast scan), and
    the merged rows equal JAX's sharded searcher (its XLA scan) and the
    one-device searcher; the burst row comes back whole from the rescan."""
    res = ranks[n]
    shard = 65536 // n
    assert res["b5_active"] == (shard >= psearch.B5_MIN_REFS)
    if res["b5_active"]:
        assert res["b5_calls"] and all(c == (shard, 32) for c in res["b5_calls"])
    else:
        assert not res["b5_calls"]
    want = jsearch.SimilaritySearcher(data["b5_refs"], mesh=jax_mesh(n)).row_topk(data["b5_q"], 10)
    assert_rows_match(res["b5_row_topk"], want)
    one = psearch.SimilaritySearcher(data["b5_refs"], device="cpu").row_topk(data["b5_q"], 10)
    assert_rows_match(res["b5_row_topk"], one)
    assert ((res["b5_row_topk"][1][0] >= 40000) & (res["b5_row_topk"][1][0] < 40020)).all()


def videos(mod, arrays, prefix):
    return [mod(video_id=f"{prefix}{i}", timestamps=np.arange(len(f), dtype=np.float32),
                feature=f) for i, f in enumerate(arrays)]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("nk", [1, 10])
def test_sharded_score_norm_matches_jax(ranks, data, n, nk):
    """score_normalize under a mesh takes the sharded searcher even at nk 1
    (K3 is off that path, as in JAX): its queries equal JAX's on the same
    mesh, and the port's one-rank rows but for the bias column, which
    equals the one-rank searcher's top-nk mean (the one-rank nk 1 path is
    K3, on f16 operands); its refs equal both bit for bit."""
    got_q, got_r = ranks[n]["score_norm"][nk]
    jq, jr = jsn.score_normalize(videos(JaxVideoFeature, data["sn_q"], "sn_q"),
                                 videos(JaxVideoFeature, data["sn_r"], "sn_r"),
                                 videos(JaxVideoFeature, data["sn_noise"], "sn_noise"),
                                 nk=nk, mesh=jax_mesh(n))
    np.testing.assert_allclose(got_q, np.concatenate([f.feature for f in jq]), atol=ATOL)
    np.testing.assert_array_equal(got_r, np.concatenate([f.feature for f in jr]))
    noise = videos(VideoFeature, data["sn_noise"], "sn_noise")
    pq, pr = psn.score_normalize(videos(VideoFeature, data["sn_q"], "sn_q"),
                                 videos(VideoFeature, data["sn_r"], "sn_r"), noise,
                                 nk=nk, device="cpu")
    one_q = np.concatenate([f.feature for f in pq])
    np.testing.assert_array_equal(got_q[:, :-1], one_q[:, :-1])
    np.testing.assert_array_equal(got_r, np.concatenate([f.feature for f in pr]))
    dim = psn._min_variance_dim(noise)
    prepared = np.concatenate([f.feature for f in psn._prepare(noise, dim, True)])
    sims, _ = psearch.SimilaritySearcher(prepared, device="cpu").row_topk(one_q[:, :-1], nk)
    np.testing.assert_allclose(got_q[:, -1], -sims.mean(axis=1), atol=ATOL)


@pytest.mark.parametrize("n", WORLDS)
def test_callers_take_the_sharded_searcher(ranks, data, n):
    """`descriptor_eval.search(mesh=)` (the index's budget search, max
    aggregated) and `recall_candidates(mesh=)` (the searcher's threshold
    search, as JAX takes under a mesh) give the JAX package's candidates on
    the same mesh and the port's one-device ones."""
    res = ranks[n]
    jq, jr = (videos(JaxVideoFeature, data[k], k) for k in ("sn_q", "sn_r"))
    pq, pr = (videos(VideoFeature, data[k], k) for k in ("sn_q", "sn_r"))
    kw = dict(retrieve_per_query=20.0, candidates_per_query=3.0, transfer_dtype=np.float32)
    for want in (jeval.search(jq, jr, mesh=jax_mesh(n), **kw),
                 peval.search(pq, pr, device="cpu", **kw)):
        got = res["eval_search"]
        assert [(q, r) for q, r, _ in got] == [(c.query_id, c.ref_id) for c in want]
        np.testing.assert_allclose([s for *_, s in got], [c.score for c in want], atol=ATOL)
    for want in (jmatch.recall_candidates(jq, jr, threshold=0.3, mesh=jax_mesh(n)),
                 pmatch.recall_candidates(pq, pr, threshold=0.3, device="cpu")):
        assert [t[:2] for t in res["recall"]] == [t[:2] for t in want]
        np.testing.assert_allclose([t[2] for t in res["recall"]], [t[2] for t in want],
                                   atol=ATOL)
    assert len(res["recall"]) > 5


def test_sharded_extractor_matches_jax(ranks, data):
    """11 frames, chunk 7 rounded up to 8 over 2 ranks (a zero-padded last
    chunk of 3 frames), against JAX's `DescriptorExtractor(mesh=)` and the
    port's unsharded extractor."""
    res = ranks[2]
    assert res["extractor_chunk"] == 8
    jm, params = data["jax_vit"]
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)  # OpenCV's generic resize: the port's arithmetic
    try:
        want = JaxExtractor(jm, params, size=64, preset="vit", chunk=7,
                            mesh=jax_mesh(2)).extract(data["frames"])
    finally:
        cv2.ipp.setUseIPP(saved)
    np.testing.assert_allclose(res["extractor"], want, atol=EXTRACT_TOL)
    pm = vit.vit_tiny_test_descriptor()
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in data["vit"].items()})
    one = DescriptorExtractor(pm, size=64, preset="vit", chunk=7, device="cpu")
    np.testing.assert_allclose(res["extractor"], one.extract(data["frames"]), atol=EXTRACT_TOL)
