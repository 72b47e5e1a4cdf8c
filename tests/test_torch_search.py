"""Port kernel B5 (plain version on the CPU), the searcher and score-norm
with nk > 1 against the JAX package.

The JAX side runs B5 as its own tests do: `extract_topk(..., interpret=True)`
on `split_bf16` operands, and `SimilaritySearcher(use_fused_extract=True)`.
The JAX products are bf16x3 (Precision.HIGH), the port's exact f32, so
scores agree to 1e-5 on unit vectors; inputs are random, with no ties
within 1e-5 except the planted ones, so indices must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc22_tpu.core.types import VideoFeature as JaxVideoFeature
from vsc22_tpu.ops import pallas_topk as jtopk
from vsc22_tpu.retrieval import score_norm as jsn
from vsc22_tpu.retrieval import search as jsearch
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.ops import topk
from vsc22_tpu_torch.retrieval import score_norm as psn
from vsc22_tpu_torch.retrieval import search as psearch

ATOL = 1e-5  # bf16x3 against exact f32 products, unit vectors


def unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def jax_extract(q, r, nv, e, tile_r, k, tile_q=8):
    qh, ql = jtopk.split_bf16(q)
    rh, rl = jtopk.split_bf16(r)
    out = jtopk.extract_topk(qh, ql, rh, rl, jnp.full((1, 1), nv, jnp.int32), e=e,
                             tile_q=tile_q, tile_r=tile_r, k=k, interpret=True)
    return tuple(np.asarray(x) for x in out)


def port_extract(q, r, nv, e, tile_r, k):
    s, i, bound = topk.extract_topk(torch.from_numpy(q), torch.from_numpy(r), nv, e=e,
                                    tile_r=tile_r, k=k)
    return s.numpy(), i.numpy(), bound.numpy()


@pytest.mark.parametrize(
    "d,nv,e,k",
    [(128, 256, 4, 4), (511, 256, 4, 6), (128, 200, 4, 4), (511, 256, 2, 8)],
    ids=["d128", "d511", "num_valid", "pads_past_nb_e"],
)
def test_extract_topk_matches_jax(d, nv, e, k):
    rng = np.random.default_rng(d + nv + e)
    q, r = unit(rng, 16, d), unit(rng, 256, d)
    js, ji, jb = jax_extract(q, r, nv, e, 128, k)
    ps, pi, pb = port_extract(q, r, nv, e, 128, k)
    np.testing.assert_allclose(ps, js, atol=ATOL)
    np.testing.assert_allclose(pb, jb, atol=ATOL)
    real = js > jtopk.NEG_INF / 2
    np.testing.assert_array_equal(real, ps > topk.NEG_INF / 2)
    np.testing.assert_array_equal(pi[real], ji[real])
    assert (pi[~real] == 0).all() and (ps[~real] == topk.NEG_INF).all()
    assert pi[real].max() < nv


@pytest.mark.parametrize("e", [1, 2, 4])
def test_extract_topk_ties_go_to_the_lowest_column(e):
    """Duplicate ref rows (near-duplicate frames, padding) score exactly
    alike: small integer entries make every product exact in any order.
    Within a block the lowest column is surfaced first, and the merge keeps
    equal scores in column order, as the JAX argmax peel and top_k do."""
    rng = np.random.default_rng(e)
    d = 32
    r = rng.integers(-1, 2, (256, d)).astype(np.float32)
    q = rng.integers(0, 3, (16, d)).astype(np.float32)
    for col in (9, 70, 100, 130, 200):
        r[col] = 3.0
    js, ji, jb = jax_extract(q, r, 256, e, 128, 8)
    ps, pi, pb = port_extract(q, r, 256, e, 128, 8)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pb, jb)
    # every row's best five are the five copies of the same row: block 0
    # gives its lowest e of 9, 70, 100, block 1 its lowest of 130, 200
    want = [9, 70, 100][:e] + [130, 200][:e]
    np.testing.assert_array_equal(pi[:, : len(want)], np.tile(want, (16, 1)))


def test_extract_topk_bound_covers_unsurfaced_entries():
    rng = np.random.default_rng(2)
    q, r = unit(rng, 16, 64), unit(rng, 256, 64)
    s, i, bound = port_extract(q, r, 256, 2, 128, 4)
    sims = q @ r.T
    for row in range(len(q)):
        assert np.delete(sims[row], i[row]).max() <= bound[row] + ATOL


def test_extract_topk_rejects_what_it_does_not_take():
    q = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        topk.extract_topk(q, torch.zeros(16, 8, dtype=torch.float16), 16, e=2, tile_r=8, k=2)
    with pytest.raises(ValueError):
        topk.extract_topk(q, torch.zeros(16, 8), 17, e=2, tile_r=8, k=2)
    with pytest.raises(ValueError):
        topk.extract_topk(q, torch.zeros(16, 8), 16, e=9, tile_r=8, k=2)


def burst_corpus(seed, nr, d, nq, burst_at, burst_len, noise):
    """Unit refs and queries; query 0 sits on a burst of near-duplicates of
    one ref inside one block, so the per-block extraction truncates there
    and the certificate must send row 0 to the exact rescan."""
    rng = np.random.default_rng(seed)
    refs, q = unit(rng, nr, d), unit(rng, nq, d)
    target = refs[burst_at + 5].copy()
    burst = target[None, :] + rng.normal(0, noise, (burst_len, d)).astype(np.float32)
    refs[burst_at : burst_at + burst_len] = burst / np.linalg.norm(burst, axis=1, keepdims=True)
    q[0] = target
    return refs, q


def assert_rows_match(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_allclose(gs, ws, atol=ATOL)
    np.testing.assert_array_equal(gi, wi)


@pytest.fixture(scope="module")
def fused_corpus():
    return burst_corpus(21, 32768, 32, 64, 1500, 20, 1e-2)


def test_row_topk_on_b5_matches_jax_fused_path(fused_corpus, monkeypatch):
    refs, q = fused_corpus
    k = 10  # nb * e = 128 >= 8 * k_pad: the B5 rule holds
    calls = []
    real = topk.extract_topk

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(topk, "extract_topk", spy)
    port = psearch.SimilaritySearcher(refs, device="cpu")
    assert port._fused_active(16) and not port._fused_active(32)
    got = port.row_topk(q, k)
    assert calls and calls[0]["e"] == 4 and calls[0]["tile_r"] == 1024
    jax_s = jsearch.SimilaritySearcher(refs, use_fused_extract=True)
    want = jax_s.row_topk(q, k)
    assert jax_s._fused_refs_split is not None and not jax_s._fused_failed
    assert_rows_match(got, want)
    sims = q @ refs.T
    np.testing.assert_allclose(got[0], -np.sort(-sims, axis=1)[:, :k], atol=ATOL)
    # the burst row came back whole from the rescan
    assert ((got[1][0] >= 1500) & (got[1][0] < 1520)).all()


@pytest.fixture
def small_tiles(monkeypatch):
    """The port's scan at the JAX searcher's ref_tile=256, extract_e=4."""
    monkeypatch.setattr(psearch, "REF_TILE", 256)
    monkeypatch.setattr(psearch, "EXTRACT_E", 4)


@pytest.mark.parametrize("extract_e,chunk_tiles", [(8, 4), (8, 1), (0, 4)],
                         ids=["fast_scan", "fast_scan_tile_by_tile", "exact_path"])
def test_row_topk_scans_match_jax(extract_e, chunk_tiles, monkeypatch):
    refs, q = burst_corpus(5, 1024, 16, 64, 300, 40, 5e-2)
    k = 8
    monkeypatch.setattr(psearch, "REF_TILE", 256)
    monkeypatch.setattr(psearch, "EXTRACT_E", extract_e)
    monkeypatch.setattr(psearch, "FAST_SCAN_SCORES", chunk_tiles * len(q) * 256)
    scans = []
    for name in ("_row_topk_fast", "_row_topk_exact"):
        real = getattr(psearch, name)
        monkeypatch.setattr(psearch, name,
                            lambda *a, _real=real, _name=name: scans.append(_name) or _real(*a))
    port = psearch.SimilaritySearcher(refs, device="cpu")
    assert not port._fused_active(8)
    want = jsearch.SimilaritySearcher(refs, ref_tile=256, extract_e=extract_e).row_topk(q, k)
    assert_rows_match(port.row_topk(q, k), want)
    # the fast scan flags the burst row and rescans it exactly
    assert scans == (["_row_topk_fast", "_row_topk_exact"] if extract_e else ["_row_topk_exact"])


def test_row_topk_f16_transfer_and_query_tiles_match_jax(monkeypatch):
    rng = np.random.default_rng(7)
    refs, q = unit(rng, 32768, 48), unit(rng, 300, 48)
    monkeypatch.setattr(psearch, "REF_TILE", 512)
    monkeypatch.setattr(psearch, "QUERY_TILE", 128)
    got = psearch.SimilaritySearcher(refs, device="cpu", transfer_dtype=np.float16)
    assert got._fused_active(8)
    kw = dict(transfer_dtype=np.float16, ref_tile=512, query_tile=128)
    want = jsearch.SimilaritySearcher(refs, **kw).row_topk(q, 5)
    assert_rows_match(got.row_topk(q, 5), want)


def test_global_topk_and_threshold_search_match_jax(small_tiles):
    refs, q = burst_corpus(9, 2048, 24, 96, 700, 30, 3e-2)
    port = psearch.SimilaritySearcher(refs, device="cpu")
    jax_s = jsearch.SimilaritySearcher(refs, ref_tile=256, extract_e=4)
    for gk in (50, 700, 5000):  # 5000 needs the budget doubling
        got, want = port.global_topk(q, gk), jax_s.global_topk(q, gk)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], atol=ATOL)
    brute = (q @ refs.T).reshape(-1)
    np.testing.assert_allclose(port.global_topk(q, 5000)[2], -np.sort(-brute)[:5000], atol=ATOL)
    got, want = port.threshold_search(q, 0.45, k0=8), jax_s.threshold_search(q, 0.45, k0=8)
    assert len(got[0]) > 30  # the burst row overflows k0 and is rescanned
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    qi, ri, s = psearch.global_topk_search(q, refs, 40, device="cpu")
    np.testing.assert_array_equal(ri, want_ri := jsearch.global_topk_search(q, refs, 40)[1])
    assert len(want_ri) == 40
    s, i = psearch.knn_search(q, refs, 3, device="cpu")
    np.testing.assert_array_equal(i, jsearch.knn_search(q, refs, 3)[1])


@pytest.mark.parametrize("gk", [700, 5000])
def test_global_topk_deepens_a_subset_of_rows_like_jax(gk, monkeypatch, small_tiles):
    """Rows of larger norm hold most of the global hits (as score-norm's
    per-row bias makes them), so two or more rounds rescan shrinking
    subsets of the rows deeper."""
    refs, q = burst_corpus(9, 2048, 24, 96, 700, 30, 3e-2)
    q = q * np.linspace(0.5, 2.0, len(q), dtype=np.float32)[:, None]
    port = psearch.SimilaritySearcher(refs, device="cpu")
    calls = []
    real = psearch.SimilaritySearcher.row_topk
    monkeypatch.setattr(psearch.SimilaritySearcher, "row_topk",
                        lambda self, x, k: calls.append(len(x)) or real(self, x, k))
    got = port.global_topk(q, gk)
    assert len(calls) >= 2 and all(0 < n < len(q) for n in calls[1:])
    want = jsearch.SimilaritySearcher(refs, ref_tile=256, extract_e=4).global_topk(q, gk)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=ATOL)
    np.testing.assert_allclose(got[2], -np.sort(-(q @ refs.T).reshape(-1))[:gk], atol=ATOL)


def test_video_pair_max_scores_matches_jax():
    rng = np.random.default_rng(3)
    qf, rf = unit(rng, 50, 16), unit(rng, 70, 16)
    q_vid = rng.integers(0, 4, 50)
    r_vid = rng.integers(0, 6, 70)
    q_vid[-3:] = -1  # padding rows
    r_vid[-5:] = -1
    r_vid[r_vid == 5] = 4  # ref video 5 has no frames: -inf
    want = jsearch.video_pair_max_scores(qf, q_vid, rf, r_vid, 4, 6, row_chunk=32)
    got = psearch.video_pair_max_scores(qf, q_vid, rf, r_vid, 4, 6, row_chunk=32, device="cpu")
    assert np.isneginf(got[:, 5]).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def video_features(cls, prefix, count, frames, dim, rng):
    return [cls(video_id=f"{prefix}{i:06d}", timestamps=np.arange(frames, dtype=np.float32),
                feature=rng.standard_normal((frames, dim)).astype(np.float32))
            for i in range(count)]


@pytest.fixture(scope="module")
def sn_corpus():
    rng = np.random.default_rng(11)
    q = video_features(JaxVideoFeature, "Q", 6, 9, 64, rng)
    r = video_features(JaxVideoFeature, "R", 4, 7, 64, rng)
    n = video_features(JaxVideoFeature, "R", 8, 10, 64, np.random.default_rng(12))
    for i, v in enumerate(n):
        v.video_id = f"R{900 + i:06d}"
    return q, r, n


def to_port(videos):
    return [VideoFeature(video_id=v.video_id, timestamps=v.timestamps, feature=v.feature)
            for v in videos]


def test_score_norm_nk10_matches_jax(sn_corpus):
    queries, refs, noise = sn_corpus
    want = jsn.query_score_normalize(queries, noise, beta=1.2, nk=10)
    got = psn.query_score_normalize(to_port(queries), to_port(noise), beta=1.2, nk=10,
                                    device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.feature, w.feature, atol=ATOL)
    wq, wr = jsn.score_normalize(queries, refs, noise, beta=1.5, nk=10)
    gq, gr = psn.score_normalize(to_port(queries), to_port(refs), to_port(noise), beta=1.5,
                                 nk=10, device="cpu")
    for g, w in zip(gq + gr, wq + wr):
        np.testing.assert_allclose(g.feature, w.feature, atol=ATOL)


def test_ref_score_normalize_takes_beta_and_nk(sn_corpus):
    """The call of scripts/scaled_eval.py:110."""
    _, refs, noise = sn_corpus
    want = jsn.ref_score_normalize(refs, noise, beta=1.2, nk=1)
    got = psn.ref_score_normalize(to_port(refs), to_port(noise), beta=1.2, nk=1)
    for g, w in zip(got, want):
        assert g.video_id == w.video_id
        np.testing.assert_array_equal(g.feature, w.feature)


def test_searcher_cache_evicts_least_recently_used():
    psn._SEARCHER_CACHE.clear()
    rng = np.random.default_rng(4)
    corpora = [unit(rng, 20, 8) for _ in range(psn._SEARCHER_CACHE_SIZE + 1)]
    first = psn._cached_searcher(corpora[0], "cpu")
    for c in corpora[1 : psn._SEARCHER_CACHE_SIZE]:
        psn._cached_searcher(c, "cpu")
    assert psn._cached_searcher(corpora[0], "cpu") is first  # a hit refreshes it
    psn._cached_searcher(corpora[-1], "cpu")  # evicts corpora[1], not corpora[0]
    assert psn._cached_searcher(corpora[0], "cpu") is first
    assert len(psn._SEARCHER_CACHE) == psn._SEARCHER_CACHE_SIZE
    keys = [k[2] for k in psn._SEARCHER_CACHE]
    import hashlib

    digest = hashlib.blake2b(corpora[1].tobytes(), digest_size=16).hexdigest()
    assert digest not in keys
    psn._SEARCHER_CACHE.clear()
