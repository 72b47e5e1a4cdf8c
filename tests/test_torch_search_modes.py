"""The searcher's two modes against the JAX package's `SimilaritySearcher`
on the CPU: `compute_dtype` bf16 (the port's bf16 operands, B5's plain
version on a corpus that takes B5, the plain scans on one that does not)
and `use_approx=True` (the port's exact path; JAX's `approx_max_k` lowers to
an exact reduction off the TPU), through `row_topk`, `global_topk` and
`threshold_search`, and once at 2 gloo ranks (`mesh=`) against JAX's
sharded searcher.

Bars: scores within 1e-5; the same top-k sets except where the k-th and
(k+1)-th scores lie within 1e-5 (a near tie at the cut may go either way);
every returned index scores what it is returned with. On an integer
corpus with duplicate rows every score is exact, so scores agree bit for
bit (duplicates may swap)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as workers
from test_torch_search import burst_corpus, unit
from vsc22_tpu.retrieval import search as jsearch
from vsc22_tpu_torch.parallel.launcher import launch_local
from vsc22_tpu_torch.retrieval import search as psearch

ATOL = 1e-5
MODES = {"bf16": (dict(compute_dtype=jnp.bfloat16), dict(compute_dtype=torch.bfloat16)),
         "approx": (dict(use_approx=True), dict(use_approx=True))}


def rounded(x, mode):
    """The operands as the mode multiplies them, in float64."""
    if mode != "bf16":
        return x.astype(np.float64)
    return torch.from_numpy(x).bfloat16().double().numpy()


def int_corpus(seed=3):
    rng = np.random.default_rng(seed)
    refs = rng.integers(-1, 2, (512, 32)).astype(np.float32)
    refs[300:310] = refs[17]  # duplicate rows
    refs[100] = refs[400] = 3.0
    return refs, rng.integers(0, 3, (24, 32)).astype(np.float32)


CORPORA = {
    # the plain scans (one 2048-row tile)
    "scan": lambda: burst_corpus(9, 2048, 24, 48, 700, 30, 3e-2),
    # B5's plain version (>= 32768 rows)
    "b5": lambda: burst_corpus(21, 32768, 32, 32, 1500, 20, 1e-2),
}


def assert_rows_agree(got, want_k1, q, r, mode):
    """Port (scores, indices) [Nq, k] against JAX's at k + 1."""
    (gs, gi), (ws, wi) = got, want_k1
    k = gs.shape[1]
    np.testing.assert_allclose(gs, ws[:, :k], atol=ATOL, rtol=0)
    exact = np.einsum("id,id->i", np.repeat(rounded(q, mode), k, 0),
                      rounded(r, mode)[gi.reshape(-1)]).reshape(gs.shape)
    np.testing.assert_allclose(gs, exact, atol=ATOL, rtol=0)
    for row in range(len(gs)):
        if ws[row, k - 1] - ws[row, k] > ATOL:
            assert set(gi[row]) == set(wi[row, :k]), row


def assert_hits_agree(got, want, q, r, mode, cut: float):
    """(rows, cols, scores) hit lists: every hit scoring above `cut` + 1e-5
    in both, the common hits' scores within 1e-5, each hit's score its own."""
    exact = np.einsum("id,id->i", rounded(q, mode)[got[0]], rounded(r, mode)[got[1]])
    np.testing.assert_allclose(got[2], exact, atol=ATOL, rtol=0)
    g = {(a, b): s for a, b, s in zip(*got)}
    w = {(a, b): s for a, b, s in zip(*want)}
    assert {p for p, s in g.items() if s > cut + ATOL} == {p for p, s in w.items()
                                                           if s > cut + ATOL}
    assert all(abs(g[p] - w[p]) <= ATOL for p in g.keys() & w.keys())


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_searcher_mode_matches_jax(mode, corpus):
    refs, q = CORPORA[corpus]()
    jkw, pkw = MODES[mode]
    js = jsearch.SimilaritySearcher(refs, **jkw)
    ps = psearch.SimilaritySearcher(refs, device="cpu", **pkw)
    assert ps.compute_dtype == pkw.get("compute_dtype") and ps.use_approx == (mode == "approx")
    assert ps._fused_active(16) == (corpus == "b5")
    k = 10
    assert_rows_agree(ps.row_topk(q, k), js.row_topk(q, k + 1), q, refs, mode)
    gk = 300
    got = ps.global_topk(q, gk)
    want = jsearch.SimilaritySearcher(refs, **jkw).global_topk(q, gk + 1)
    np.testing.assert_allclose(got[2], want[2][:gk], atol=ATOL, rtol=0)
    assert_hits_agree(got, tuple(x[:gk] for x in want), q, refs, mode, cut=float(want[2][gk]))
    if corpus == "scan":
        thr = 0.5
        assert_hits_agree(ps.threshold_search(q, thr, k0=8), js.threshold_search(q, thr, k0=8),
                          q, refs, mode, cut=thr)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_searcher_mode_on_integer_corpus_is_bitwise(mode):
    refs, q = int_corpus()
    jkw, pkw = MODES[mode]
    ps = psearch.SimilaritySearcher(refs, device="cpu", **pkw)
    js = jsearch.SimilaritySearcher(refs, **jkw)
    exact = q.astype(np.float64) @ refs.T.astype(np.float64)
    gs, gi = ps.row_topk(q, 8)
    ws, _ = js.row_topk(q, 8)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gs, np.take_along_axis(exact, gi.astype(np.int64), 1))
    got, want = ps.global_topk(q, 100), js.global_topk(q, 100)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], exact[got[0], got[1]])


def test_compute_dtype_takes_bf16_only():
    refs = unit(np.random.default_rng(0), 64, 8)
    for bad in (torch.float16, jnp.bfloat16, "bfloat16"):
        with pytest.raises(TypeError, match="compute_dtype"):
            psearch.SimilaritySearcher(refs, device="cpu", compute_dtype=bad)
    s = psearch.SimilaritySearcher(refs, device="cpu", transfer_dtype=np.float16,
                                   compute_dtype=torch.bfloat16)
    # shipped as f16, multiplied as bf16 (the JAX searcher's two casts)
    want = torch.from_numpy(refs.astype(np.float16)).bfloat16()
    assert s.refs.dtype == torch.bfloat16 and torch.equal(s.refs[:64], want)


def test_bf16_mesh_search_matches_jax(tmp_path):
    """`compute_dtype` bf16 and `use_approx` at 2 gloo ranks against JAX's
    sharded searcher on a (2, 1) mesh and the port's one-rank searcher."""
    refs, q = CORPORA["scan"]()
    got = launch_local(workers.search_modes_rank, 2, args=(str(tmp_path / "store"), refs, q),
                       timeout=300.0)
    assert all(set(r) == set(got[0]) for r in got)
    for r in got[1:]:
        for key in got[0]:
            for a, b in zip(r[key], got[0][key]):
                np.testing.assert_array_equal(a, b)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    for mode, (jkw, pkw) in MODES.items():
        js = jsearch.SimilaritySearcher(refs, mesh=mesh, **jkw)
        assert_rows_agree(got[0][f"{mode}_row_topk"], js.row_topk(q, 11), q, refs, mode)
        want = js.global_topk(q, 301)
        assert_hits_agree(got[0][f"{mode}_global_topk"], tuple(x[:300] for x in want), q, refs,
                          mode, cut=float(want[2][300]))
        one = psearch.SimilaritySearcher(refs, device="cpu", **pkw).row_topk(q, 10)
        np.testing.assert_allclose(got[0][f"{mode}_row_topk"][0], one[0], atol=ATOL, rtol=0)
