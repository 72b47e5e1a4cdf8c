"""Port PCA fit and score normalization against the JAX package."""

import numpy as np
import pytest

from vsc22_tpu.core.types import VideoFeature
from vsc22_tpu.ops.pca import pca_fit as jax_pca_fit
from vsc22_tpu.retrieval import score_norm as jsn
from vsc22_tpu_torch.ops.pca import pca_fit
from vsc22_tpu_torch.retrieval import score_norm as psn


def test_pca_fit_matches_jax_on_separated_spectrum():
    rng = np.random.default_rng(0)
    basis, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    scales = np.linspace(12.0, 1.0, 24)
    x = (rng.standard_normal((800, 24)) * scales) @ basis.T + rng.standard_normal(24)
    x = x.astype(np.float32)
    want, got = jax_pca_fit(x, 10), pca_fit(x, 10, device="cpu")
    np.testing.assert_allclose(got.mean, want.mean, atol=1e-5)
    # Both apply sklearn's svd_flip rule, so signs agree; JAX solves in f32,
    # the port in f64.
    np.testing.assert_allclose(got.components, want.components, atol=1e-4)
    np.testing.assert_allclose(got.explained_variance, want.explained_variance, rtol=1e-4)
    np.testing.assert_allclose(got.transform(x[:5]), want.transform(x[:5]), atol=1e-3)


def features(prefix, count, frames, dim, rng):
    return [
        VideoFeature(
            video_id=f"{prefix}{i:06d}",
            timestamps=np.arange(frames[i % len(frames)], dtype=np.float32),
            feature=rng.standard_normal((frames[i % len(frames)], dim)).astype(np.float32),
        )
        for i in range(count)
    ]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(1)
    return (features("Q", 5, [7, 3, 11], 512, rng), features("R", 4, [6, 9], 512, rng),
            features("N", 6, [10, 4], 512, rng))


def test_query_score_normalize_matches_jax(corpus):
    queries, _, noise = corpus
    scores = {q.video_id: s for q, s in zip(queries, [0.5, 0.0001, 0.9, 0.002, 0.0])}
    want = jsn.query_score_normalize(queries, noise, video_scores=scores, beta=1.2)
    got = psn.query_score_normalize(queries, noise, video_scores=scores, beta=1.2,
                                    device="cpu")
    assert [g.video_id for g in got] == [w.video_id for w in want]
    for g, w, q in zip(got, want, queries):
        assert g.feature.shape == (len(q.feature), 512)  # 511 kept + bias
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        # Bias column: -1.2 x an f32 row max; gated videos exactly -100.
        np.testing.assert_allclose(g.feature, w.feature, atol=2e-6, rtol=0)
        if scores[q.video_id] < 0.001:
            assert (g.feature[:, -1] == -100.0).all()
        else:
            assert (g.feature[:, -1] > -100.0).all()


def test_score_normalize_and_ref_side_match_jax(corpus):
    queries, refs, noise = corpus
    wq, wr = jsn.score_normalize(queries, refs, noise, beta=1.5)
    gq, gr = psn.score_normalize(queries, refs, noise, beta=1.5, device="cpu")
    for g, w in zip(gq + gr, wq + wr):
        np.testing.assert_allclose(g.feature, w.feature, atol=2e-6, rtol=0)
    for g, w in zip(psn.ref_score_normalize(refs, noise), jsn.ref_score_normalize(refs, noise)):
        np.testing.assert_array_equal(g.feature, w.feature)
    assert (gr[0].feature[:, -1] == 1.0).all()


def test_unported_and_invalid_uses_raise(corpus):
    """nk > 1 is ported now (through the searcher; its parity with the JAX
    package is in test_torch_search.py), so it runs; score-normalizing
    against the evaluated refs themselves still raises."""
    queries, refs, noise = corpus
    out = psn.query_score_normalize(queries, noise, nk=10, device="cpu")
    assert [q.video_id for q in out] == [q.video_id for q in queries]
    for q, src in zip(out, queries):
        assert q.feature.shape == src.feature.shape and np.isfinite(q.feature).all()
    with pytest.raises(ValueError):
        psn.ref_score_normalize(refs, refs)
    with pytest.raises(ValueError):
        psn.score_normalize(queries, refs, refs, device="cpu")


def test_entry_points_default_to_the_card(corpus):
    """With no device named, the PCA fit and score-norm run on the card, and
    without one they raise instead of falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        return
    queries, refs, noise = corpus
    x = np.random.default_rng(2).standard_normal((50, 8)).astype(np.float32)
    for call in (lambda: pca_fit(x, 4),
                 lambda: psn.query_score_normalize(queries, noise),
                 lambda: psn.score_normalize(queries, refs, noise)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
