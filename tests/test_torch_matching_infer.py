"""The matching track's stages 3-6 in the port against the JAX package on
the CPU: recall (dense and hit-list paths), the classify and refine
ensembles (host and device-image paths), and `matching_inference` end to
end on both paths. Models: two full-width MobileNetV3-Small folds and two
tiny SAM HRNet folds in float32, random JAX variables
(`test_torch_matching_models.jax_variables`) carried by `utils.jax_params`.
A random SAM's heatmaps have no line for the decode to find, so the end
to end test also runs with a refine "model" written for the test on both
sides, logits (0, gain * (sim - 0.6)), whose heatmaps light up the
planted copies' diagonals.

Tolerances:
- recall: the same pairs in the same order, scores within 2e-5 (JAX's
  own dense-vs-hit-list bar; both are f32 products of unit vectors);
- probabilities and heatmaps within 1e-5 (f32 logits agree to ~1e-6),
  raw sim crops within 1e-5;
- end to end: the same kept pairs, and match rows with the same ids and
  bounds and scores within 1e-4 (a score is max - std * ratio over
  heatmap values that agree to 1e-5).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_matching_models import jax_variables
from vsc22_tpu.core.types import VideoFeature as JVideoFeature
from vsc22_tpu.matching import simmat as jsimmat
from vsc22_tpu.models import hrnet as jhrnet
from vsc22_tpu.models import mobilenetv3 as jmnv3
from vsc22_tpu.pipelines import matching_infer as jinfer
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.matching import simmat
from vsc22_tpu_torch.models import hrnet, mobilenetv3
from vsc22_tpu_torch.pipelines import matching_infer
from vsc22_tpu_torch.utils import jax_params

RECALL_TOL = 2e-5
PROB_TOL = 1e-5
SCORE_TOL = 1e-4


def normed(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def corpus(seed=1):
    """Port and JAX VideoFeatures of 4 queries and 7 refs (16-d): Q0 copies
    R0 frames 3-9, Q1 is split in two segments of 12 (the copy of R1 in
    the second), Q2 in three of 8 (the last partial), Q3 plain. Returns
    (port queries, port refs, jax queries, jax refs, num_frames map)."""
    rng = np.random.default_rng(seed)
    refs = [normed(rng.standard_normal((20 + 3 * i, 16))) for i in range(7)]
    qs = [normed(rng.standard_normal((n, 16))) for n in (15, 24, 20, 18)]
    qs[0][5:12] = refs[0][3:10]
    qs[1][14:22] = refs[1][2:10]
    nf = {"Q000000": 15, "Q000001": 12, "Q000002": 8, "Q000003": 18}

    def mk(cls, prefix, feats):
        return [cls(video_id=f"{prefix}{i:06d}", feature=f.copy(),
                    timestamps=np.arange(len(f), dtype=np.float32))
                for i, f in enumerate(feats)]

    return (mk(VideoFeature, "Q", qs), mk(VideoFeature, "R", refs),
            mk(JVideoFeature, "Q", qs), mk(JVideoFeature, "R", refs), nf)


def assert_candidates_equal(got, want):
    assert [(q, r) for q, r, _ in got] == [(q, r) for q, r, _ in want]
    np.testing.assert_allclose([s for *_, s in got], [s for *_, s in want], atol=RECALL_TOL,
                               rtol=0)


@pytest.mark.parametrize("path", ["dense", "hit_list"])
def test_recall_candidates_matches_jax(path, monkeypatch):
    pq, pr, jq, jr, _ = corpus()
    if path == "hit_list":
        monkeypatch.setattr(matching_infer, "DENSE_PAIR_LIMIT", 0)
    for threshold in (-0.1, 0.3):
        got = matching_infer.recall_candidates(pq, pr, threshold, device="cpu")
        want = jinfer.recall_candidates(jq, jr, threshold)
        assert_candidates_equal(got, want)
    assert got[0][:2] in {("Q000000", "R000000"), ("Q000001", "R000001")} and got[0][2] > 0.99


@pytest.fixture(scope="module")
def ensembles():
    """(port classify, port refine, JAX classify, JAX refine), two folds
    each, batch 8 and 4."""
    cls_x = np.random.default_rng(5).uniform(-1, 1, (2, 160, 160, 3)).astype(np.float32)
    ref_x = np.random.default_rng(6).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jm, jh = jmnv3.mobilenetv3_small(), jhrnet.sam_hrnet_tiny_test()
    cls_vars = [jax_variables(jm, cls_x, seed=10 + f, last="classifier") for f in range(2)]
    ref_vars = [jax_variables(jh, ref_x, seed=20 + f, last="fuse2") for f in range(2)]
    port_cls = [jax_params.load_mobilenetv3(mobilenetv3.mobilenetv3_small(device="cpu"), v)
                for v in cls_vars]
    port_ref = [jax_params.load_sam_hrnet(hrnet.sam_hrnet_tiny_test(), v) for v in ref_vars]
    return (matching_infer.ClassifyEnsemble(port_cls, batch=8, device="cpu"),
            matching_infer.RefineEnsemble(port_ref, batch=4, device="cpu"),
            jinfer.ClassifyEnsemble([(jm, v) for v in cls_vars], batch=8),
            jinfer.RefineEnsemble([(jh, v) for v in ref_vars], batch=4))


def test_classify_ensemble_matches_jax(ensembles):
    classify, _, jclassify, _ = ensembles
    pq, pr, _, _, nf = corpus()
    rng = np.random.default_rng(2)
    sims = [rng.uniform(-1, 1, (30 + 7 * i, 170 - 20 * i)).astype(np.float32) for i in range(9)]
    got = classify.predict(sims)
    want = jclassify.predict(sims)
    assert got.shape == (9,) and classify.predict([]).shape == (0,)
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    assert got.max() - got.min() > 1e-3  # the models tell the images apart

    qmap = {v.video_id: v.feature for v in pq}
    rmap = {v.video_id: v.feature for v in pr}
    pairs = [(q, r) for q in qmap for r in list(rmap)[:3]]
    chunks = simmat.DeviceSimBuilder(qmap, rmap, nf, device="cpu").images(pairs, 160, chunk=4)
    jchunks = jsimmat.DeviceSimBuilder(qmap, rmap, nf).images(pairs, 160, chunk=4)
    for g, w in zip(classify.predict_device(chunks), jclassify.predict_device(jchunks)):
        assert g.shape == (len(pairs),)
        np.testing.assert_allclose(g, w, atol=PROB_TOL, rtol=0)


def test_refine_ensemble_matches_jax(ensembles):
    _, refine, _, jrefine = ensembles
    pq, pr, _, _, nf = corpus()
    meta = [(q.video_id, r.video_id, q.feature, r.feature) for q in pq[:3] for r in pr[:2]]
    for got, want in ((refine.predict(meta), jrefine.predict(meta)),):
        assert [g[:2] for g in got] == [w[:2] for w in want] and len(got) == 6
        for (_, _, gp, graw), (_, _, wp, wraw) in zip(got, want):
            assert gp.shape == wp.shape == graw.shape
            np.testing.assert_allclose(gp, wp, atol=PROB_TOL, rtol=0)
            np.testing.assert_allclose(graw, wraw, atol=PROB_TOL, rtol=0)

    qmap = {v.video_id: v.feature for v in pq}
    rmap = {v.video_id: v.feature for v in pr}
    pairs = [(q, r) for q in qmap for r in list(rmap)[:3]]  # 12 pairs: 3 chunks of 4
    got = refine.predict_device(simmat.DeviceSimBuilder(qmap, rmap, nf, device="cpu"), pairs)
    want = jrefine.predict_device(jsimmat.DeviceSimBuilder(qmap, rmap, nf), pairs)
    assert [g[:2] for g in got] == pairs == [w[:2] for w in want]
    for (_, _, gp, graw), (_, _, wp, wraw) in zip(got, want):
        assert gp.shape == wp.shape  # cropped to the selected segment
        assert ((gp >= 0) & (gp <= 1)).all()
        np.testing.assert_allclose(gp, wp, atol=PROB_TOL, rtol=0)
        np.testing.assert_allclose(graw, wraw, atol=PROB_TOL, rtol=0)
    assert got[pairs.index(("Q000001", "R000000"))][2].shape == (12, 20)


class JaxSimThreshold(fnn.Module):
    """[B, H, W, 3] -> logits (0, gain * (sim - 0.6)) per pixel."""

    @fnn.compact
    def __call__(self, x, train=False):
        gain = self.param("gain", lambda _: jnp.float32(12.0))
        s = x[..., :1].astype(jnp.float32)
        return jnp.concatenate([jnp.zeros_like(s), gain * (s - 0.6)], axis=-1)


class SimThreshold(torch.nn.Module):
    """The port's twin of `JaxSimThreshold`."""

    def __init__(self):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.tensor(12.0))

    def forward(self, x):
        s = x[..., :1].float()
        return torch.cat([torch.zeros_like(s), self.gain * (s - 0.6)], dim=-1)


def kept_pairs(monkeypatch, ensemble_cls):
    """Records the pairs `matching_inference` hands to the refine stage."""
    seen = []
    device, host = ensemble_cls.predict_device, ensemble_cls.predict

    def on_device(self, builder, pairs):
        seen.extend(pairs)
        return device(self, builder, pairs)

    def on_host(self, meta):
        seen.extend((q, r) for q, r, *_ in meta)
        return host(self, meta)

    monkeypatch.setattr(ensemble_cls, "predict_device", on_device)
    monkeypatch.setattr(ensemble_cls, "predict", on_host)
    return seen


@pytest.mark.parametrize("refine_model", ["sam_tiny", "sim_threshold"])
@pytest.mark.parametrize("device_sims", [True, False], ids=["device_sims", "host"])
def test_matching_inference_matches_jax(ensembles, device_sims, refine_model, monkeypatch):
    classify, refine, jclassify, jrefine = ensembles
    keep = 0.25
    if refine_model == "sim_threshold":
        refine = matching_infer.RefineEnsemble([SimThreshold(), SimThreshold()], batch=4,
                                               device="cpu")
        jm = JaxSimThreshold()
        jrefine = jinfer.RefineEnsemble(
            [(jm, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))] * 2, batch=4)
        keep = None
    pq, pr, jq, jr, nf = corpus()
    kept = kept_pairs(monkeypatch, matching_infer.RefineEnsemble)
    jkept = kept_pairs(monkeypatch, jinfer.RefineEnsemble)
    kwargs = dict(cls_threshold=0.0, cls_keep_fraction=keep, max_candidates=24,
                  use_device_sims=device_sims)
    got = matching_infer.matching_inference(
        pq, pr, [dataclasses.replace(v) for v in pq], [dataclasses.replace(v) for v in pr], nf,
        classify, refine, device="cpu", **kwargs)
    want = jinfer.matching_inference(
        jq, jr, [dataclasses.replace(v) for v in jq], [dataclasses.replace(v) for v in jr], nf,
        jclassify, jrefine, **kwargs)
    assert kept == jkept and len(kept) == (6 if keep else 24)
    assert sorted(r[:6] for r in got) == sorted(r[:6] for r in want)
    want_score = {tuple(r[:6]): r[6] for r in want}
    for row in got:
        assert abs(row[6] - want_score[tuple(row[:6])]) <= SCORE_TOL
        qid, rid, qs, qe, rs, re, score = row
        assert 0 <= qs <= qe and 0 <= rs <= re and np.isfinite(score)
    if refine_model == "sim_threshold":  # both planted copies are found
        assert {("Q000000", "R000000"), ("Q000001", "R000001")} <= {(r[0], r[1]) for r in got}
