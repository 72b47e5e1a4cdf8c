"""The ported slice end to end against the JAX pipeline, in the four-member
configuration of `bench.py --smoke`: a tiny ViT member + three tiny SwinV2
members (size 32, preset "vit") + tiny CLIP/VSM VED gate + FSD + the
JAX-fitted PCA + query score-norm (nk=1), on the bench's synthetic corpus,
f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from vsc22_tpu.core.types import VideoFeature
from test_torch_swinv2 import randomized_params
from vsc22_tpu.models.clip import clip_tiny_test
from vsc22_tpu.models.swinv2 import SWINV2_TINY_TEST, SwinTransformerV2
from vsc22_tpu.models.vit import vit_tiny_test_descriptor
from vsc22_tpu.models.vsm import VSMConfig, VideoScoreModel
from vsc22_tpu.ops.pca import pca_fit
from vsc22_tpu.pipelines import batch_query as jbq
from vsc22_tpu.retrieval.score_norm import query_score_normalize as jax_qsn
from vsc22_tpu_torch.models import clip, swinv2, vit, vsm
from vsc22_tpu_torch.ops.pca import PCAModel
from vsc22_tpu_torch.pipelines import batch_query as pbq
from vsc22_tpu_torch.retrieval.score_norm import query_score_normalize
from vsc22_tpu_torch.utils import jax_params

VSM_SIZE = dict(feat_dim=32, hidden=32, layers=1, heads=2, max_frames=8)
N_VIDEOS = 8


@pytest.fixture(scope="module")
def runs():
    vit_j = vit_tiny_test_descriptor()
    vit_p = jax.device_get(vit_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    clip_j = clip_tiny_test()
    clip_p = jax.device_get(clip_j.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    vsm_j = VideoScoreModel(cfg=VSMConfig(**VSM_SIZE))
    vsm_p = jax.device_get(vsm_j.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 32))))
    # Three members of one architecture with their own weights, so the
    # concat order shows; randomized so no block is an identity.
    swin_j = SwinTransformerV2(cfg=SWINV2_TINY_TEST)
    swin_init = swin_j.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)))
    swin_ps = [{"params": randomized_params(swin_init["params"], 10 + i)} for i in range(3)]
    feat_dim = 16 + 3 * SWINV2_TINY_TEST.output_dim
    pca = pca_fit(
        np.random.default_rng(3).standard_normal((100, feat_dim)).astype(np.float32), 8
    )

    videos = bench.synth_videos(N_VIDEOS, 6, 128, 128)
    names = [f"Q{i:06d}" for i in range(N_VIDEOS)]
    rng = np.random.default_rng(4)
    noise = [
        VideoFeature(video_id=f"R{i:06d}", timestamps=np.arange(5, dtype=np.float32),
                     feature=rng.standard_normal((5, 8)).astype(np.float32))
        for i in range(10)
    ]

    jpipe = jbq.BatchedQueryPipeline(
        [jbq.BatchedExtractor(model=vit_j, params=vit_p, size=64, preset="efficientnet",
                              chunk=4)]
        + [jbq.BatchedExtractor(model=swin_j, params=p, size=32, preset="vit", chunk=4)
           for p in swin_ps],
        pca=pca, ved=jbq.BatchedVED(clip_j, clip_p, vsm_j, vsm_p, max_frames=8, chunk=4),
        use_fsd=True, score_threshold=0.0, out_dim=8,
    )
    ppipe = pbq.BatchedQueryPipeline(
        [pbq.BatchedExtractor(
            jax_params.load_vit_descriptor(vit.vit_tiny_test_descriptor(), vit_p),
            size=64, preset="efficientnet", chunk=4)]
        + [pbq.BatchedExtractor(
            jax_params.load_swinv2_descriptor(swinv2.swinv2_tiny_test_descriptor(), p),
            size=32, preset="vit", chunk=4) for p in swin_ps],
        pca=PCAModel(pca.mean, pca.components, pca.explained_variance),
        ved=pbq.BatchedVED(
            jax_params.load_clip_visual(clip.clip_tiny_test(), clip_p),
            jax_params.load_video_score_model(
                vsm.VideoScoreModel(vsm.VSMConfig(**VSM_SIZE)), vsm_p),
            max_frames=8, chunk=4),
        use_fsd=True, score_threshold=0.0, out_dim=8, device="cpu",
    )
    want = jpipe.process_many(names, videos, batch=4)
    got = ppipe.process_many(names, videos, batch=4)
    want_sn = jax_qsn(want, noise, video_scores=jpipe.video_scores, score_threshold=0.0,
                      beta=1.2, nk=1)
    got_sn = query_score_normalize(got, noise, video_scores=ppipe.video_scores,
                                   score_threshold=0.0, beta=1.2, nk=1, device="cpu")
    ctx = jpipe._prepare(names, videos)
    got_boxes = ppipe._fsd_boxes(
        videos, [torch.from_numpy(v) for v in videos], [ppipe.video_scores[n] for n in names]
    )
    return dict(
        names=names, want=want, got=got, want_sn=want_sn, got_sn=got_sn, jpipe=jpipe,
        ppipe=ppipe, want_counts=ctx["frame_counts"],
        got_counts=[len(v) * len(b) for v, b in zip(videos, got_boxes)],
        want_boxes=[[tuple(int(c) for c in box) for _, box in p] for p in ctx["proc"]],
        got_boxes=[[tuple(int(c) for c in box) for box in b] for b in got_boxes],
    )


def test_names_and_timestamps_identical(runs):
    assert [f.video_id for f in runs["got"]] == runs["names"]
    for g, w in zip(runs["got"], runs["want"]):
        np.testing.assert_array_equal(g.timestamps, w.timestamps)


def test_fsd_boxes_and_frame_counts_identical(runs):
    assert runs["got_counts"] == runs["want_counts"]
    assert runs["got_boxes"] == runs["want_boxes"]
    full = [(0, 128, 0, 128)]
    assert any(b != full for b in runs["got_boxes"])  # FSD cut the letterboxed video


def test_ved_scores_match(runs):
    for n in runs["names"]:
        assert abs(runs["ppipe"].video_scores[n] - runs["jpipe"].video_scores[n]) <= 1e-5


def test_features_match(runs):
    for g, w in zip(runs["got"], runs["want"]):
        assert g.feature.shape == w.feature.shape and g.feature.shape[1] == 8
        np.testing.assert_allclose(g.feature, w.feature, atol=1e-4, rtol=0)


def test_score_normalized_features_match(runs):
    for g, w in zip(runs["got_sn"], runs["want_sn"]):
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        np.testing.assert_allclose(g.feature, w.feature, atol=1e-4, rtol=0)


def test_placeholder_sequence_matches_reference_seeding():
    """Videos under the score threshold get np.random.seed(k)-equivalent
    placeholders with timestamps [[0, 1]], k counting across batches."""
    model = vit.vit_tiny_test_descriptor()
    pipe = pbq.BatchedQueryPipeline(
        [pbq.BatchedExtractor(model, size=64)], ved=None, use_fsd=False,
        score_threshold=2.0, out_dim=8, device="cpu",
    )
    videos = bench.synth_videos(3, 2, 64, 64)
    out = pipe.process_many(["A", "B", "C"], videos, batch=2)
    for k, f in enumerate(out, start=1):
        np.random.seed(k)
        np.testing.assert_array_equal(
            f.feature[0], np.random.uniform(-1e-5, 1e-5, size=8).astype(np.float32)
        )
        assert f.timestamps.shape == (1, 2)


def test_four_members_concatenated_in_order(runs):
    """The pre-PCA rows are [ViT | Swin 1 | Swin 2 | Swin 3], each member
    L2-normalized on its own, as in the JAX pipeline."""
    pipe = runs["ppipe"]
    assert [e.model.out_dim for e in pipe.extractors] == [16, 8, 8, 8]
    assert pipe.pca.components.shape == (8, 40)


def test_pipeline_defaults_to_the_card():
    """With no device named, the pipeline runs on the card, and without one
    it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        return
    model = vit.vit_tiny_test_descriptor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbq.BatchedQueryPipeline([pbq.BatchedExtractor(model, size=64)], ved=None)


def test_chip_smoke_synth_videos_is_the_bench_corpus():
    for a, b in zip(chip_smoke.synth_videos(9, 3, 48, 40), bench.synth_videos(9, 3, 48, 40)):
        np.testing.assert_array_equal(a, b)
