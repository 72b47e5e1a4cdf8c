"""The port's per-video `QueryPipeline` (exact host FSD, the VED gate, a
tiny ViT + a tiny SwinV2 member, the JAX-fitted PCA) against the JAX
package's on the same frames and weights, f32 on the CPU. The JAX side
runs with OpenCV's IPP route off (`cv2.ipp.setUseIPP`), whose resize
rounds ~4% of values one level off OpenCV's generic arithmetic, which the
port computes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_torch_cv2_numerics import make_video  # noqa: E402
from test_torch_swinv2 import randomized_params  # noqa: E402
from vsc22_tpu.data import fsd as jfsd  # noqa: E402
from vsc22_tpu.models.clip import clip_tiny_test  # noqa: E402
from vsc22_tpu.models.swinv2 import SWINV2_TINY_TEST, SwinTransformerV2  # noqa: E402
from vsc22_tpu.models.vit import vit_tiny_test_descriptor  # noqa: E402
from vsc22_tpu.models.vsm import VSMConfig, VideoScoreModel  # noqa: E402
from vsc22_tpu.ops.pca import pca_fit  # noqa: E402
from vsc22_tpu.pipelines import query_extract as jq  # noqa: E402
from vsc22_tpu_torch.data import fsd  # noqa: E402
from vsc22_tpu_torch.models import clip, swinv2, vit, vsm  # noqa: E402
from vsc22_tpu_torch.ops.pca import PCAModel  # noqa: E402
from vsc22_tpu_torch.pipelines import query_extract as pq  # noqa: E402
from vsc22_tpu_torch.utils import jax_params  # noqa: E402

FEAT_TOL = 1e-3  # f32 descriptors after PCA: the bar of tests/test_ref_parity.py
VSM_SIZE = dict(feat_dim=32, hidden=32, layers=1, heads=2, max_frames=8)
KINDS = ["plain", "letterbox", "vstack", "hstack", "static"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: these tests run beside other test workers,
    and the Canny flood's many small ops thrash an oversubscribed pool."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def jax_side(ved_threshold):
    vit_j = vit_tiny_test_descriptor()
    vit_p = jax.device_get(vit_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    swin_j = SwinTransformerV2(cfg=SWINV2_TINY_TEST)
    swin_init = swin_j.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)))
    swin_p = {"params": randomized_params(swin_init["params"], 11)}
    clip_j = clip_tiny_test()
    clip_p = jax.device_get(clip_j.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    vsm_j = VideoScoreModel(cfg=VSMConfig(**VSM_SIZE))
    vsm_p = jax.device_get(vsm_j.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 32))))
    feat_dim = 16 + SWINV2_TINY_TEST.output_dim
    pca = pca_fit(np.random.default_rng(3).standard_normal((200, feat_dim)).astype(np.float32),
                  8)
    pipe = jq.QueryPipeline(
        [jq.DescriptorExtractor(model=vit_j, params=vit_p, size=64, preset="efficientnet"),
         jq.DescriptorExtractor(model=swin_j, params=swin_p, size=32, preset="vit")],
        pca=pca, ved=jq.VideoEditDetector(clip_j, clip_p, vsm_j, vsm_p, max_frames=8),
        score_threshold=ved_threshold, out_dim=8,
    )
    return pipe, dict(vit=vit_p, swin=swin_p, clip=clip_p, vsm=vsm_p)


def port_side(params, pca, ved_threshold):
    ved = pq.VideoEditDetector(
        jax_params.load_clip_visual(clip.clip_tiny_test(), params["clip"]),
        jax_params.load_video_score_model(vsm.VideoScoreModel(vsm.VSMConfig(**VSM_SIZE)),
                                          params["vsm"]),
        max_frames=8, device="cpu")
    return pq.QueryPipeline(
        [pq.DescriptorExtractor(
            jax_params.load_vit_descriptor(vit.vit_tiny_test_descriptor(), params["vit"]),
            size=64, preset="efficientnet", device="cpu"),
         pq.DescriptorExtractor(
            jax_params.load_swinv2_descriptor(swinv2.swinv2_tiny_test_descriptor(),
                                              params["swin"]),
            size=32, preset="vit", device="cpu")],
        pca=PCAModel(pca.mean, pca.components, pca.explained_variance), ved=ved,
        score_threshold=ved_threshold, out_dim=8, device="cpu",
    )


@pytest.fixture(scope="module")
def runs():
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        videos = [make_video(k, 20 + i)[:8] for i, k in enumerate(KINDS)]
        names = [f"Q{i:06d}" for i in range(len(videos))]
        pipe0, params = jax_side(0.0)
        scores = [pipe0.ved.score(v) for v in videos]
        # A threshold between the scores, so that some videos are gated.
        threshold = float(np.sort(scores)[len(scores) // 2])
        jpipe, _ = jax_side(threshold)
        jpipe.extractors, jpipe.ved, jpipe.pca = pipe0.extractors, pipe0.ved, pipe0.pca
        want = [jpipe.process_video(n, v) for n, v in zip(names, videos)]
        want_fsd = [jfsd.image_process(v) for v in videos]
    finally:
        cv2.ipp.setUseIPP(saved)
    ppipe = port_side(params, jpipe.pca, threshold)
    got = [ppipe.process_video(n, v) for n, v in zip(names, videos)]
    got_fsd = [fsd.image_process(v, "cpu") for v in videos]
    return dict(names=names, want=want, got=got, jpipe=jpipe, ppipe=ppipe,
                want_fsd=want_fsd, got_fsd=got_fsd, threshold=threshold)


def test_fsd_crops_identical(runs):
    assert any(w[0] for w in runs["want_fsd"])  # some video was cut
    for (gc, gf), (wc, wf) in zip(runs["got_fsd"], runs["want_fsd"]):
        assert gc == wc and [f.shape for f in gf] == [f.shape for f in wf]
        for a, b in zip(gf, wf):
            np.testing.assert_array_equal(a, b)


def test_ved_scores_and_gate(runs):
    gated = 0
    for n in runs["names"]:
        g, w = runs["ppipe"].video_scores[n], runs["jpipe"].video_scores[n]
        assert abs(g - w) <= 1e-5
        gated += w < runs["threshold"]
    assert 0 < gated < len(runs["names"])


def test_timestamps_and_placeholders_identical(runs):
    for (g, gsub), (w, wsub) in zip(runs["got"], runs["want"]):
        assert g.video_id == w.video_id
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        for a, b in zip(gsub, wsub):
            np.testing.assert_array_equal(a.timestamps, b.timestamps)
        if w.feature.shape[0] == 1 and w.timestamps.shape == (1, 2):  # a placeholder
            np.testing.assert_array_equal(g.feature, w.feature)


def test_features_match(runs):
    for (g, gsub), (w, wsub) in zip(runs["got"], runs["want"]):
        assert g.feature.shape == w.feature.shape
        np.testing.assert_allclose(g.feature, w.feature, atol=FEAT_TOL, rtol=0)
        for a, b in zip(gsub, wsub):
            np.testing.assert_allclose(a.feature, b.feature, atol=FEAT_TOL, rtol=0)


def test_fsd_split_multiplies_frames(runs):
    """A cut video's sub-features have a whole multiple of its frames."""
    for (g, gsub), (changed, crops) in zip(runs["got"], runs["got_fsd"]):
        assert len(gsub[0].feature) == len(crops)


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pq.QueryPipeline([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pq.DescriptorExtractor(vit.vit_tiny_test_descriptor(), 64)
