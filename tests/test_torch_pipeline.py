"""The ported slice end to end against the JAX pipeline, in the four-member
configuration of `bench.py --smoke`: a tiny ViT member + three tiny SwinV2
members (size 32, preset "vit") + tiny CLIP/VSM VED gate + FSD + the
JAX-fitted PCA + query score-norm (nk=1), on the bench's synthetic corpus,
f32 on the CPU."""

import sys
import threading

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
from vsc22_tpu.utils.observability import StageTimer as JaxStageTimer
from vsc22_tpu.retrieval.score_norm import query_score_normalize as jax_qsn
from vsc22_tpu_torch.models import clip, swinv2, vit, vsm
from vsc22_tpu_torch.ops.pca import PCAModel
from vsc22_tpu_torch.pipelines import batch_query as pbq
from vsc22_tpu_torch.retrieval.score_norm import query_score_normalize
from vsc22_tpu_torch.utils import jax_params
from vsc22_tpu_torch.utils.observability import StageTimer

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
        use_fsd=True, score_threshold=0.0, out_dim=8, timer=JaxStageTimer(),
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
        use_fsd=True, score_threshold=0.0, out_dim=8, timer=StageTimer(), device="cpu",
    )
    jphases, pphases = record_phases(jpipe), record_phases(ppipe)
    want = jpipe.process_many(names, videos, batch=4)
    got = ppipe.process_many(names, videos, batch=4)
    phases = dict(jax=list(jphases), port=list(pphases))
    stages = dict(jax=dict(jpipe.timer.counts), port=dict(ppipe.timer.counts))
    want_sn = jax_qsn(want, noise, video_scores=jpipe.video_scores, score_threshold=0.0,
                      beta=1.2, nk=1)
    got_sn = query_score_normalize(got, noise, video_scores=ppipe.video_scores,
                                   score_threshold=0.0, beta=1.2, nk=1, device="cpu")
    return dict(
        names=names, videos=videos, noise=noise, want=want, got=got, want_sn=want_sn,
        got_sn=got_sn,
        jpipe=jpipe, ppipe=ppipe, phases=phases, stages=stages,
        want_ctx=jpipe._prepare(names, videos), got_ctx=ppipe._prepare(names, videos),
    )


PHASES = ("_prepare_dispatch", "_prepare_finish", "_extract_dispatch_phase",
          "_extract_fetch", "_finalize")


def record_phases(pipe) -> list:
    """The calls of `pipe`'s phase methods from now on, as (name, thread
    id), each method wrapped on the instance."""
    calls = []

    def wrap(name, real):
        def call(*args, **kwargs):
            calls.append((name, threading.get_ident()))
            return real(*args, **kwargs)
        return call

    for name in PHASES:
        setattr(pipe, name, wrap(name, getattr(pipe, name)))
    return calls


def by_thread(calls) -> dict:
    """{"caller": [names...], "worker": [names...]}: the first call's
    thread is the caller's."""
    caller = calls[0][1]
    return {side: [n for n, t in calls if (t == caller) == (side == "caller")]
            for side in ("caller", "worker")}


def boxes_of(ctx) -> list:
    return [None if p is None else [tuple(int(c) for c in box) for _, box in p]
            for p in ctx["proc"]]


def test_names_and_timestamps_identical(runs):
    assert [f.video_id for f in runs["got"]] == runs["names"]
    for g, w in zip(runs["got"], runs["want"]):
        np.testing.assert_array_equal(g.timestamps, w.timestamps)


def test_fsd_boxes_and_frame_counts_identical(runs):
    """The port's `_prepare` context is JAX's: crop boxes per video, frame
    counts, the repeated timestamps, the edited videos; and the port's own
    key, exactly: the batch's number, which its spans carry."""
    want, got = runs["want_ctx"], runs["got_ctx"]
    assert set(got) == set(want) | {"batch"}
    assert got["names"] == want["names"] and got["edited_idx"] == want["edited_idx"]
    assert got["frame_counts"] == want["frame_counts"]
    assert boxes_of(got) == boxes_of(want)
    for g, w in zip(got["full_ts"], want["full_ts"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5, rtol=0)
    full = [(0, 128, 0, 128)]
    assert any(b != full for b in boxes_of(got))  # FSD cut the letterboxed video


def test_process_many_phase_order_is_jax(runs):
    """`process_many` calls its phases in the JAX pipeline's order: on the
    caller's thread dispatch, finish (batch 0), extraction dispatch, then
    per batch the next dispatch, this fetch, the next extraction dispatch,
    this finalize; the next batch's finish on the worker thread."""
    want, got = by_thread(runs["phases"]["jax"]), by_thread(runs["phases"]["port"])
    assert got == want
    assert want["worker"] == ["_prepare_finish"]  # 8 videos in batches of 4
    assert want["caller"][:3] == ["_prepare_dispatch", "_prepare_finish",
                                  "_extract_dispatch_phase"]


def test_stage_names_are_jax(runs):
    """The timer sees JAX's stage names with JAX's counts, except
    `x{size}_dispatch`: JAX runs the three SwinV2 members as one scanned
    program, so it counts that stage once per batch, and the port, whose
    members run in turn, once per member. The port's only stage of its
    own is `gate_wait`, once per batch the worker prepared."""
    want, got = runs["stages"]["jax"], runs["stages"]["port"]
    assert set(got) - set(want) == {"gate_wait"} and set(want) <= set(got)
    assert got["gate_wait"] == 1  # 8 videos in batches of 4
    got = {k: v for k, v in got.items() if k != "gate_wait"}
    members = {}
    for e in runs["ppipe"].extractors:
        members[f"x{e.size}_dispatch"] = members.get(f"x{e.size}_dispatch", 0) + 1
    for name, count in want.items():
        assert got[name] == count * members.get(name, 1), name
    assert {"ved_dispatch", "fsd_maps_dispatch", "ved", "fsd", "fsd_screen", "preprocess_64",
            "preprocess_32", "x64_dispatch", "x32_dispatch", "extract_fetch",
            "dedup_pca"} == set(got)


def test_process_many_equals_process_batch_loop(runs):
    """Overlapped batches give what the batches give one after another, bit
    for bit: three batches, the last ragged, one video gated out."""
    base = runs["ppipe"]
    scores = sorted(base.video_scores[n] for n in runs["names"])
    threshold = (scores[0] + scores[1]) / 2  # gates the lowest-scored video

    def build():
        return pbq.BatchedQueryPipeline(
            base.extractors, pca=base.pca, ved=base.ved, use_fsd=True,
            score_threshold=threshold, out_dim=8, device="cpu")

    names, videos = runs["names"], runs["videos"]
    many = build()
    got = many.process_many(names, videos, batch=3)
    loop = build()
    want = []
    for lo in range(0, len(names), 3):
        want += loop.process_batch(names[lo : lo + 3], videos[lo : lo + 3])
    assert sum(f.timestamps.shape == (1, 2) for f in want) == 1  # one placeholder
    assert [f.video_id for f in got] == [f.video_id for f in want] == names
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        np.testing.assert_array_equal(g.feature, w.feature)
    assert many.video_scores == loop.video_scores


def test_process_many_worker_error_reaches_caller():
    """An error in the half that runs on the worker thread reaches the
    caller of `process_many` (as `test_batch_query.py` checks in JAX)."""
    pipe = pbq.BatchedQueryPipeline(
        [pbq.BatchedExtractor(vit.vit_tiny_test_descriptor(), size=64)], ved=None,
        use_fsd=False, out_dim=8, device="cpu",
    )
    caller = threading.get_ident()
    raised_on = []
    real = pipe._prepare_finish

    def finish(disp):
        if threading.get_ident() != caller:
            raised_on.append(threading.get_ident())
            raise RuntimeError("worker half failed")
        return real(disp)

    pipe._prepare_finish = finish
    with pytest.raises(RuntimeError, match="worker half failed"):
        pipe.process_many(list("ABCD"), bench.synth_videos(4, 2, 64, 64), batch=1)
    assert len(raised_on) == 1


def test_weights_built_once_across_batches(monkeypatch):
    """The cubic crop-resize matrices are built and uploaded once per
    (in, out, start, stop), however many batches and streams use them."""
    built = []
    real = pbq.cubic_resize_weights

    def counting(*key):
        built.append(key)
        return real(*key)

    monkeypatch.setattr(pbq, "cubic_resize_weights", counting)
    pipe = pbq.BatchedQueryPipeline(
        [pbq.BatchedExtractor(vit.vit_tiny_test_descriptor(), size=64)], ved=None,
        use_fsd=True, out_dim=8, device="cpu",
    )
    calls = []
    lookup = pipe._weights
    pipe._weights = lambda *key: calls.append(key) or lookup(*key)
    pipe.process_many([f"Q{i}" for i in range(8)], bench.synth_videos(8, 6, 128, 128),
                      batch=3)
    assert len(built) == len(set(built)) == len(pipe._weight_cache) == len(set(calls))
    assert len(built) >= 2 and len(calls) >= 2 * 8  # a cut box beside the full frame


def test_stage_timer_counts_every_thread():
    """Stages timed on many threads at once all count (the pipeline's
    worker times its half beside the caller's)."""
    from vsc22_tpu_torch.utils.observability import StageTimer

    timer = StageTimer()
    threads_n, stages_n = 16, 500

    def work(k):
        for _ in range(stages_n):
            with timer.stage("shared"), timer.stage(f"own{k}"):
                pass

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert timer.counts["shared"] == threads_n * stages_n
    assert all(timer.counts[f"own{k}"] == stages_n for k in range(threads_n))
    assert len(timer.report().splitlines()) == threads_n + 1


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


def test_fsd_maps_setting_defaults_as_in_jax():
    import inspect

    from vsc22_tpu.pipelines import query_extract as jq
    from vsc22_tpu_torch.pipelines import query_extract as pq

    for j, p in ((jbq.BatchedQueryPipeline, pbq.BatchedQueryPipeline),
                 (jq.QueryPipeline, pq.QueryPipeline)):
        want = inspect.signature(j).parameters["use_device_fsd_maps"].default
        assert inspect.signature(p).parameters["use_device_fsd_maps"].default == want
    assert pbq.BatchedQueryPipeline([], device="cpu").use_device_fsd_maps is True


def test_exact_fsd_maps_setting_cuts_as_jax():
    """`use_device_fsd_maps=False`: every video cut on its exact maps, the
    port's boxes and frame counts those of the JAX pipeline (OpenCV's IPP
    route off around the JAX call), on the bench corpus and the
    letterboxed and stacked videos of `test_torch_cv2_numerics`."""
    import cv2

    from test_torch_cv2_numerics import make_video

    videos = bench.synth_videos(8, 6, 128, 128) + [
        np.stack(make_video(k, 30 + i)[:6]) for i, k in enumerate(
            ["letterbox", "letterbox_gray", "pillarbox", "vstack", "hstack", "grid2x2"])]
    names = [f"Q{i:06d}" for i in range(len(videos))]
    jpipe = jbq.BatchedQueryPipeline([], ved=None, use_fsd=True, use_device_fsd_maps=False)
    saved = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        ctx = jpipe._prepare(names, videos)
    finally:
        cv2.ipp.setUseIPP(saved)
    want = [[tuple(int(c) for c in box) for _, box in p] for p in ctx["proc"]]
    ppipe = pbq.BatchedQueryPipeline([], ved=None, use_fsd=True, use_device_fsd_maps=False,
                                     device="cpu")
    got = ppipe._prepare(names, videos)
    assert boxes_of(got) == want
    assert sum(len(b) > 1 for b in want) >= 3  # stacks were split
    assert sum(len(b) == 1 and b[0] != (0, v.shape[1], 0, v.shape[2])
               for b, v in zip(want, videos)) >= 2  # borders were removed


# --- spans and counters (`utils/observability`) -----------------------------------


@pytest.fixture(scope="module")
def traced(runs):
    """The fixture's 8 videos through `process_many` (batches of 4) and
    score-norm again, on a pipeline built from the fixture's parts with no
    timer (its weight matrices already on the device), under a CPU
    profiler that traces every thread: the recorder, the profiler's span
    events, and what the pipeline itself saw (each `_prepare_finish`
    context, each video cut on fetched maps)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from vsc22_tpu_torch.utils import observability as obs

    base = runs["ppipe"]
    pipe = pbq.BatchedQueryPipeline(base.extractors, pca=base.pca, ved=base.ved,
                                    use_fsd=True, score_threshold=0.0, out_dim=8, device="cpu")
    pipe._weight_cache.update(base._weight_cache)
    contexts, cut = [], []
    finish, real_cut = pipe._prepare_finish, pipe._cut

    def finish_seen(disp):
        ctx = finish(disp)
        contexts.append(ctx)
        return ctx

    pipe._prepare_finish = finish_seen
    pipe._cut = lambda boxes, i, frames, maps: cut.append(i) or real_cut(boxes, i, frames, maps)
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        feats = pipe.process_many(runs["names"], runs["videos"], batch=4)
        query_score_normalize(feats, runs["noise"], video_scores=pipe.video_scores,
                              score_threshold=0.0, beta=1.2, nk=1, device="cpu")
    rec = obs.recorded()
    obs.reset()
    span_events = [e for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(obs.SPAN_PREFIX)]
    return dict(rec=rec, events=span_events, contexts=contexts, cut=cut, feats=feats,
                main=threading.get_ident(), max_frames=base.ved.max_frames)


def kineto_event(traced, span):
    """The profiler's event of a recorded span: its name, starting within 1 ms."""
    (e,) = [e for e in traced["events"]
            if e.name() == "vsc22::span/" + span["name"]
            and abs(e.start_ns() - span["start_ns"]) < 1_000_000]
    return e


def test_worker_spans_land_on_the_workers_thread(traced):
    """Every stage of a batch carries its number. The second batch's `ved`,
    `fsd` and `fsd_screen` ran on the worker: recorded on its thread, and
    in the profiler's events on a thread of their own, not the caller's,
    where the first batch's ran and where `gate_wait` waited for them."""
    spans = traced["rec"]["spans"]
    batches = sorted({s["ids"]["batch"] for s in spans if "batch" in s["ids"]})
    assert len(batches) == 2
    first, second = batches
    main = traced["main"]
    (wait,) = [s for s in spans if s["name"] == "gate_wait"]
    assert wait["ids"] == {"batch": second} and wait["thread"] == main
    main_tid = kineto_event(traced, wait).start_thread_id()
    worker_tids = set()
    for name in ("ved", "fsd", "fsd_screen"):
        (a,) = [s for s in spans if s["name"] == name and s["ids"]["batch"] == first]
        (b,) = [s for s in spans if s["name"] == name and s["ids"]["batch"] == second]
        assert a["thread"] == main != b["thread"]
        assert kineto_event(traced, a).start_thread_id() == main_tid
        worker_tids.add(kineto_event(traced, b).start_thread_id())
    assert len(worker_tids) == 1 and main_tid not in worker_tids
    (fsd,) = [s for s in spans if s["name"] == "fsd" and s["ids"]["batch"] == second]
    (screen,) = [s for s in spans if s["name"] == "fsd_screen" and s["ids"]["batch"] == second]
    assert screen["parent"] == fsd["id"]
    for b in batches:
        names = {s["name"] for s in spans if s["ids"].get("batch") == b}
        assert {"ved_dispatch", "fsd_maps_dispatch", "ved", "fsd", "fsd_screen",
                "preprocess_64", "preprocess_32", "x64_dispatch", "x32_dispatch",
                "extract_fetch", "dedup_pca"} <= names


def test_score_norm_spans_nest(traced):
    """`score_norm` holds `score_norm.prepare` then `score_norm.bias`, and
    its self time is its duration less theirs."""
    spans = traced["rec"]["spans"]
    (outer,) = [s for s in spans if s["name"] == "score_norm"]
    inner = [s for s in spans if s["parent"] == outer["id"]]
    assert [s["name"] for s in inner] == ["score_norm.prepare", "score_norm.bias"]
    assert set(outer["ids"]) == {"call"}
    held = sum(s["end_ns"] - s["start_ns"] for s in inner)
    assert outer["self_ns"] == outer["end_ns"] - outer["start_ns"] - held >= 0
    for s in [outer] + inner:
        kineto_event(traced, s)


def test_counters_match_the_pipelines_own_account(traced, runs):
    """`h2d_bytes` is the frames, the VED's scatter indices, each shape
    group's sampled edge frames, the flagged videos' map indices and
    score-norm's two operands; `videos_gated_in` and `fsd_flagged` are what
    the pipeline's contexts and its cuts show."""
    from vsc22_tpu_torch.data.fsd import sample_edge_frames

    counters = traced["rec"]["counters"]
    gated_in = sum(len(ctx["edited_idx"]) for ctx in traced["contexts"])
    flagged = len(traced["cut"])
    assert counters["videos_gated_in"] == gated_in == len(runs["names"])
    assert counters["fsd_flagged"] == flagged >= 1
    frames = sum(np.asarray(v, np.uint8).nbytes for v in runs["videos"])
    ved_rows = 8 * sum(min(len(v), traced["max_frames"]) for v in runs["videos"])
    map_rows = 8 * 2 * flagged
    videos = runs["videos"]
    groups = [{v.shape for v in videos[lo : lo + 4]} for lo in range(0, len(videos), 4)]
    edge_rows = 8 * sum(len(sample_edge_frames(s[0])) for g in groups for s in g)
    width = runs["noise"][0].feature.shape[1] - 1  # the noise's low-variance dim deleted
    queries = 4 * width * sum(len(f.feature) for f in traced["feats"])
    noise = 4 * width * sum(len(f.feature) for f in runs["noise"])
    assert counters["h2d_bytes"] == (frames + ved_rows + edge_rows + map_rows + queries
                                     + noise)
