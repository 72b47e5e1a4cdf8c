"""Batched query descriptor pipeline.

Counterpart of `vsc22_tpu/pipelines/batch_query.py`, in eager PyTorch on
one device, with the JAX module's layout: every phase is split into a
dispatch half, which only queues device work and never makes the host
wait, and a fetch half, which pays one merged copy back. Per batch of
videos:

  1. `_prepare_dispatch`: the frames go up once (from pinned memory,
     unless the caller staged them), then the VED gate (CLIP CLS features
     of up to `max_frames` frames per video, shape-grouped preprocessing,
     cross-video chunks, scattered into one [V, max_frames, D] batch for
     the video-score model) and the FSD maps + level-0 profiles of every
     same-shape group are queued;
  2. `_prepare_finish`: one fetch of the probabilities and every profile
     pack; videos the profile screen cannot clear fetch their maps for
     the host cut logic. With `use_device_fsd_maps=False` every ungated
     video is cut on its exact maps (`fsd.variance_and_edges_host`)
     instead, unscreened. The device work runs outside the reference's
     keep-the-raw-box handlers, so a device error propagates;
  3. `_extract_dispatch_phase`: every (video, crop box) stream is cropped
     + resized on the device from the original frames (extractors sharing
     (size, preset, dtype) share that pass, the weight matrices cached on
     the device per key), and each extractor's cross-video chunks are
     queued; `_extract_fetch` brings every extractor's output back in one
     flat copy;
  4. `_finalize`: per-model L2, concat, near-duplicate removal, PCA on the
     host; videos under the score threshold get the reference's seeded
     placeholder vector.

`process_many` overlaps batches as the JAX pipeline does: batch i+1's
gating is queued before batch i's extraction fetch blocks, its fetch and
cut logic run on a worker thread, and batch i's dedup and PCA run after
batch i+1's extraction is queued. Everything runs on the caller's CUDA
stream, as JAX has one queue.

There is no `_ScannedEnsemble` (nor `ensemble_unroll`): JAX stacks the
same-architecture members into one compiled program to save dispatches,
and eager torch has no program to merge, so the members simply run in
turn. A CUDA-graph counterpart would be a performance change of its own.
"""

from __future__ import annotations

import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve, upload
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.data import fsd
from vsc22_tpu_torch.data.transforms import (
    clip_preprocess,
    crop_resize_normalize,
    cubic_resize_weights,
    resize_normalize,
)
from vsc22_tpu_torch.ops.pca import PCAModel
from vsc22_tpu_torch.pipelines.query_extract import (
    FRAME_THRESHOLD,
    LEN_THRESHOLD,
    MAX_CLIP_FRAMES,
    SCORE_THRESHOLD,
    _chunked,
    _l2,
    near_duplicate_keep_indices,
)
from vsc22_tpu_torch.utils.observability import NullTimer, count


@dataclasses.dataclass
class BatchedExtractor:
    """One ensemble member running cross-video chunks of `chunk` frames.
    `timer` (a `utils.observability.StageTimer`) is the pipeline's."""

    model: nn.Module
    size: int
    preset: str = "vit"
    chunk: int = LEN_THRESHOLD
    timer: object = None

    def __post_init__(self):
        if self.timer is None:
            self.timer = NullTimer()

    def preprocess(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] uint8 -> [N, S, S, 3] in the model's dtype, on the
        frames' device."""
        return resize_normalize(frames_u8, self.size, self.preset, out_dtype=self.model.dtype)

    @torch.inference_mode()
    def extract_dispatch(self, batches: Sequence[torch.Tensor], **ids) -> torch.Tensor:
        """Preprocessed per-stream tensors [n_i, S, S, 3] -> the device's
        [sum n_i, D] f32, with no host sync (the last chunk unpadded).
        `ids` go to the stage's span."""
        with self.timer.stage(f"x{self.size}_dispatch", **ids):
            flat = torch.cat(list(batches)) if len(batches) > 1 else batches[0]
            return _chunked(self.model, flat, self.chunk).float()

    def extract_concat(self, batches: Sequence[torch.Tensor]) -> np.ndarray:
        """`extract_dispatch` and one fetch: [sum n_i, D] f32 on the host."""
        dev_out = self.extract_dispatch(batches)
        with self.timer.stage(f"x{self.size}_fetch"):
            return dev_out.cpu().numpy()


@dataclasses.dataclass
class BatchedVED:
    """CLIP + video-score model over all videos of a batch at once."""

    clip_model: nn.Module
    vsm_model: nn.Module
    max_frames: int = MAX_CLIP_FRAMES
    chunk: int = LEN_THRESHOLD

    @torch.inference_mode()
    def scores_async(self, per_video_u8: Sequence[torch.Tensor]) -> torch.Tensor:
        """The device's [V] edit probabilities, with no host sync. The CLS
        features never leave the device: they scatter into the VSM's
        [V, max_frames, D] input at indices built on the host (the frame
        counts are host shapes) and uploaded from pinned memory."""
        size = self.clip_model.cfg.img_size
        by_shape: Dict[Tuple, List[int]] = {}
        for i, v in enumerate(per_video_u8):
            by_shape.setdefault(tuple(v.shape), []).append(i)
        pre: List[Optional[torch.Tensor]] = [None] * len(per_video_u8)
        for shape, idxs in by_shape.items():
            n = min(int(shape[0]), self.max_frames)
            stack = torch.stack([per_video_u8[i][: self.max_frames] for i in idxs])
            flat = clip_preprocess(
                stack.reshape((-1,) + tuple(stack.shape[2:])), size,
                out_dtype=self.clip_model.dtype,
            )
            blocks = flat.reshape((len(idxs), n) + tuple(flat.shape[1:]))
            for j, i in enumerate(idxs):
                pre[i] = blocks[j]
        counts = [int(p.shape[0]) for p in pre]
        feats = _chunked(lambda im: self.clip_model(im)[:, 0], torch.cat(pre), self.chunk)
        vid_idx = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        frame_idx = np.concatenate([np.arange(c, dtype=np.int64) for c in counts])
        rows = upload(vid_idx * self.max_frames + frame_idx, feats.device)
        full = torch.zeros(
            (len(counts) * self.max_frames, feats.shape[1]), dtype=torch.float32,
            device=feats.device,
        )
        full.index_copy_(0, rows, feats.float())
        full = full.reshape(len(counts), self.max_frames, -1)
        return torch.sigmoid(self.vsm_model(full)).reshape(-1)

    def scores(self, per_video_u8: Sequence[torch.Tensor]) -> List[float]:
        """Per-video edit probabilities on the host (one fetch)."""
        return self.scores_async(per_video_u8).cpu().tolist()


class BatchedQueryPipeline:
    """Multi-video batched orchestration of the query descriptor path, on
    `device`: the card unless the caller says otherwise. `timer`, a
    `utils.observability.StageTimer`, receives the JAX pipeline's stage
    names (`ved_dispatch`, `fsd_maps_dispatch`, `ved`, `fsd`, `fsd_screen`,
    `preprocess_{size}`, `x{size}_dispatch`, `extract_fetch`, `dedup_pca`)
    and the port's `gate_wait` (`process_many` waiting on the worker's
    half); it is handed to every extractor. Without one, the stages are
    bare `utils.observability.span`s. Each batch is numbered, and every
    stage of a batch carries `batch=<number>`, on either thread.

    Counters (`utils.observability.count`, while a profiler or
    `recording()` records): `h2d_bytes` in `core.device.upload`,
    `videos_gated_in` (videos at or over the score threshold) and
    `fsd_flagged` (videos whose maps are fetched and cut: those the
    profile screen could not clear, or, unscreened, every one cut on its
    exact maps) in `_fsd_boxes`."""

    def __init__(
        self,
        extractors: Sequence[BatchedExtractor],
        pca: Optional[PCAModel] = None,
        ved: Optional[BatchedVED] = None,
        use_fsd: bool = True,
        use_device_fsd_maps: bool = True,
        score_threshold: float = SCORE_THRESHOLD,
        frame_threshold: float = FRAME_THRESHOLD,
        out_dim: int = 512,
        timer=None,
        device="cuda",
    ):
        self.extractors = list(extractors)
        self.pca = pca
        self.ved = ved
        self.use_fsd = use_fsd
        self.use_device_fsd_maps = use_device_fsd_maps
        self.score_threshold = score_threshold
        self.frame_threshold = frame_threshold
        self.out_dim = out_dim
        self.device = resolve(device)
        self.rnd_idx = 0
        self.video_scores: Dict[str, float] = {}
        self.timer = NullTimer() if timer is None else timer
        for ext in self.extractors:
            ext.timer = self.timer
        self._weight_cache: Dict[Tuple[int, int, int, int], torch.Tensor] = {}
        self._batch_ids = itertools.count()

    def _weights(self, in_size: int, out_size: int, start: int, stop: int) -> torch.Tensor:
        """The device's cubic crop-resize matrix, built and uploaded once per key."""
        key = (in_size, out_size, start, stop)
        w = self._weight_cache.get(key)
        if w is None:
            w = upload(cubic_resize_weights(in_size, out_size, start, stop), self.device)
            self._weight_cache[key] = w
        return w

    def process_batch(
        self,
        names: Sequence[str],
        videos_u8: Sequence[np.ndarray],  # per video [N_i, H_i, W_i, 3] uint8
        timestamps: Optional[Sequence[Sequence[float]]] = None,
        device_videos: Optional[Sequence[torch.Tensor]] = None,
    ) -> List[VideoFeature]:
        """One fused VideoFeature per video. `device_videos` may carry the
        frames already on `device` as uint8 tensors."""
        return self._extract_finish(self._prepare(names, videos_u8, timestamps, device_videos))

    def process_many(
        self,
        names: Sequence[str],
        videos_u8: Sequence[np.ndarray],
        batch: int = 8,
        device_videos: Optional[Sequence[torch.Tensor]] = None,
    ) -> List[VideoFeature]:
        """`process_batch` over consecutive batches of `batch` videos, with
        the batches overlapped so that the device queue never drains:

          - batch i+1's gating (VED, FSD maps) is queued on this thread
            before batch i's extraction fetch blocks;
          - its gating fetch and host cut decisions run on a worker thread
            while this one waits on batch i's extraction;
          - batch i's dedup and PCA run only after batch i+1's extraction
            is queued.

        The worker runs on this thread's device and CUDA stream, so its
        device work stays ordered with the launches made here. An error
        on either thread reaches the caller."""
        spans = [(lo, min(lo + batch, len(names))) for lo in range(0, len(names), batch)]
        if not spans:
            return []
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

        def dispatch(span):
            lo, hi = span
            return self._prepare_dispatch(
                names[lo:hi], videos_u8[lo:hi], None,
                device_videos[lo:hi] if device_videos is not None else None,
            )

        def finish_on_worker(disp):
            if stream is None:
                return self._prepare_finish(disp)
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                return self._prepare_finish(disp)

        out: List[VideoFeature] = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            ctx = self._prepare_finish(dispatch(spans[0]))
            pending = self._extract_dispatch_phase(ctx)
            for i in range(len(spans)):
                fut = None
                if i + 1 < len(spans):
                    disp = dispatch(spans[i + 1])
                    fut = pool.submit(finish_on_worker, disp)
                fetched = self._extract_fetch(pending, batch=ctx["batch"])
                next_ctx = next_pending = None
                if fut is not None:
                    with self.timer.stage("gate_wait", batch=disp["batch"]):
                        next_ctx = fut.result()
                    next_pending = self._extract_dispatch_phase(next_ctx)
                out.extend(self._finalize(ctx, pending, fetched))
                ctx, pending = next_ctx, next_pending
        return out

    def _prepare(self, names, videos_u8, timestamps=None, device_videos=None):
        return self._prepare_finish(
            self._prepare_dispatch(names, videos_u8, timestamps, device_videos)
        )

    @torch.inference_mode()
    def _prepare_dispatch(self, names, videos_u8, timestamps=None, device_videos=None):
        """Device half of a batch's preparation, with no host sync: the
        frames go up (unless staged) and the VED chain and every shape
        group's FSD maps are queued. FSD maps are queued for every video;
        the gate applies once the probabilities are back. The pinned
        buffers of the upload stay in the context until the gating fetch."""
        if timestamps is None:
            timestamps = [list(range(len(v))) for v in videos_u8]
        batch = next(self._batch_ids)
        pinned: List[torch.Tensor] = []
        if device_videos is None:
            device_videos = [upload(np.asarray(v, np.uint8), self.device, pinned)
                             for v in videos_u8]

        probs_dev = None
        with self.timer.stage("ved_dispatch", batch=batch):
            if self.ved is not None:
                probs_dev = self.ved.scores_async(device_videos)
        handles = []
        if self.use_fsd and self.use_device_fsd_maps:
            by_shape: Dict[Tuple, List[int]] = {}
            for i, vid in enumerate(device_videos):
                by_shape.setdefault(tuple(vid.shape), []).append(i)
            with self.timer.stage("fsd_maps_dispatch", batch=batch):
                for shape, idxs in by_shape.items():
                    stack = torch.stack([device_videos[i] for i in idxs])
                    maps16, pack, dims = fsd.batch_maps_profiles_dispatch(stack)
                    handles.append((shape, idxs, maps16, pack, dims))
        return dict(names=names, videos_u8=videos_u8, timestamps=timestamps,
                    device_videos=device_videos, probs_dev=probs_dev, handles=handles,
                    pinned=pinned, batch=batch)

    @torch.inference_mode()
    def _prepare_finish(self, disp):
        """Host half: one fetch of the probabilities and every profile
        pack, the profile screen, the flagged videos' maps, the cut logic."""
        names = disp["names"]
        videos_u8 = disp["videos_u8"]
        device_videos = disp["device_videos"]
        probs_dev = disp["probs_dev"]
        handles = disp["handles"]
        batch = disp["batch"]

        packs: List[np.ndarray] = []
        with self.timer.stage("ved", batch=batch):
            parts = [] if probs_dev is None else [probs_dev.float()]
            parts += [pack.reshape(-1) for _, _, _, pack, _ in handles]
            flat = torch.cat(parts).cpu().numpy() if parts else None
            disp["pinned"].clear()  # the copies queued before this fetch are done
            cursor = 0
            if probs_dev is not None:
                scores = [float(p) for p in flat[: len(device_videos)]]
                cursor = len(device_videos)
            else:
                scores = [1.0] * len(device_videos)
            for _, _, _, pack, _ in handles:
                packs.append(flat[cursor : cursor + pack.numel()].reshape(tuple(pack.shape)))
                cursor += pack.numel()
        for name, s in zip(names, scores):
            self.video_scores[name] = s

        with self.timer.stage("fsd", batch=batch):
            boxes = self._fsd_boxes(videos_u8, device_videos, scores, handles, packs, batch)
        proc: List[Optional[List[Tuple[int, fsd.Box]]]] = []
        frame_counts: List[int] = []
        full_ts: List[np.ndarray] = []
        edited_idx: List[int] = []
        for i, ts in enumerate(disp["timestamps"]):
            if boxes[i] is None:
                proc.append(None)
                frame_counts.append(0)
                full_ts.append(np.zeros((0,)))
                continue
            edited_idx.append(i)
            proc.append([(i, box) for box in boxes[i]])
            frame_counts.append(int(device_videos[i].shape[0]) * len(boxes[i]))
            full_ts.append(np.array(list(ts) * len(boxes[i])))
        return dict(names=names, scores=scores, proc=proc, frame_counts=frame_counts,
                    full_ts=full_ts, edited_idx=edited_idx, device_videos=device_videos,
                    batch=batch)

    def _fsd_boxes(self, videos_u8, device_videos, scores, handles, packs, batch):
        """Crop boxes per video; None for a video under the score threshold."""
        boxes: List[Optional[List[fsd.Box]]] = []
        for i, vid in enumerate(device_videos):
            gated = scores[i] < self.score_threshold
            boxes.append(None if gated else [(0, int(vid.shape[1]), 0, int(vid.shape[2]))])
        gated_in = [i for i, b in enumerate(boxes) if b is not None]
        count("videos_gated_in", len(gated_in))
        if not self.use_fsd:
            return boxes
        if not self.use_device_fsd_maps:
            # The exact maps of every ungated video (`batch_query.py:556-566`
            # of the JAX package with use_device_maps=False): no screen.
            count("fsd_flagged", len(gated_in))
            for i in gated_in:
                self._cut(boxes, i, videos_u8[i],
                          fsd.variance_and_edges_host(device_videos[i], self.device))
            return boxes
        batch_maps: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if handles:
            with self.timer.stage("fsd_screen", batch=batch):
                for (shape, idxs, maps16, _, dims), pack in zip(handles, packs):
                    n_f, h, w = shape[0], shape[1], shape[2]
                    profs = fsd.unpack_profiles(pack, *dims)
                    flagged: List[int] = []
                    for j, i in enumerate(idxs):
                        if boxes[i] is None:
                            continue
                        try:
                            boxes0 = fsd.level0_boxes_from_profiles(profs[j], h, w, n_f)
                        except Exception:
                            boxes0 = None
                        if boxes0 is None:  # the screen only ever clears "no edit"
                            flagged.append(j)
                    count("fsd_flagged", len(flagged))
                    if not flagged:
                        continue
                    sel = upload(np.array(flagged + [len(idxs) + j for j in flagged]),
                                 maps16.device)
                    fetched = maps16.index_select(0, sel).float().cpu().numpy()
                    k = len(flagged)
                    for t, j in enumerate(flagged):
                        batch_maps[idxs[j]] = (fetched[t], fetched[k + t])
        for i, maps in batch_maps.items():
            self._cut(boxes, i, videos_u8[i], maps)
        return boxes

    @staticmethod
    def _cut(boxes, i: int, frames, maps) -> None:
        """boxes[i] = the FSD crops of video i from its `maps`, where it was cut."""
        try:
            changed, fsd_boxes = fsd.image_process_boxes(frames, maps)
            if changed:
                boxes[i] = fsd_boxes
        except Exception:
            pass  # reference robustness contract: keep the raw frame

    def _extract_finish(self, ctx) -> List[VideoFeature]:
        pending = self._extract_dispatch_phase(ctx)
        return self._finalize(ctx, pending, self._extract_fetch(pending, batch=ctx["batch"]))

    @torch.inference_mode()
    def _extract_dispatch_phase(self, ctx):
        """Queue every extractor's crop-resize and chunks, with no host
        sync: [(extractor, device [frames, D] f32), ...]. Each stream is
        (video, crop box), cropped and resized on the device from the
        original frames; extractors sharing (size, preset, dtype) share
        that pass."""
        device_videos = ctx["device_videos"]
        batch = ctx["batch"]
        streams = [s for i in ctx["edited_idx"] for s in ctx["proc"][i]]
        pending = []
        if not streams:
            return pending
        pre_cache: Dict[Tuple, List[torch.Tensor]] = {}
        for ext in self.extractors:
            key = (ext.size, ext.preset, ext.model.dtype)
            if key not in pre_cache:
                with self.timer.stage(f"preprocess_{ext.size}", batch=batch):
                    pre_cache[key] = [
                        crop_resize_normalize(
                            device_videos[i],
                            self._weights(int(device_videos[i].shape[1]), ext.size,
                                          box[0], box[1]),
                            self._weights(int(device_videos[i].shape[2]), ext.size,
                                          box[2], box[3]),
                            preset=ext.preset,
                            out_dtype=ext.model.dtype,
                        )
                        for i, box in streams
                    ]
            pending.append((ext, ext.extract_dispatch(pre_cache[key], batch=batch)))
        return pending

    @torch.inference_mode()
    def _extract_fetch(self, pending, batch=None) -> Optional[np.ndarray]:
        """Every extractor's output in one flat concat and one fetch (the
        members' widths may differ; `_finalize` slices them back out)."""
        if not pending:
            return None
        with self.timer.stage("extract_fetch", batch=batch):
            return torch.cat([dev_out.reshape(-1) for _, dev_out in pending]).cpu().numpy()

    def _finalize(self, ctx, pending, fetched_flat) -> List[VideoFeature]:
        """Per-model L2, near-duplicate removal and PCA per video, and the
        reference's seeded placeholders for gated videos, in video order."""
        if pending:
            per_model = []
            cursor = 0
            for _, dev_out in pending:
                block = fetched_flat[cursor : cursor + dev_out.numel()]
                per_model.append(_l2(block.reshape(-1, dev_out.shape[-1])))
                cursor += dev_out.numel()
            concat = np.concatenate(per_model, axis=1)
        else:
            concat = np.zeros((0, self.out_dim * len(self.extractors)), np.float32)

        out: List[VideoFeature] = []
        cursor = 0
        with self.timer.stage("dedup_pca", batch=ctx["batch"]):
            for i, name in enumerate(ctx["names"]):
                if ctx["proc"][i] is None:
                    self.rnd_idx += 1
                    rng = np.random.RandomState(self.rnd_idx)
                    vec = rng.uniform(-1e-5, 1e-5, size=self.out_dim).astype(np.float32)
                    out.append(
                        VideoFeature(
                            video_id=name, timestamps=np.array([0, 1])[None, ...],
                            feature=vec[None, ...],
                        )
                    )
                    continue
                n = ctx["frame_counts"][i]
                feats = concat[cursor : cursor + n]
                cursor += n
                keep = near_duplicate_keep_indices(feats, self.frame_threshold)
                kept = feats[keep]
                if self.pca is not None:
                    kept = self.pca.transform(kept).astype(np.float32)
                out.append(VideoFeature(video_id=name, timestamps=ctx["full_ts"][i][keep],
                                        feature=kept))
        return out
