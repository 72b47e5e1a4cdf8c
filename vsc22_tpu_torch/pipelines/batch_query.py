"""Batched query descriptor pipeline.

Counterpart of `vsc22_tpu/pipelines/batch_query.py`, in eager PyTorch on
one device. Per batch of videos:

  1. the VED gate: CLIP CLS features of up to `max_frames` frames per video
     (shape-grouped preprocessing, cross-video chunks), scattered into one
     [V, max_frames, D] batch for the video-score model -> sigmoid;
  2. FSD: device maps + level-0 profiles per same-shape group; videos the
     profile screen cannot clear fetch their maps for the host cut logic.
     With `use_device_fsd_maps=False` every ungated video is cut on its
     exact maps (`fsd.variance_and_edges_host`) instead, unscreened. The
     device work runs outside the keep-the-raw-box fallback handlers,
     so a device error propagates;
  3. every (video, crop box) stream is cropped + resized on the device from
     the original frames; extractors sharing (size, preset, dtype) share
     that pass; each extractor runs cross-video fixed-size chunks;
  4. per-model L2, concat, near-duplicate removal, PCA on the host;
     videos under the score threshold get the reference's seeded
     placeholder vector.

Eager torch needs no stacked-ensemble program (`_ScannedEnsemble`): the
extractors simply run in turn.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.data import fsd
from vsc22_tpu_torch.data.transforms import (
    clip_preprocess,
    crop_resize_normalize,
    cubic_resize_weights,
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


@dataclasses.dataclass
class BatchedExtractor:
    """One ensemble member running cross-video chunks of `chunk` frames."""

    model: nn.Module
    size: int
    preset: str = "vit"
    chunk: int = LEN_THRESHOLD

    def extract(self, batches: Sequence[torch.Tensor]) -> torch.Tensor:
        """Preprocessed per-stream tensors [n_i, S, S, 3] -> [sum n_i, D] f32."""
        flat = torch.cat(list(batches)) if len(batches) > 1 else batches[0]
        return _chunked(self.model, flat, self.chunk).float()


@dataclasses.dataclass
class BatchedVED:
    """CLIP + video-score model over all videos of a batch at once."""

    clip_model: nn.Module
    vsm_model: nn.Module
    max_frames: int = MAX_CLIP_FRAMES
    chunk: int = LEN_THRESHOLD

    def scores(self, per_video_u8: Sequence[torch.Tensor]) -> List[float]:
        """Per-video edit probabilities."""
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
        device = feats.device
        vid_idx = torch.repeat_interleave(
            torch.arange(len(counts), device=device), torch.tensor(counts, device=device)
        )
        frame_idx = torch.cat([torch.arange(c, device=device) for c in counts])
        full = torch.zeros(
            (len(counts), self.max_frames, feats.shape[1]), dtype=torch.float32, device=device
        )
        full[vid_idx, frame_idx] = feats.float()
        return torch.sigmoid(self.vsm_model(full)).cpu().tolist()


class BatchedQueryPipeline:
    """Multi-video batched orchestration of the query descriptor path, on
    `device`: the card unless the caller says otherwise."""

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

    def process_many(
        self,
        names: Sequence[str],
        videos_u8: Sequence[np.ndarray],
        batch: int = 8,
        device_videos: Optional[Sequence[torch.Tensor]] = None,
    ) -> List[VideoFeature]:
        """`process_batch` over consecutive batches of `batch` videos."""
        out: List[VideoFeature] = []
        for lo in range(0, len(names), batch):
            hi = min(lo + batch, len(names))
            out.extend(
                self.process_batch(
                    names[lo:hi], videos_u8[lo:hi],
                    device_videos=None if device_videos is None else device_videos[lo:hi],
                )
            )
        return out

    @torch.inference_mode()
    def process_batch(
        self,
        names: Sequence[str],
        videos_u8: Sequence[np.ndarray],  # per video [N_i, H_i, W_i, 3] uint8
        timestamps: Optional[Sequence[Sequence[float]]] = None,
        device_videos: Optional[Sequence[torch.Tensor]] = None,
    ) -> List[VideoFeature]:
        """One fused VideoFeature per video. `device_videos` may carry the
        frames already on `device` as uint8 tensors."""
        if timestamps is None:
            timestamps = [list(range(len(v))) for v in videos_u8]
        if device_videos is None:
            device_videos = [
                torch.from_numpy(np.asarray(v, np.uint8)).to(self.device) for v in videos_u8
            ]
        scores = (
            self.ved.scores(device_videos) if self.ved is not None
            else [1.0] * len(device_videos)
        )
        for name, s in zip(names, scores):
            self.video_scores[name] = s
        boxes = self._fsd_boxes(videos_u8, device_videos, scores)

        streams = [
            (i, box) for i in range(len(names)) if boxes[i] is not None for box in boxes[i]
        ]
        concat = self._extract(device_videos, streams)

        out: List[VideoFeature] = []
        cursor = 0
        for i, name in enumerate(names):
            if boxes[i] is None:
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
            n = int(device_videos[i].shape[0]) * len(boxes[i])
            feats = concat[cursor : cursor + n]
            cursor += n
            full_ts = np.array(list(timestamps[i]) * len(boxes[i]))
            keep = near_duplicate_keep_indices(feats, self.frame_threshold)
            kept = feats[keep]
            if self.pca is not None:
                kept = self.pca.transform(kept).astype(np.float32)
            out.append(VideoFeature(video_id=name, timestamps=full_ts[keep], feature=kept))
        return out

    def _fsd_boxes(self, videos_u8, device_videos, scores) -> List[Optional[List[fsd.Box]]]:
        """Crop boxes per video; None for a video under the score threshold."""
        boxes: List[Optional[List[fsd.Box]]] = []
        for i, vid in enumerate(device_videos):
            gated = scores[i] < self.score_threshold
            boxes.append(None if gated else [(0, int(vid.shape[1]), 0, int(vid.shape[2]))])
        if not self.use_fsd:
            return boxes
        if not self.use_device_fsd_maps:
            # The exact maps of every ungated video (`batch_query.py:556-566`
            # of the JAX package with use_device_maps=False): no screen.
            for i, vid in enumerate(device_videos):
                if boxes[i] is not None:
                    self._cut(boxes, i, videos_u8[i],
                              fsd.variance_and_edges_host(vid, self.device))
            return boxes
        by_shape: Dict[Tuple, List[int]] = {}
        for i, vid in enumerate(device_videos):
            by_shape.setdefault(tuple(vid.shape), []).append(i)
        for shape, idxs in by_shape.items():
            n_f, h, w = shape[0], shape[1], shape[2]
            maps16, pack = fsd.batch_maps_profiles(torch.stack([device_videos[i] for i in idxs]))
            profs = fsd.unpack_profiles(pack.cpu().numpy(), len(idxs), h, w)
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
            if not flagged:
                continue
            sel = torch.tensor(flagged + [len(idxs) + j for j in flagged], device=maps16.device)
            fetched = maps16.index_select(0, sel).float().cpu().numpy()
            k = len(flagged)
            for t, j in enumerate(flagged):
                self._cut(boxes, idxs[j], videos_u8[idxs[j]], (fetched[t], fetched[k + t]))
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

    def _weights(self, in_size: int, out_size: int, start: int, stop: int) -> torch.Tensor:
        return torch.from_numpy(cubic_resize_weights(in_size, out_size, start, stop)).to(
            self.device
        )

    def _extract(self, device_videos, streams) -> np.ndarray:
        """Per-model L2-normalized descriptors of every stream, concatenated
        across models: [sum of stream frames, sum of model dims] f32."""
        if not streams:
            return np.zeros((0, self.out_dim * len(self.extractors)), np.float32)
        pre_cache: Dict[Tuple, List[torch.Tensor]] = {}
        per_model = []
        for ext in self.extractors:
            key = (ext.size, ext.preset, ext.model.dtype)
            if key not in pre_cache:
                pre_cache[key] = [
                    crop_resize_normalize(
                        device_videos[i],
                        self._weights(int(device_videos[i].shape[1]), ext.size, box[0], box[1]),
                        self._weights(int(device_videos[i].shape[2]), ext.size, box[2], box[3]),
                        preset=ext.preset,
                        out_dtype=ext.model.dtype,
                    )
                    for i, box in streams
                ]
            per_model.append(_l2(ext.extract(pre_cache[key]).cpu().numpy()))
        return np.concatenate(per_model, axis=1)
