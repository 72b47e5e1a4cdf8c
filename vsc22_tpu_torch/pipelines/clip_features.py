"""CLIP frame-feature extraction for video-score (VED) training.

Counterpart of `vsc22_tpu/pipelines/clip_features.py` (reference contract
D1/train/train_vid_score/video/extract_feat.py:75-146): CLIP ViT-L/14 CLS
features of up to 256 frames per video, in `chunk`-frame batches on one
device (the card unless the caller names another), written as a zip of
one float16 `.npy` per video: byte-compatible with the JAX package's and
the reference's feats.zip.
"""

from __future__ import annotations

import io
import logging
import zipfile
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.data.transforms import clip_preprocess_frames
from vsc22_tpu_torch.pipelines.query_extract import _chunked, frames_to_device
from vsc22_tpu_torch.pipelines.ref_extract import shard_videos
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator

logger = logging.getLogger("clip_features")

MAX_FRAMES = 256


class ClipFeatureExtractor:
    """CLIP visual CLS features of a video's first MAX_FRAMES frames."""

    def __init__(self, clip_model: nn.Module, chunk: int = 32, device="cuda"):
        self.model = clip_model
        self.chunk = chunk
        self.device = resolve(device)

    @torch.inference_mode()
    def extract(self, frames: Sequence) -> np.ndarray:
        size = self.model.cfg.img_size
        stack = torch.stack(frames_to_device(frames[:MAX_FRAMES], self.device))
        images = clip_preprocess_frames(stack, size)
        return _chunked(lambda im: self.model(im)[:, 0], images, self.chunk).float().cpu().numpy()


def write_feats_zip(path: str, features: Dict[str, np.ndarray]) -> None:
    """One float16 .npy per video inside a zip (the reference feats.zip layout)."""
    with zipfile.ZipFile(path, "w") as zf:
        for vid, feats in features.items():
            buf = io.BytesIO()
            np.save(buf, feats.astype(np.float16))
            zf.writestr(f"{vid}.npy", buf.getvalue())


def read_feats_zip(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with zipfile.ZipFile(path, "r") as zf:
        for name in zf.namelist():
            vid = name.rsplit(".", 1)[0]
            out[vid] = np.load(io.BytesIO(zf.read(name))).astype(np.float32)
    return out


def extract_clip_features(
    videos: Iterable[Tuple[str, Sequence]],
    extractor: ClipFeatureExtractor,
    out_path: str,
    process_index: int = 0,
    process_count: int = 1,
) -> str:
    """Shard the videos across processes, extract, and write `out_path`
    (single-process runs) or `<out_path>.shard{K}`. The offline flow's
    entry point, so it tunes the host allocator first, as the CLIs'
    `main()` do."""
    tune_host_allocator()
    videos = list(videos)
    mine = set(shard_videos([v for v, _ in videos], process_index, process_count))
    features = {}
    for vid, frames in videos:
        if vid not in mine or not len(frames):
            continue
        features[vid] = extractor.extract(frames)
    path = out_path if process_count == 1 else f"{out_path}.shard{process_index}"
    write_feats_zip(path, features)
    return path
