"""The per-video query pipeline (decode -> VED gate -> FSD -> ensemble ->
dedup -> PCA), its constants, near-duplicate frame removal and the noise
corpus's minimum-variance dimension.

Counterpart of `vsc22_tpu/pipelines/query_extract.py` (reference contract
D1/infer/extract_query_feats.py:54-244). One video at a time, on one
device (the card unless the caller names another): the frames go to the
device once; the VED gate, the FSD maps (`fsd.image_process`: the exact
maps, or the 8-round device maps with `use_device_fsd_maps`) and
each member's resize (`transforms.resize_normalize_frames`, OpenCV's cubic
arithmetic) run there. Each member runs LEN_THRESHOLD-frame chunks; the
last chunk runs unpadded (the JAX version zero-pads it to a fixed shape for
its compiler; each frame's output is the same either way). With a `mesh`
(`parallel/mesh.Mesh`) a `DescriptorExtractor` shards each chunk's frames
over the data axis.
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
from vsc22_tpu_torch.data.transforms import clip_preprocess_frames, resize_normalize_frames
from vsc22_tpu_torch.ops.pca import PCAModel
from vsc22_tpu_torch.retrieval.score_norm import _min_variance_dim

SCORE_THRESHOLD = 0.001
LEN_THRESHOLD = 48
FRAME_THRESHOLD = 0.975
MAX_CLIP_FRAMES = 256
NK = 1
BETA = 1.2


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _chunked(model: nn.Module, flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """model over `flat` in chunks of `chunk` rows (outputs are per row)."""
    return torch.cat([model(flat[s : s + chunk]) for s in range(0, flat.shape[0], chunk)])


def near_duplicate_keep_indices(
    features: np.ndarray, threshold: float = FRAME_THRESHOLD
) -> List[int]:
    """Greedy near-duplicate frame removal: anchors in descending
    mean-similarity order drop every frame more similar than `threshold`."""
    feat = _l2(features)
    sim = feat @ feat.T - np.eye(len(feat))
    sim_mean = sim.mean(0)
    removed = np.zeros(len(feat), bool)
    for i in sim_mean.argsort()[::-1]:
        if removed[i]:
            continue
        removed |= sim[i] > threshold
    return [int(i) for i in np.flatnonzero(~removed)]


def calculate_low_var_dim(score_norm_refs: List[VideoFeature]) -> int:
    """Minimum-variance dimension of the noise corpus (shared query/ref):
    the dimension score-norm deletes."""
    return _min_variance_dim(score_norm_refs)


def _shape_runs(frames: Sequence) -> List[Tuple[int, int]]:
    """[start, stop) runs of consecutive frames of one shape."""
    runs, start = [], 0
    for i in range(1, len(frames) + 1):
        if i == len(frames) or tuple(frames[i].shape) != tuple(frames[start].shape):
            runs.append((start, i))
            start = i
    return runs


def frames_to_device(frames: Sequence, device) -> List[torch.Tensor]:
    """Frames (numpy or tensors, [H, W, 3] uint8) as tensors on `device`,
    moved one shape-run at a time."""
    out: List[torch.Tensor] = []
    for lo, hi in _shape_runs(frames):
        run = frames[lo:hi]
        if isinstance(run[0], torch.Tensor):
            stack = torch.stack(list(run))
        else:
            stack = torch.from_numpy(np.stack([np.asarray(f) for f in run]))
        out.extend(stack.to(device).unbind(0))
    return out


@dataclasses.dataclass
class DescriptorExtractor:
    """One ensemble member: a model on `device` + its input size and preset.

    With a `mesh`, the frame axis of each chunk is sharded over the mesh's
    ``data`` axis (the JAX extractor's sequence parallelism): the chunk is
    rounded up to a multiple of the axis, each rank runs its contiguous
    slice of the chunk's frames (the last chunk zero-padded to a multiple
    of the axis where it must be) and the features are all-gathered in
    frame order, so every rank, given the same frames, returns the whole
    [n, D]."""

    model: nn.Module
    size: int
    preset: str = "vit"
    chunk: int = LEN_THRESHOLD
    device: object = "cuda"
    mesh: object = None

    def __post_init__(self):
        self.device = resolve(self.device)
        if self.mesh is not None:
            dp = self.mesh.shape["data"]
            self.chunk = -(-self.chunk // dp) * dp

    @torch.inference_mode()
    def extract(self, frames: Sequence) -> np.ndarray:
        """[H_i, W_i, 3] uint8 frames (numpy or tensors; shapes may vary
        between runs of frames, as FSD crops do) -> [n, D] f32."""
        frames = frames_to_device(frames, self.device)
        resized = torch.cat([
            resize_normalize_frames(torch.stack(frames[lo:hi]), self.size, self.preset)
            for lo, hi in _shape_runs(frames)
        ])
        if self.mesh is None:
            return _chunked(self.model, resized, self.chunk).float().cpu().numpy()
        return torch.cat([self._sharded_chunk(resized[s : s + self.chunk])
                          for s in range(0, resized.shape[0], self.chunk)]).float().cpu().numpy()

    def _sharded_chunk(self, images: torch.Tensor) -> torch.Tensor:
        """The member over one chunk, each rank on its slice of the frames."""
        dp, at = self.mesh.shape["data"], self.mesh.index("data")
        n = images.shape[0]
        per = -(-n // dp)
        if per * dp > n:
            images = torch.cat([images, images.new_zeros((per * dp - n,) + images.shape[1:])])
        mine = self.model(images[at * per : (at + 1) * per])
        return torch.cat(self.mesh.all_gather(mine, "data"))[:n]


@dataclasses.dataclass
class VideoEditDetector:
    """VED scorer: CLIP visual CLS features -> video-score model -> sigmoid."""

    clip_model: nn.Module
    vsm_model: nn.Module
    max_frames: int = MAX_CLIP_FRAMES
    chunk: int = LEN_THRESHOLD
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve(self.device)

    @torch.inference_mode()
    def score(self, frames: Sequence) -> float:
        size = self.clip_model.cfg.img_size
        stack = torch.stack(frames_to_device(frames[: self.max_frames], self.device))
        images = clip_preprocess_frames(stack, size)
        feats = _chunked(lambda im: self.clip_model(im)[:, 0], images, self.chunk).float()
        full = torch.zeros((1, self.max_frames, feats.shape[1]), dtype=torch.float32,
                           device=feats.device)
        full[0, : len(feats)] = feats
        return float(torch.sigmoid(self.vsm_model(full))[0])


class QueryPipeline:
    """Per-video orchestration of the full query descriptor path, on
    `device`: the card unless the caller says otherwise."""

    def __init__(
        self,
        extractors: Sequence[DescriptorExtractor],
        pca: Optional[PCAModel] = None,
        ved: Optional[VideoEditDetector] = None,
        use_fsd: bool = True,
        score_threshold: float = SCORE_THRESHOLD,
        frame_threshold: float = FRAME_THRESHOLD,
        out_dim: int = 512,
        use_device_fsd_maps: bool = False,
        device="cuda",
    ):
        self.extractors = list(extractors)
        self.pca = pca
        self.ved = ved
        self.use_fsd = use_fsd
        self.score_threshold = score_threshold
        self.frame_threshold = frame_threshold
        self.out_dim = out_dim
        self.use_device_fsd_maps = use_device_fsd_maps
        self.device = resolve(device)
        self.rnd_idx = 0
        self.video_scores: Dict[str, float] = {}

    def process_video(
        self,
        name: str,
        frames: Sequence,
        timestamps: Optional[Sequence[float]] = None,
    ) -> Tuple[VideoFeature, List[VideoFeature]]:
        """Returns (fused VideoFeature, per-model sub-features)."""
        if timestamps is None:
            timestamps = list(range(len(frames)))
        timestamps = list(timestamps)
        dev_frames = frames_to_device(frames, self.device)

        score = 1.0 if self.ved is None else self.ved.score(dev_frames)
        self.video_scores[name] = score

        proc_frames = dev_frames
        if self.use_fsd:
            _, proc_frames = fsd.image_process(
                dev_frames, self.device, use_device_maps=self.use_device_fsd_maps)

        sub_feats_raw = [_l2(e.extract(proc_frames)) for e in self.extractors]
        features = np.concatenate(sub_feats_raw, axis=1)

        split_ratio = len(features) // len(frames)
        full_timestamps = np.array(timestamps * split_ratio)

        sub_features = [
            VideoFeature(video_id=name, timestamps=full_timestamps, feature=sf)
            for sf in sub_feats_raw
        ]

        if score >= self.score_threshold:
            keep = near_duplicate_keep_indices(features, self.frame_threshold)
            kept = features[keep]
            if self.pca is not None:
                kept = self.pca.transform(kept).astype(np.float32)
            feat = VideoFeature(
                video_id=name,
                timestamps=full_timestamps[keep],
                feature=kept,
            )
        else:
            # The reference's placeholder for "unedited" videos: uniform noise
            # as np.random.seed(k) draws it, interval timestamps [[0, 1]].
            self.rnd_idx += 1
            rng = np.random.RandomState(self.rnd_idx)
            random_feature = rng.uniform(-1e-5, 1e-5, size=self.out_dim).astype(np.float32)
            feat = VideoFeature(
                video_id=name,
                timestamps=np.array([0, 1])[None, ...],
                feature=random_feature[None, ...],
            )
        return feat, sub_features
