"""Reference-corpus feature extraction (process-sharded, shard-merged).

Counterpart of `vsc22_tpu/pipelines/ref_extract.py` (reference contract
D1/infer/extract_ref_feats.py + infer_ref.sh): videos are sharded by
(process_index, process_count); each process extracts its shard with
LEN_THRESHOLD-frame chunks (no FSD on refs: the reference applies FSD to
queries only) and writes `<out>.shard{K}.npz`; `merge_shards` concatenates
the shards sorted by video id into the reference npz format.
"""

from __future__ import annotations

import glob
import logging
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from vsc22_tpu_torch.core.storage import load_features, store_features
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.pipelines.query_extract import DescriptorExtractor

logger = logging.getLogger("ref_extract")


def shard_videos(
    video_ids: Sequence[str], process_index: int, process_count: int
) -> List[str]:
    """Deterministic striding shard (the DistributedSampler contract)."""
    ordered = sorted(video_ids)
    return ordered[process_index::process_count]


def extract_shard(
    videos: Iterable[Tuple[str, Sequence]],
    extractor: DescriptorExtractor,
    l2_normalize: bool = False,
) -> List[VideoFeature]:
    """Descriptors of (vid, frames) pairs; frames are raw uint8 images."""
    out = []
    for vid, frames in videos:
        if not len(frames):
            logger.warning("skipping %s: no frames", vid)
            continue
        feats = extractor.extract(frames)
        if l2_normalize:
            feats = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
        out.append(
            VideoFeature(
                video_id=vid,
                timestamps=np.arange(len(feats), dtype=np.float32),
                feature=feats.astype(np.float32),
            )
        )
    return out


def write_shard(path_prefix: str, process_index: int, features: List[VideoFeature]) -> str:
    shard_path = f"{path_prefix}.shard{process_index}.npz"
    store_features(shard_path, features)
    return shard_path


def merge_shards(path_prefix: str, out_path: Optional[str] = None) -> str:
    """Merge `<prefix>.shard*.npz` into one npz sorted by video id."""
    shards = sorted(glob.glob(f"{path_prefix}.shard*.npz"))
    if not shards:
        raise FileNotFoundError(f"no shards matching {path_prefix}.shard*.npz")
    features: List[VideoFeature] = []
    for s in shards:
        features.extend(load_features(s))
    features.sort(key=lambda vf: vf.video_id)
    out_path = out_path or f"{path_prefix}.npz"
    store_features(out_path, features)
    return out_path


def extract_references(
    videos: Iterable[Tuple[str, Sequence]],
    extractor: DescriptorExtractor,
    out_prefix: str,
    process_index: int = 0,
    process_count: int = 1,
    merge: bool = True,
) -> Optional[str]:
    """Per-process flow: shard -> extract -> write -> (merge on process 0 of
    a single-process run). In a multi-process run every process calls this
    with its own index, and process 0 merges after all shards exist."""
    videos = list(videos)
    my_vids = set(shard_videos([v for v, _ in videos], process_index, process_count))
    my_videos = [(v, f) for v, f in videos if v in my_vids]
    features = extract_shard(my_videos, extractor)
    write_shard(out_prefix, process_index, features)
    if merge and process_index == 0 and process_count == 1:
        return merge_shards(out_prefix)
    return None
