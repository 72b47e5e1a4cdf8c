"""Development-time feature-wrangling flows around the npz and zip formats.

A copy of `vsc22_tpu/pipelines/dev_tools.py` (numpy only: the model work
is the caller's `extract_fn` / `overlay_fn`), kept in the port because the
JAX module cannot be imported without JAX:

- ``filter_features_by_score``: videos whose VED score is under a
  threshold collapse to one deterministic random placeholder row;
- ``refine_subimage_features``: per-sub-image descriptors of scene-split
  videos merged back by a softmax-weighted average (or stacked);
- ``dedup_video_features``: greedy near-duplicate frame filtering on
  stored features (the live query pipeline's rule);
- ``extract_features_to_zip`` / ``extract_overlay_maps``: per-item
  embeddings or overlay maps into a STORED zip of .npy arrays,
  process-sharded; ``merge_feature_zips`` and ``read_feature_zip``.
"""

from __future__ import annotations

import io
import zipfile
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.pipelines.query_extract import near_duplicate_keep_indices
from vsc22_tpu_torch.pipelines.ref_extract import shard_videos


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def filter_features_by_score(
    features: Sequence[VideoFeature],
    video_scores: Dict[str, float],
    threshold: float = 0.1,
    seed: int = 0,
) -> List[VideoFeature]:
    """Replace low-VED-score videos with one tiny random placeholder row.

    Semantics of img_filter.py: scores below `threshold` mean "this video is
    probably not an edited copy", so its descriptors are collapsed to a
    single ~zero vector that cannot win any retrieval. The placeholder is
    drawn deterministically (seeded per video position) so reruns are
    byte-stable, unlike the reference's global-RNG draw.
    """
    out: List[VideoFeature] = []
    for i, vf in enumerate(features):
        score = video_scores.get(vf.video_id)
        if score is not None and score < threshold:
            rng = np.random.RandomState(seed + i + 1)
            vec = rng.uniform(-1e-5, 1e-5, size=vf.feature.shape[1]).astype(
                np.float32
            )
            out.append(
                VideoFeature(
                    video_id=vf.video_id,
                    timestamps=np.asarray(vf.timestamps)[:1],
                    feature=vec[None, :],
                )
            )
        else:
            out.append(vf)
    return out


def refine_subimage_features(
    features: Sequence[VideoFeature],
    subimage_feats: Dict[str, np.ndarray],  # vid -> [frames, k, D]
    subimage_weights: Dict[str, np.ndarray],  # vid -> [k, frames, 1] raw scores
    stack: bool = False,
) -> List[VideoFeature]:
    """Merge per-sub-image descriptors back into per-frame descriptors.

    For every video with sub-image features (a scene-split video whose crops
    were embedded separately):

    - default: softmax the raw weights over the sub-image axis and take the
      weighted average — ``sum_k w_k f_k`` with ``w`` summing to 1 per frame
      (refine_img.py:55-56);
    - ``stack=True``: emit all k sub-image rows as extra frames, repeating
      the video id and timestamps k times (refine_img.py:61-67).

    Videos without sub-images pass through unchanged.
    """
    out: List[VideoFeature] = []
    for vf in features:
        sub = subimage_feats.get(vf.video_id)
        if sub is None:
            out.append(vf)
            continue
        sub = np.asarray(sub, np.float32)  # [frames, k, D]
        if sub.shape[0] != vf.feature.shape[0]:
            raise ValueError(
                f"{vf.video_id}: {sub.shape[0]} sub-image frames vs "
                f"{vf.feature.shape[0]} base frames"
            )
        if stack:
            merged = np.concatenate(
                [sub[:, k] for k in range(sub.shape[1])], axis=0
            )
            ts = np.asarray(vf.timestamps)
            out.append(
                VideoFeature(
                    video_id=vf.video_id,
                    timestamps=np.concatenate([ts] * sub.shape[1], axis=0),
                    feature=merged.astype(np.float32),
                )
            )
        else:
            w = np.asarray(subimage_weights[vf.video_id], np.float32)
            # reference layout: [k, frames, 1] -> softmax over k after
            # transposing to [frames, k, 1]
            probs = _softmax(np.transpose(w, (1, 0, 2)), axis=1)
            merged = (probs * sub).sum(axis=1) / probs.sum(axis=1)
            out.append(
                VideoFeature(
                    video_id=vf.video_id,
                    timestamps=np.asarray(vf.timestamps),
                    feature=merged.astype(np.float32),
                )
            )
    return out


def dedup_video_features(
    features: Sequence[VideoFeature], threshold: float = 0.95
) -> Tuple[List[VideoFeature], int]:
    """Greedy near-duplicate frame removal on stored features.

    Returns (filtered features, number of frames removed). Same rule as the
    live query pipeline (and inference_zipv2.py:100-112): anchors in
    descending mean-similarity order; frames more similar than `threshold`
    to a surviving anchor are dropped.
    """
    out: List[VideoFeature] = []
    removed = 0
    for vf in features:
        keep = near_duplicate_keep_indices(vf.feature, threshold)
        removed += vf.feature.shape[0] - len(keep)
        ts = np.asarray(vf.timestamps)
        out.append(
            VideoFeature(
                video_id=vf.video_id,
                timestamps=ts[keep],
                feature=vf.feature[keep],
            )
        )
    return out, removed


def extract_features_to_zip(
    items: Iterable[Tuple[str, np.ndarray]],
    extract_fn: Callable[[np.ndarray], np.ndarray],
    zip_path: str,
    process_index: int = 0,
    process_count: int = 1,
    dtype=np.float16,
) -> int:
    """Embed items and write one ``<key>.npy`` per item into a STORED zip.

    ``items`` yields (key, frames) pairs; ``extract_fn`` maps frames to an
    embedding array. Keys are deterministically strided across processes
    (the DistributedSampler contract) — per-process zips merge with
    ``merge_feature_zips``. This is the generic form of the reference's
    inference_img/inference_zip flows (one npy per key inside feats.zip).
    """
    items = list(items)
    keys = shard_videos([k for k, _ in items], process_index, process_count)
    keyset = set(keys)
    written = 0
    with zipfile.ZipFile(zip_path, "w", compression=zipfile.ZIP_STORED) as zf:
        for key, frames in items:
            if key not in keyset:
                continue
            emb = np.asarray(extract_fn(frames)).astype(dtype)
            buf = io.BytesIO()
            np.save(buf, emb)
            zf.writestr(key, buf.getvalue())
            written += 1
    return written


def extract_overlay_maps(
    items: Iterable[Tuple[str, np.ndarray]],
    overlay_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
    zip_path: str,
    process_index: int = 0,
    process_count: int = 1,
    chunk: int = 128,
) -> int:
    """Per-frame overlay detection maps + scores into a STORED zip.

    Equivalent of the reference's dev-only overlay extractor
    (D1/train/train_v107/vsc/baseline/inference_overlay.py:55-117 —
    original implementation, for cross-checking): for every video, the
    model's per-frame decoder maps are written as ``<vid>_f`` and the
    sigmoid frame scores as ``<vid>_s`` (one .npy each, same key layout).

    ``overlay_fn`` maps a [n, H, W, 3] frame stack to (scores [n],
    maps [n, ...]); frames are fed in ``chunk``-frame slices exactly like
    the reference's 128-frame sub-batching, so arbitrarily long videos
    never exceed one chunk of device memory. Videos are strided across
    processes; shards merge with ``merge_feature_zips``.
    """
    items = list(items)
    keys = set(shard_videos([k for k, _ in items], process_index, process_count))
    written = 0
    with zipfile.ZipFile(zip_path, "w", compression=zipfile.ZIP_STORED) as zf:
        for key, frames in items:
            if key not in keys:
                continue
            scores, maps = [], []
            for i in range(0, len(frames), chunk):
                s, m = overlay_fn(frames[i : i + chunk])
                scores.append(np.asarray(s))
                maps.append(np.asarray(m))
            for suffix, arr in (("_f", np.concatenate(maps)),
                                ("_s", np.concatenate(scores))):
                buf = io.BytesIO()
                np.save(buf, arr)
                zf.writestr(f"{key}{suffix}", buf.getvalue())
            written += 1
    return written


def merge_feature_zips(shard_paths: Sequence[str], out_path: str) -> int:
    """Concatenate per-process feature zips into one (rank-0 merge step)."""
    n = 0
    with zipfile.ZipFile(out_path, "w", compression=zipfile.ZIP_STORED) as out:
        for path in shard_paths:
            with zipfile.ZipFile(path, "r") as zf:
                for name in zf.namelist():
                    out.writestr(name, zf.read(name))
                    n += 1
    return n


def read_feature_zip(zip_path: str, key: str) -> np.ndarray:
    with zipfile.ZipFile(zip_path, "r") as zf:
        return np.load(io.BytesIO(zf.read(key)), allow_pickle=False)
