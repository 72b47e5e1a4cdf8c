"""Feature storage: the npz format of `vsc22_tpu/core/storage.py`.

One ``.npz`` holds
  - ``video_ids``:   [N] str (or int) array, one entry per descriptor row,
    contiguous runs per video;
  - ``features``:    [N, D] float32;
  - ``timestamps``:  [N] or [N, 2] float.

``load_features`` groups contiguous equal-id runs back into ``VideoFeature``s.
Files written by either package load in the other
(`tests/test_torch_eval.py`).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from vsc22_tpu_torch.core.types import Dataset, VideoFeature, format_video_id


def store_features(f, features: List[VideoFeature], dataset: Optional[Dataset] = None) -> None:
    """Write a list of VideoFeatures to ``f`` (path or file object) as npz."""
    video_ids = []
    feats = []
    timestamps = []
    for vf in features:
        vid = format_video_id(vf.video_id, dataset)
        video_ids.append(np.full(len(vf), vid))
        feats.append(vf.feature)
        timestamps.append(vf.timestamps)
    np.savez(
        f,
        video_ids=np.concatenate(video_ids),
        features=np.concatenate(feats).astype(np.float32),
        timestamps=np.concatenate(timestamps),
    )


def same_value_ranges(values) -> Iterator[Tuple[object, int, int]]:
    """Yield (value, start, end) for each contiguous run of equal values."""
    n = len(values)
    if n == 0:
        return
    start = 0
    current = values[0]
    for i in range(1, n):
        if values[i] != current:
            yield current, start, i
            start = i
            current = values[i]
    yield current, start, n


def load_features(f, dataset: Optional[Dataset] = None) -> List[VideoFeature]:
    """Read an npz feature file back into a list of VideoFeatures."""
    data = np.load(f, allow_pickle=False)
    video_ids = data["video_ids"]
    feats = data["features"].astype(np.float32)
    timestamps = data["timestamps"]

    if timestamps.shape[0] != feats.shape[0]:
        raise ValueError(
            f"timestamp count {timestamps.shape[0]} != feature rows {feats.shape[0]}"
        )
    if not (timestamps.ndim == 1 or timestamps.shape[1:] == (2,)):
        raise ValueError(f"unexpected timestamp shape {timestamps.shape}")

    return [
        VideoFeature(
            video_id=format_video_id(vid, dataset),
            timestamps=timestamps[start:end],
            feature=feats[start:end, :],
        )
        for vid, start, end in same_value_ranges(video_ids)
    ]
