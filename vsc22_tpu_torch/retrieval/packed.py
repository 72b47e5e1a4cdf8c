"""Flat representation of ragged per-video features (`vsc22_tpu/retrieval/packed.py`).

Ragged lists of [N_i, D] arrays (the host currency, `core.types.VideoFeature`)
become one [total_rows, D] matrix plus integer row -> video ownership
vectors, padded up to a multiple of `pad_multiple` rows as the JAX copy
pads them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from vsc22_tpu_torch.core.types import VideoFeature


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


@dataclasses.dataclass
class PackedFeatures:
    """Flat row-major packing of a list of VideoFeatures.

    Attributes:
      features:   [padded_rows, D] float32; rows >= num_rows are zero padding.
      video_idx:  [padded_rows] int32; index into `video_ids` per row
                  (padding rows hold -1).
      frame_idx:  [padded_rows] int32; frame index within the owning video
                  (padding rows hold -1).
      num_rows:   real (unpadded) row count.
      video_ids:  list of video id strings, order preserved.
      timestamps: list of per-video timestamp arrays ([N] or [N, 2]).
    """

    features: np.ndarray
    video_idx: np.ndarray
    frame_idx: np.ndarray
    num_rows: int
    video_ids: List[str]
    timestamps: List[np.ndarray]

    @property
    def dim(self) -> int:
        return int(self.features.shape[1])

    @property
    def padded_rows(self) -> int:
        return int(self.features.shape[0])

    @classmethod
    def from_video_features(
        cls, videos: Sequence[VideoFeature], pad_multiple: int = 128
    ) -> "PackedFeatures":
        if not videos:
            raise ValueError("cannot pack an empty feature list")
        dim = videos[0].dimensions()
        total = sum(len(v) for v in videos)
        padded = round_up(max(total, 1), pad_multiple)

        features = np.zeros((padded, dim), dtype=np.float32)
        video_idx = np.full((padded,), -1, dtype=np.int32)
        frame_idx = np.full((padded,), -1, dtype=np.int32)

        row = 0
        video_ids: List[str] = []
        timestamps: List[np.ndarray] = []
        for i, vf in enumerate(videos):
            n = len(vf)
            features[row : row + n] = vf.feature
            video_idx[row : row + n] = i
            frame_idx[row : row + n] = np.arange(n, dtype=np.int32)
            video_ids.append(vf.video_id)
            timestamps.append(np.asarray(vf.timestamps))
            row += n
        return cls(
            features=features,
            video_idx=video_idx,
            frame_idx=frame_idx,
            num_rows=total,
            video_ids=video_ids,
            timestamps=timestamps,
        )

    def get_timestamps(self, video: int, frame: int):
        t = self.timestamps[video][frame]
        if self.timestamps[video].ndim == 1:
            return (float(t), float(t))
        return (float(t[0]), float(t[1]))

    def to_video_features(self) -> List[VideoFeature]:
        out = []
        row = 0
        for i, vid in enumerate(self.video_ids):
            n = len(self.timestamps[i])
            out.append(
                VideoFeature(
                    video_id=vid,
                    timestamps=self.timestamps[i],
                    feature=self.features[row : row + n].copy(),
                )
            )
            row += n
        return out
