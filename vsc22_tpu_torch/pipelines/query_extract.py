"""Query-pipeline constants, near-duplicate frame removal and the noise
corpus's minimum-variance dimension.

Counterpart of `vsc22_tpu/pipelines/query_extract.py` (reference contract
D1/infer/extract_query_feats.py:54-244).
"""

from __future__ import annotations

from typing import List

import numpy as np

from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.retrieval.score_norm import _min_variance_dim

SCORE_THRESHOLD = 0.001
LEN_THRESHOLD = 48
FRAME_THRESHOLD = 0.975
MAX_CLIP_FRAMES = 256
NK = 1
BETA = 1.2


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


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
