"""Ensemble fusion: per-model L2-norm -> concat -> PCA(512).

Counterpart of `vsc22_tpu/pipelines/ensemble.py` (reference contract
D1/infer/concat_pca_sn.py): fit PCA(512) on the train refs' normalized
concat, then project every set. The fit runs on `device` (the card unless
the caller names another); the projection is numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.ops.pca import PCAModel, pca_fit
from vsc22_tpu_torch.pipelines.query_extract import _l2


def _by_id(features: List[VideoFeature]) -> Dict[str, VideoFeature]:
    return {vf.video_id: vf for vf in features}


def concat_normalized(model_features: Sequence[List[VideoFeature]]) -> List[VideoFeature]:
    """Per video: L2-normalize each model's features and concat along dim.
    Video order follows the first model's list; every model must cover the
    same video ids with the same frame counts."""
    dicts = [_by_id(f) for f in model_features]
    out = []
    for vid in dicts[0]:
        parts = [_l2(d[vid].feature) for d in dicts]
        out.append(
            VideoFeature(
                video_id=vid,
                timestamps=dicts[0][vid].timestamps,
                feature=np.concatenate(parts, axis=1),
            )
        )
    return out


def fit_ensemble_pca(
    train_ref_features: Sequence[List[VideoFeature]], n_components: int = 512, device="cuda"
) -> PCAModel:
    """Fit PCA on the concatenated normalized train reference descriptors."""
    merged = concat_normalized(train_ref_features)
    stacked = np.concatenate([vf.feature for vf in merged], axis=0)
    return pca_fit(stacked, n_components, device)


def apply_ensemble_pca(
    model_features: Sequence[List[VideoFeature]], pca: PCAModel
) -> List[VideoFeature]:
    """Concat-normalize, then project each video through the fitted PCA."""
    merged = concat_normalized(model_features)
    return [
        VideoFeature(
            video_id=vf.video_id,
            timestamps=vf.timestamps,
            feature=pca.transform(vf.feature).astype(np.float32),
        )
        for vf in merged
    ]
