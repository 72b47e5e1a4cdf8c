"""SAM heatmap decoding: connected components + weighted RANSAC line fits.

A copy of `vsc22_tpu/matching/decode.py` (numpy and `scipy.ndimage` only;
importing the JAX package's `matching` loads JAX). The contract, from the
reference M1/infer/src/utils.py:77-119 (`generate_matching_result`):
  - binarize the heatmap at `threshold`;
  - 8-connected components; components with >10 pixels are fitted
    individually (together with all remaining small/unlabeled points);
    if none, all above-threshold points form one component;
  - per component: RANSAC-fit r = f(q) weighted by score^2 (residual 2,
    200 trials, seed 2023); keep positive slopes with >5 inliers within
    |residual| < 1 spanning >3 distinct rows and columns;
  - segment = inlier bounding box; score = max(sim) - std(sim)*std_ratio -
    (max(slope, 1/slope) - 1)/10;
  - three (threshold, std_ratio) operating points are unioned downstream.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import ndimage

DECODE_SETTINGS: Tuple[Tuple[float, float], ...] = ((0.35, 0.5), (0.1, 1.25), (0.001, 2.0))
_EIGHT_CONN = np.ones((3, 3), np.int32)


def _ransac_line(
    x: np.ndarray,
    y: np.ndarray,
    weights: np.ndarray,
    *,
    trials: int = 200,
    residual_threshold: float = 2.0,
    seed: int = 2023,
):
    """Vectorized RANSAC line fit y = coef*x + intercept.

    Same procedure as the reference's sklearn RANSACRegressor call
    (M1/infer/src/utils.py:92-96: 200 trials, residual 2, weighted refit)
    but with all trials evaluated as one [trials, N] numpy pass — sklearn
    loops trials in Python (~1 ms each), which made decode the wall-clock
    wall of matching inference (86 of 120 s measured). Returns
    (coef, intercept) of the weighted-least-squares refit on the best
    trial's inlier set, or None when no valid consensus exists. Results are
    not bit-identical to sklearn (different RNG stream); the procedure —
    2-point minimal samples drawn without replacement, inlier counting,
    weighted refit on the best consensus — is the same.
    """
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, n, (trials, 2))
    # Sample each 2-subset without replacement (sklearn's sample_without_
    # replacement semantics): redraw the second index where it collided, so
    # no trial is wasted on a degenerate single-point "pair".
    if n > 1:
        for _ in range(8):
            dup = pick[:, 0] == pick[:, 1]
            if not dup.any():
                break
            pick[dup, 1] = rng.integers(0, n, int(dup.sum()))
    x0, x1 = x[pick[:, 0]], x[pick[:, 1]]
    y0, y1 = y[pick[:, 0]], y[pick[:, 1]]
    dx = x1 - x0
    ok = dx != 0
    slope = np.where(ok, (y1 - y0) / np.where(ok, dx, 1), 0.0)
    intercept = y0 - slope * x0
    pred = slope[:, None] * x[None, :] + intercept[:, None]
    inliers = np.abs(y[None, :] - pred) < residual_threshold
    counts = inliers.sum(axis=1) * ok
    best = int(np.argmax(counts))
    mask = inliers[best]
    if not ok.any() or mask.sum() < 2:
        return None
    w = weights[mask]
    xm, ym = x[mask].astype(np.float64), y[mask].astype(np.float64)
    total = w.sum()
    if total <= 0:
        return None
    mx, my = (w * xm).sum() / total, (w * ym).sum() / total
    var = (w * (xm - mx) ** 2).sum()
    if var == 0:
        return None
    coef = float((w * (xm - mx) * (ym - my)).sum() / var)
    return coef, float(my - coef * mx)


def generate_matching_result(
    res_list: Sequence[Tuple[str, str, np.ndarray, np.ndarray]],
    threshold: float = 0.05,
    std_ratio: float = 2.0,
) -> List[List]:
    """Decode per-pair heatmaps into [qid, rid, qs, rs, qe, re, score] rows.

    `res_list` entries are (query_id, ref_id, heatmap, original_sim) — the
    score statistics are computed on `heatmap` (reference passes the SAM
    probability map as sim_mat and the raw sim as sim_mat_org, unused).
    """
    match_res: List[List] = []
    for qid, rid, sim_mat, _sim_org in res_list:
        qmat = sim_mat > threshold
        binary = qmat.astype(np.uint8)
        conn_label, num_label = ndimage.label(binary, structure=_EIGHT_CONN)
        # One bincount pass instead of a full-array scan per label (noisy
        # heatmaps produce hundreds of components; semantics identical).
        counts = np.bincount(conn_label.ravel(), minlength=num_label + 1)
        big = np.flatnonzero(counts > 10)
        big = big[big > 0]
        label_cnt: Dict[int, int] = {int(i): int(counts[i]) for i in big}
        if label_cnt:
            qmat[np.isin(conn_label, big)] = False  # handled individually
        else:
            conn_label = qmat.astype(np.int32)
            label_cnt[1] = int(conn_label.sum())

        pair_results = []
        for i in label_cnt:
            x, y = np.where((conn_label == i) | qmat)
            if len(set(x)) > 3:
                prob = sim_mat[x, y]
                fit = _ransac_line(x, y, np.square(prob))
                if fit is None:
                    continue
                coef, intercept = fit
                pred = coef * x + intercept
                qualify = np.abs(y - pred) < 1
                if coef <= 0:
                    continue
                coef = max(1 / coef, coef)
                if (
                    qualify.sum() > 5
                    and len(set(x[qualify])) > 3
                    and len(set(y[qualify])) > 3
                ):
                    qs, qe = int(x[qualify][0]), int(x[qualify][-1])
                    rs, re = int(y[qualify][0]), int(y[qualify][-1])
                    top_sim = sim_mat[x[qualify], y[qualify]]
                    score = float(
                        top_sim.max() - top_sim.std() * std_ratio - abs(coef - 1) / 10
                    )
                    pair_results.append([qs, rs, qe, re, score])
        for qs, rs, qe, re, score in pair_results:
            match_res.append([qid, rid, qs, rs, qe, re, score])
    return match_res


def decode_all_settings(
    res_list: Sequence[Tuple[str, str, np.ndarray, np.ndarray]],
    settings: Sequence[Tuple[float, float]] = DECODE_SETTINGS,
) -> List[List]:
    """Union of the decode operating points, deduplicated by max score
    (reference: infer_matching.py:282-293 union + groupby-max)."""
    best: Dict[Tuple, float] = {}
    for threshold, std_ratio in settings:
        for qid, rid, qs, rs, qe, re, score in generate_matching_result(
            res_list, threshold=threshold, std_ratio=std_ratio
        ):
            key = (qid, rid, qs, rs, qe, re)
            best[key] = max(best.get(key, -np.inf), score)
    return [[*key, score] for key, score in best.items()]
