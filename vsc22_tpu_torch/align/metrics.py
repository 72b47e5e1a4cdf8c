"""Segment-level precision/recall over alignment box lists (VCSL metric).

Counterpart of `vsc22_tpu/align/metrics.py`, a copy (host numpy).

Parity target (reference, for cross-checking — original implementation):
  D1/infer/vcsl/metric.py — per-(query,ref) precision/recall of predicted
  [q0, r0, q1, r1] boxes against ground-truth boxes, measured as covered
  span length on each axis (the VCSL protocol used to tune the alignment
  algorithms; the challenge metric itself lives in core.metrics).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _axis_cover(pred: np.ndarray, gt: np.ndarray, axis0: int, axis1: int) -> Tuple[float, float]:
    """(intersection length, gt length) on one axis, over merged intervals."""

    def merged_length(intervals: np.ndarray) -> float:
        if len(intervals) == 0:
            return 0.0
        order = np.argsort(intervals[:, 0])
        total, cur_s, cur_e = 0.0, None, None
        for s, e in intervals[order]:
            if cur_s is None:
                cur_s, cur_e = s, e
            elif s <= cur_e:
                cur_e = max(cur_e, e)
            else:
                total += cur_e - cur_s
                cur_s, cur_e = s, e
        if cur_s is not None:
            total += cur_e - cur_s
        return float(total)

    gt_iv = gt[:, (axis0, axis1)].astype(np.float64)
    pred_iv = pred[:, (axis0, axis1)].astype(np.float64)
    inter = []
    for gs, ge in gt_iv:
        for ps, pe in pred_iv:
            s, e = max(gs, ps), min(ge, pe)
            if e > s:
                inter.append((s, e))
    return merged_length(np.asarray(inter).reshape(-1, 2)), merged_length(gt_iv)


def segment_precision_recall(
    pred_boxes: Sequence[Sequence[float]], gt_boxes: Sequence[Sequence[float]]
) -> Dict[str, float]:
    """Precision/recall of [q0, r0, q1, r1] boxes for one video pair.

    recall   = covered GT span / total GT span (geometric mean over axes)
    precision= covered prediction span / total prediction span
    """
    pred = np.asarray(pred_boxes, np.float64).reshape(-1, 4)
    gt = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
    out = {"precision": 0.0, "recall": 0.0, "f1": 0.0}
    if len(gt) == 0 or len(pred) == 0:
        return out

    rec_axes, prec_axes = [], []
    for a0, a1 in ((0, 2), (1, 3)):  # (q0,q1) then (r0,r1)
        inter, gt_len = _axis_cover(pred, gt, a0, a1)
        rec_axes.append(inter / gt_len if gt_len > 0 else 0.0)
        inter_p, pred_len = _axis_cover(gt, pred, a0, a1)
        prec_axes.append(inter_p / pred_len if pred_len > 0 else 0.0)

    recall = float(np.sqrt(rec_axes[0] * rec_axes[1]))
    precision = float(np.sqrt(prec_axes[0] * prec_axes[1]))
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {"precision": precision, "recall": recall, "f1": f1}


def evaluate_alignment(
    predictions: Dict[Tuple[str, str], List],
    ground_truth: Dict[Tuple[str, str], List],
) -> Dict[str, float]:
    """Macro-averaged segment P/R/F1 over video pairs (VCSL protocol)."""
    precisions, recalls = [], []
    for key, gt_boxes in ground_truth.items():
        pr = segment_precision_recall(predictions.get(key, []), gt_boxes)
        precisions.append(pr["precision"])
        recalls.append(pr["recall"])
    precision = float(np.mean(precisions)) if precisions else 0.0
    recall = float(np.mean(recalls)) if recalls else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {"precision": precision, "recall": recall, "f1": f1}
