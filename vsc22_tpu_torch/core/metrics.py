"""Evaluation metrics for both tracks (`vsc22_tpu/core/metrics.py`).

The descriptor-track metric is micro-average-precision over ranked
(query, ref) candidate pairs, rescaled by the fraction of ground-truth
positives that were predicted at all ("canonical"/DrivenData semantics).
The matching-track metric is a segment AP where precision/recall are
geometric means of per-axis (query/ref time) interval overlap ratios,
accumulated as predictions are admitted in score order.

The JAX copy builds pandas dataframes for the canonical AP; this one works
on the candidate lists directly, with the same id formatting. matplotlib
is imported only to plot.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import defaultdict
from math import sqrt
from typing import Collection, Dict, List, Optional, Tuple

import numpy as np

from vsc22_tpu_torch.core.types import Axis, CandidatePair, Dataset, Match, format_video_id


@dataclasses.dataclass
class PrecisionRecallCurve:
    precisions: np.ndarray
    recalls: np.ndarray
    scores: np.ndarray

    def plot(self, ax=None, **kwargs):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
            ax.set_xlabel("recall")
            ax.set_ylabel("precision")
            ax.set_xlim(0, 1.05)
            ax.set_ylim(0, 1.05)
        ax.plot(self.recalls, self.precisions, **kwargs)
        return ax


@dataclasses.dataclass
class AveragePrecision:
    ap: float
    pr_curve: PrecisionRecallCurve
    simple_ap: Optional[float] = None


class Intervals:
    """A set of non-overlapping, sorted [start, end) intervals."""

    intervals: List[Tuple[float, float]]

    def __init__(self, intervals: Optional[List[Tuple[float, float]]] = None):
        self.intervals = list(intervals) if intervals else []
        self._merge()

    def add(self, interval: Tuple[float, float]) -> None:
        self.intervals.append(interval)
        self._merge()

    def union(self, other: "Intervals") -> "Intervals":
        return Intervals(self.intervals + other.intervals)

    def total_length(self) -> float:
        return float(sum(end - start for start, end in self.intervals))

    def intersect_length(self, other: "Intervals") -> float:
        # |A ∩ B| = |A| + |B| − |A ∪ B|
        return self.total_length() + other.total_length() - self.union(other).total_length()

    def _merge(self) -> None:
        if len(self.intervals) <= 1:
            return
        merged = []
        ivs = sorted(self.intervals)
        cur_start, cur_end = ivs[0]
        for start, end in ivs[1:]:
            if start <= cur_end:
                cur_end = max(cur_end, end)
            else:
                merged.append((cur_start, cur_end))
                cur_start, cur_end = start, end
        merged.append((cur_start, cur_end))
        self.intervals = merged

    def __str__(self):
        return str(self.intervals)

    __repr__ = __str__


class VideoPair:
    """Per-(query,ref)-pair interval bookkeeping for segment AP.

    Ground-truth segments only count toward the intersection once at least
    one prediction overlaps them (2-D overlap), but always count toward
    total GT length.
    """

    def __init__(self):
        self.intersections: Dict[Axis, float] = {axis: 0.0 for axis in Axis}
        self.totals: Dict[Axis, float] = {axis: 0.0 for axis in Axis}
        self.gts: List[Match] = []
        self.preds: List[Match] = []

    def total_gt_length(self, axis: Axis) -> float:
        return Intervals([gt.interval(axis) for gt in self.gts]).total_length()

    def total_pred_length(self, axis: Axis) -> float:
        return Intervals([p.interval(axis) for p in self.preds]).total_length()

    def gt_overlaps(self, gt: Match) -> bool:
        return any(gt.overlaps(pred) for pred in self.preds)

    def add_gt(self, bbox: Match) -> None:
        self.gts.append(bbox)

    def add_prediction(self, bbox: Match):
        """Add a prediction; return per-axis deltas of (intersection, total)."""
        self.preds.append(bbox)
        gts_active = [gt for gt in self.gts if self.gt_overlaps(gt)]

        intersect_deltas: Dict[Axis, float] = {}
        total_deltas: Dict[Axis, float] = {}
        for axis in Axis:
            pred_ints = Intervals([p.interval(axis) for p in self.preds])
            gt_ints = Intervals([gt.interval(axis) for gt in gts_active])
            inter = pred_ints.intersect_length(gt_ints)
            total = pred_ints.total_length()
            intersect_deltas[axis] = inter - self.intersections[axis]
            total_deltas[axis] = total - self.totals[axis]
            self.intersections[axis] = inter
            self.totals[axis] = total
        return intersect_deltas, total_deltas


def match_metric(
    gts: Collection[Match],
    predictions: Collection[Match],
) -> AveragePrecision:
    """Matching-track segment AP: Σ P(i)·ΔR(i), P/R geometric-mean over axes."""
    predictions = sorted(predictions, key=lambda m: m.score, reverse=True)

    video_pairs: Dict[Tuple[str, str], VideoPair] = defaultdict(VideoPair)
    for gt in gts:
        video_pairs[gt.pair_id()].add_gt(gt)

    gt_total_lengths = {axis: 0.0 for axis in Axis}
    for pair in video_pairs.values():
        for axis in Axis:
            gt_total_lengths[axis] += pair.total_gt_length(axis)

    recall = 0.0
    metric = 0.0
    intersections = {axis: 0.0 for axis in Axis}
    totals = {axis: 0.0 for axis in Axis}
    pr_recalls: List[float] = []
    pr_precisions: List[float] = []
    pr_scores: List[float] = []

    # Predictions sharing a score are admitted as one group (ties are
    # order-independent for the metric value).
    for score, group in itertools.groupby(predictions, key=lambda m: m.score):
        for pred in group:
            inter_d, total_d = video_pairs[pred.pair_id()].add_prediction(pred)
            for axis in Axis:
                intersections[axis] += inter_d[axis]
                totals[axis] += total_d[axis]

        recalls = {axis: intersections[axis] / gt_total_lengths[axis] for axis in Axis}
        precisions = {axis: intersections[axis] / totals[axis] for axis in Axis}
        new_recall = sqrt(recalls[Axis.QUERY] * recalls[Axis.REF])
        precision = sqrt(precisions[Axis.QUERY] * precisions[Axis.REF])

        delta_recall = new_recall - recall
        metric += precision * delta_recall
        recall = new_recall
        if delta_recall > 0:
            pr_recalls.append(recall)
            pr_precisions.append(precision)
            pr_scores.append(score)

    curve = PrecisionRecallCurve(
        np.asarray(pr_precisions), np.asarray(pr_recalls), np.asarray(pr_scores)
    )
    return AveragePrecision(metric, curve)


def _binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP = Σ_n (R_n − R_{n−1}) · P_n over descending score thresholds,
    tied scores grouped at one threshold (sklearn's
    average_precision_score)."""
    order = np.argsort(-y_score, kind="stable")
    y_true = np.asarray(y_true, dtype=np.float64)[order]
    y_score = np.asarray(y_score, dtype=np.float64)[order]

    # Threshold boundaries: last index of each tied-score group.
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.concatenate([distinct, [y_true.size - 1]])

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = (threshold_idxs + 1) - tps
    total_pos = tps[-1]
    if total_pos == 0:
        return 0.0
    precision = tps / (tps + fps)
    recall = tps / total_pos
    # Prepend (P=1, R=0) as the zero-predictions point.
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))


def _canonical_pairs(pairs: Collection[CandidatePair]) -> List[Tuple[str, str]]:
    return [(format_video_id(p.query_id, Dataset.QUERIES), format_video_id(p.ref_id, Dataset.REFS))
            for p in pairs]


def drivendata_average_precision(
    predicted: Collection[CandidatePair], ground_truth: Collection[CandidatePair]
) -> float:
    """Canonical challenge AP: unadjusted AP over the prediction list,
    rescaled by (#GT positives predicted) / (#GT positives total)."""
    scores = np.asarray([p.score for p in predicted], dtype=np.float64)
    if not np.isfinite(scores).all():
        raise ValueError("Scores must be finite.")

    gt_pairs = set(_canonical_pairs(ground_truth))
    actual = np.array([pair in gt_pairs for pair in _canonical_pairs(predicted)],
                      dtype=np.float64)
    predicted_n_pos = int(actual.sum())
    if predicted_n_pos == 0:
        return 0.0
    unadjusted_ap = _binary_average_precision(actual, scores)
    return unadjusted_ap * (predicted_n_pos / len(ground_truth))


def average_precision(
    ground_truth: Collection[CandidatePair], predictions: Collection[CandidatePair]
) -> AveragePrecision:
    """Descriptor-track micro-AP over ranked candidate pairs."""
    gt_pairs = {(p.query_id, p.ref_id) for p in ground_truth}
    if len(gt_pairs) != len(ground_truth):
        raise AssertionError("Duplicates detected in ground truth")
    predicted_pairs = {(p.query_id, p.ref_id) for p in predictions}
    if len(predicted_pairs) != len(predictions):
        raise AssertionError("Duplicates detected in predictions")

    canonical_ap = drivendata_average_precision(predictions, ground_truth)

    ranked = sorted(predictions, key=lambda p: p.score, reverse=True)
    scores = np.array([p.score for p in ranked])
    correct = np.array([(p.query_id, p.ref_id) in gt_pairs for p in ranked])
    total_pairs = len(gt_pairs)
    cum_correct = np.cumsum(correct)
    cum_predicted = np.arange(len(correct)) + 1
    recall = cum_correct / total_pairs
    precision = cum_correct / cum_predicted
    simple_ap = float(np.sum(precision * correct) / total_pairs)
    hits = np.nonzero(correct)[0]
    curve = PrecisionRecallCurve(precision[hits], recall[hits], scores[hits])
    return AveragePrecision(ap=canonical_ap, pr_curve=curve, simple_ap=simple_ap)


@dataclasses.dataclass
class MatchingTrackMetrics:
    segment_ap: AveragePrecision
    pairwise_micro_ap: AveragePrecision


def evaluate_matching_track(
    ground_truth_filename: str, predictions_filename: str
) -> MatchingTrackMetrics:
    """Full matching-track evaluation from two CSV files."""
    gt = Match.read_csv(ground_truth_filename, is_gt=True)
    predictions = Match.read_csv(predictions_filename)
    segment = match_metric(gt, predictions)
    pair_ap = average_precision(
        CandidatePair.from_matches(gt), CandidatePair.from_matches(predictions)
    )
    return MatchingTrackMetrics(segment_ap=segment, pairwise_micro_ap=pair_ap)
