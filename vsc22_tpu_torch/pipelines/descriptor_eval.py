"""Descriptor-track evaluation pipeline: score-norm -> search -> localize -> metrics.

Counterpart of `vsc22_tpu/pipelines/descriptor_eval.py`: retrieve 1200 hits
per query through the exact global budget, keep the top 25 candidates per
query, TN-localize the top 5 per query, write candidates.csv and
matches.csv, and score candidate µAP and segment AP against a ground truth.
The search runs on `device`, the card unless the caller names another.

Usage:
  python -m vsc22_tpu_torch.pipelines.descriptor_eval \\
      --query_features q.npz --ref_features r.npz --output_path out/ \\
      [--score_norm_features noise.npz] [--ground_truth gt.csv] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np

from vsc22_tpu_torch.align.localization import (
    VCSLLocalizationCandidateScore,
    VCSLLocalizationMaxSim,
)
from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.core.metrics import average_precision, evaluate_matching_track
from vsc22_tpu_torch.core.storage import load_features, store_features
from vsc22_tpu_torch.core.types import CandidatePair, Dataset, Match, VideoFeature
from vsc22_tpu_torch.retrieval.index import CandidateGeneration, MaxScoreAggregation
from vsc22_tpu_torch.retrieval.score_norm import score_normalize, transform_features
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator

logger = logging.getLogger("descriptor_eval")


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def search(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    retrieve_per_query: float = 1200.0,
    candidates_per_query: float = 25.0,
    device="cuda",
    transfer_dtype=np.float16,
) -> List[CandidatePair]:
    """Global-k budget retrieval, truncated to top candidates_per_query * |Q|.

    transfer_dtype=np.float16 (the default) halves the corpus on the device
    at ~1e-3 score perturbation on unit vectors; the global top-k selection
    is still exact over the shipped values. np.float32 keeps f32 scores.
    """
    cg = CandidateGeneration(
        refs, MaxScoreAggregation(), device=device, transfer_dtype=transfer_dtype
    )
    num_to_retrieve = int(retrieve_per_query * len(queries))
    return cg.query(queries, global_k=num_to_retrieve,
                    limit=int(candidates_per_query * len(queries)))


def localize_and_verify(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    candidates: List[CandidatePair],
    localize_per_query: float = 5.0,
    score_normalization: bool = False,
    batch_size: int = 512,
    concurrency: int = 0,
) -> List[Match]:
    """TN-align the top candidates into segment matches; `concurrency > 0`
    fans the pairs over that many worker processes, one pool for all
    batches."""
    candidates = candidates[: int(len(queries) * localize_per_query)]
    if score_normalization:
        alignment = VCSLLocalizationMaxSim(
            queries,
            refs,
            model_type="TN",
            tn_max_step=5,
            min_length=4,
            similarity_bias=0.5,
            concurrency=concurrency,
        )
    else:
        alignment = VCSLLocalizationCandidateScore(
            transform_features(queries, _l2),
            transform_features(refs, _l2),
            model_type="TN",
            tn_max_step=5,
            min_length=4,
            concurrency=concurrency,
        )
    matches: List[Match] = []
    with alignment.model:
        for i in range(0, len(candidates), batch_size):
            matches.extend(alignment.localize_all(candidates[i : i + batch_size]))
            logger.info("aligned %d/%d pairs", min(i + batch_size, len(candidates)),
                        len(candidates))
    return matches


@dataclasses.dataclass
class EvalResult:
    candidate_file: str
    match_file: str
    candidate_uap: Optional[float] = None
    segment_ap: Optional[float] = None


def run(
    query_features: str,
    ref_features: str,
    output_path: str,
    score_norm_features: Optional[str] = None,
    ground_truth: Optional[str] = None,
    device="cuda",
    plots: bool = False,
    concurrency: int = 0,
) -> EvalResult:
    device = resolve(device)
    queries = load_features(query_features, Dataset.QUERIES)
    refs = load_features(ref_features, Dataset.REFS)
    score_normalization = False
    if score_norm_features:
        queries, refs = score_normalize(
            queries, refs, load_features(score_norm_features, Dataset.REFS), beta=1.2,
            device=device,
        )
        score_normalization = True
        os.makedirs(output_path, exist_ok=True)
        store_features(os.path.join(output_path, "sn_queries.npz"), queries)
        store_features(os.path.join(output_path, "sn_refs.npz"), refs)

    os.makedirs(output_path, exist_ok=True)
    candidates = search(queries, refs, device=device)
    candidate_file = os.path.join(output_path, "candidates.csv")
    CandidatePair.write_csv(candidates, candidate_file)

    matches = localize_and_verify(
        queries, refs, candidates, score_normalization=score_normalization,
        concurrency=concurrency,
    )
    match_file = os.path.join(output_path, "matches.csv")
    Match.write_csv(matches, match_file)

    result = EvalResult(candidate_file, match_file)
    if ground_truth:
        gt_matches = Match.read_csv(ground_truth, is_gt=True)
        gt_pairs = CandidatePair.from_matches(gt_matches)
        candidate_pairs = CandidatePair.read_csv(candidate_file)
        candidate_ap = average_precision(gt_pairs, candidate_pairs)
        match_metrics = evaluate_matching_track(ground_truth, match_file)
        result.candidate_uap = candidate_ap.ap
        result.segment_ap = match_metrics.segment_ap.ap
        logger.info("candidate uAP: %.4f", result.candidate_uap)
        logger.info("segment AP: %.4f", result.segment_ap)
        if plots:
            _write_pr_plot(
                candidate_ap, os.path.join(output_path, "candidate_precision_recall.pdf")
            )
            _write_pr_plot(
                match_metrics.segment_ap, os.path.join(output_path, "precision_recall.pdf")
            )
    return result


def _write_pr_plot(ap, filename: str) -> None:
    """PR-curve PDF (needs matplotlib, imported only here)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    ap.pr_curve.plot(linewidth=1)
    plt.savefig(filename)
    plt.close("all")


def main(argv=None):
    tune_host_allocator()
    parser = argparse.ArgumentParser()
    parser.add_argument("--query_features", required=True)
    parser.add_argument("--ref_features", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--score_norm_features", default=None)
    parser.add_argument("--ground_truth", default=None)
    parser.add_argument("--device", default="cuda", help="torch device of the search")
    parser.add_argument("--plots", action="store_true", help="write PR-curve PDFs")
    parser.add_argument("--concurrency", type=int, default=0, help="TN alignment process pool size")
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(argv)
    if os.path.exists(os.path.join(args.output_path, "candidates.csv")) and not args.overwrite:
        raise SystemExit(f"{args.output_path} exists; pass --overwrite")
    logging.basicConfig(level=logging.INFO)
    result = run(
        args.query_features,
        args.ref_features,
        args.output_path,
        args.score_norm_features,
        args.ground_truth,
        device=args.device,
        plots=args.plots,
        concurrency=args.concurrency,
    )
    print(result)


if __name__ == "__main__":
    main()
