"""Matching-track training orchestration (the train_matching.py entry point).

Counterpart of `vsc22_tpu/train/matching_cli.py` (reference contract
M1/train/train_matching.py:255-541), three phases:
  A. per-candidate sim matrices (+ transposes) labeled by the matching GT;
     2-fold MobileNetV3-Small training with out-of-fold probabilities;
  B. pairs above the classify threshold get soft-band-labeled SAM training
     (2-fold HRNet-W18, 128^2, random transpose);
  C. out-of-fold SAM heatmaps (transpose TTA) decoded at 3 operating
     points and evaluated with the segment-AP metric.

Usage:
  python -m vsc22_tpu_torch.train.matching_cli --query_features q.npz \\
      --ref_features r.npz --candidates candidates.csv --gt gt.csv \\
      --work_dir runs/matching [--tiny] [--cls_epochs 10] [--refine_epochs 20] \\
      [--device cpu]

It writes `candidate_scores.csv`, `val_matches.csv`, `summary.json` and
the four fold snapshots (`classify_h1.npz`, `classify_h2.npz`,
`refine_h1.npz`, `refine_h2.npz`) in the JAX package's `save_cnn_snapshot`
layout, which this package's and the JAX package's inference CLIs load.
CSVs go through the stdlib `csv` module. It trains on the card unless
`--device` names another device; the models are float32.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.core.metrics import _binary_average_precision, evaluate_matching_track
from vsc22_tpu_torch.core.storage import load_features
from vsc22_tpu_torch.core.types import Dataset, Match, _read_rows, _write_rows
from vsc22_tpu_torch.matching.decode import decode_all_settings
from vsc22_tpu_torch.matching.simmat import (
    candidate_sim_matrices,
    pad_sim_matrix,
    select_best_split_segment,
)
from vsc22_tpu_torch.models.layers import BatchNorm, Conv, Linear
from vsc22_tpu_torch.pipelines.matching_cli import write_matches_csv
from vsc22_tpu_torch.train.checkpoint import save_cnn_snapshot
from vsc22_tpu_torch.train.matching import train_classify_model, train_refine_model
from vsc22_tpu_torch.utils import jax_params
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator

logger = logging.getLogger("matching_train")


class TinyCNN(nn.Module):
    """The `--tiny` classifier, the JAX CLI's flax `TinyCNN`: Conv(8, 3x3,
    stride 4, flax SAME padding, with bias) -> BN -> relu -> spatial mean
    -> Dense(2), float32."""

    def __init__(self, device=None):
        super().__init__()
        self.conv = Conv(3, 8, 3, stride=4, device=device)
        self.conv_bias = nn.Parameter(torch.zeros(8, device=device))
        self.bn = BatchNorm(8, device)
        self.dense = Linear(8, 2, device=device)

    def reset(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.conv_bias)

    def forward(self, images, train: bool = False, rng=None):
        x = images.float()
        pads = []
        for size in (x.shape[2], x.shape[1]):  # F.pad lists the last dims first
            total = max((-(-size // 4) - 1) * 4 + 3 - size, 0)
            pads += [total // 2, total - total // 2]
        x = self.conv(F.pad(x, [0, 0] + pads)) + self.conv_bias
        return self.dense(F.relu(self.bn(x, train)).mean((1, 2)))

    def entries(self) -> list:
        """The JAX `TinyCNN`'s variables as `jax_params` entries."""
        p, s = ("params",), ("batch_stats",)
        return [(p + ("Conv_0", "kernel"), self.conv.weight, "conv"),
                (p + ("Conv_0", "bias"), self.conv_bias, "id"),
                (p + ("BatchNorm_0", "scale"), self.bn.weight, "id"),
                (p + ("BatchNorm_0", "bias"), self.bn.bias, "id"),
                (s + ("BatchNorm_0", "mean"), self.bn.mean, "id"),
                (s + ("BatchNorm_0", "var"), self.bn.var, "id"),
                (p + ("Dense_0", "kernel"), self.dense.weight, "T"),
                (p + ("Dense_0", "bias"), self.dense.bias, "id")]


def _save_snapshot(path: str, model) -> None:
    if isinstance(model, TinyCNN):
        np.savez(path, **jax_params.jax_flat_params(model.entries()))
    else:
        save_cnn_snapshot(path, model)


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def cross_fold_classify_predict(
    states, features, infos, fold_a, resolution: int, batch: int = 64
) -> List[Tuple[str, str, float, int]]:
    """Every candidate scored by the fold model that did not train on it:
    (query_id, ref_id, prob, label) rows."""
    models = [model for model, _ in states]
    device = _device_of(models[0])
    rows = []
    # states[0] trained outside fold A -> scores fold A; states[1] reverse.
    for start in range(0, len(features), batch):
        chunk_f = features[start : start + batch]
        chunk_i = infos[start : start + batch]
        images = np.stack([
            pad_sim_matrix(np.asarray(f[0] if isinstance(f, list) else f, np.float32), resolution)
            for f in chunk_f])
        x = torch.from_numpy(images).to(device)
        p0, p1 = (torch.softmax(m(x), dim=1)[:, 1].cpu().numpy() for m in models)
        for (qid, rid, label), a, b in zip(chunk_i, p0, p1):
            prob = a if qid in fold_a else b
            rows.append((qid, rid, float(prob), int(label)))
    return rows


@torch.no_grad()
def cross_fold_refine_predict(states, meta, fold_a, resolution: int, batch: int = 8):
    """Out-of-fold SAM heatmaps with transpose TTA; rows for decode. Each
    fold model takes its rows `batch` at a time, the images and their
    transposes in one forward (the JAX CLI runs one pair and then its
    transpose at a time; in eval mode each image's heatmap is its own)."""
    models = [model for model, _ in states]
    device = _device_of(models[0])
    sims = [(qf @ rf.T).astype(np.float32) for _, _, qf, rf, _ in meta]
    probs: List = [None] * len(meta)
    for f, model in enumerate(models):
        # states[0] trained on fold A -> scores out-of-fold rows, etc.
        rows = [i for i, m in enumerate(meta) if (m[0] in fold_a) == (f == 1)]
        for start in range(0, len(rows), batch):
            idx = rows[start : start + batch]
            x = torch.from_numpy(np.stack([pad_sim_matrix(sims[i], resolution) for i in idx]))
            x = x.to(device)
            p = torch.softmax(model(torch.cat([x, x.transpose(1, 2)])), dim=-1)[..., 1]
            merged = ((p[: len(idx)] + p[len(idx):].transpose(1, 2)) / 2.0).cpu().numpy()
            for i, prob in zip(idx, merged):
                probs[i] = prob
    out = []
    for (qid, rid, *_), sim, prob in zip(meta, sims, probs):
        h = min(sim.shape[0], resolution)
        w = min(sim.shape[1], resolution)
        out.append((qid, rid, prob[:h, :w], sim[:h, :w]))
    return out


def _binary_ap(rows) -> float:
    labels = np.array([r[3] for r in rows], np.float64)
    if labels.sum() == 0:
        return 0.0
    return float(_binary_average_precision(labels, np.array([r[2] for r in rows])))


def main(argv=None):
    tune_host_allocator()
    parser = argparse.ArgumentParser()
    parser.add_argument("--query_features", required=True)
    parser.add_argument("--ref_features", required=True)
    parser.add_argument("--candidates", required=True, help="candidates.csv (query_id,ref_id,score)")
    parser.add_argument("--gt", required=True, help="matching ground truth csv")
    parser.add_argument("--work_dir", required=True)
    parser.add_argument("--cls_epochs", type=int, default=10)
    parser.add_argument("--refine_epochs", type=int, default=20)
    parser.add_argument("--cls_threshold", type=float, default=0.1)
    parser.add_argument("--cls_resolution", type=int, default=160)
    parser.add_argument("--refine_resolution", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=2023)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device of the training")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve(args.device)
    os.makedirs(args.work_dir, exist_ok=True)

    queries = {v.video_id: _l2(v.feature) for v in load_features(args.query_features, Dataset.QUERIES)}
    refs = {v.video_id: _l2(v.feature) for v in load_features(args.ref_features, Dataset.REFS)}
    len_map = {k: len(v) for k, v in queries.items()}

    gt = Match.read_csv(args.gt, is_gt=True)
    gt_pairs = {(m.query_id, m.ref_id) for m in gt}
    gt_boxes: Dict[Tuple[str, str], List] = {}
    for m in gt:
        gt_boxes.setdefault((m.query_id, m.ref_id), []).append(
            (m.query_start, m.query_end, m.ref_start, m.ref_end)
        )

    candidates = [
        (q, r, 1.0 if (q, r) in gt_pairs else 0.0)
        for q, r in ((row["query_id"].strip(), row["ref_id"].strip())
                     for row in _read_rows(args.candidates))
        if q in queries and r in refs
    ]
    logger.info("phase A: %d candidates (%d positive)", len(candidates), sum(c[2] for c in candidates))
    features, infos = candidate_sim_matrices(queries, refs, candidates, len_map)

    if args.tiny:
        from vsc22_tpu_torch.models.hrnet import sam_hrnet_tiny_test

        cls_factory, refine_factory = TinyCNN, sam_hrnet_tiny_test
    else:
        from vsc22_tpu_torch.models.hrnet import sam_hrnet_w18
        from vsc22_tpu_torch.models.mobilenetv3 import mobilenetv3_small

        cls_factory = lambda: mobilenetv3_small(device="cpu")
        refine_factory = lambda: sam_hrnet_w18(device="cpu")

    cls_states, fold_a = train_classify_model(
        cls_factory, features, infos,
        num_epochs=args.cls_epochs, resolution=args.cls_resolution,
        seed=args.seed, lr=args.lr, device=device,
    )
    pred_rows = cross_fold_classify_predict(cls_states, features, infos, fold_a,
                                            args.cls_resolution)
    score_file = os.path.join(args.work_dir, "candidate_scores.csv")
    _write_rows(score_file, ["query_id", "ref_id", "prob", "label"],
                ([q, r, repr(p), label] for q, r, p, label in pred_rows))
    ap = _binary_ap(pred_rows)
    logger.info("phase A done: out-of-fold classify AP %.4f -> %s", ap, score_file)

    best: Dict[Tuple[str, str], float] = {}
    for q, r, p, _ in pred_rows:
        best[(q, r)] = max(best.get((q, r), -np.inf), p)
    selected = [pair for pair in sorted(best) if best[pair] > args.cls_threshold]
    logger.info("phase B: %d pairs above threshold %.4g", len(selected), args.cls_threshold)
    meta = [
        (q, r, select_best_split_segment(queries[q], refs[r], len_map[q]), refs[r],
         gt_boxes.get((q, r), []))
        for q, r in selected
    ]
    refine_states, fold_a2 = train_refine_model(
        refine_factory, meta,
        num_epochs=args.refine_epochs, resolution=args.refine_resolution,
        seed=args.seed, lr=args.lr, device=device,
    )

    refined = cross_fold_refine_predict(refine_states, meta, fold_a2, args.refine_resolution)
    rows = [[q, r, qs, qe, rs, re, s] for q, r, qs, rs, qe, re, s in decode_all_settings(refined)]
    match_file = os.path.join(args.work_dir, "val_matches.csv")
    write_matches_csv(rows, match_file)

    seg_ap = None
    if rows:
        seg_ap = evaluate_matching_track(args.gt, match_file).segment_ap.ap
        logger.info("phase C: segment AP %.4f (%d matches)", seg_ap, len(rows))

    # Fold weights for inference (loadable by pipelines.matching_cli).
    for kind, states in (("classify", cls_states), ("refine", refine_states)):
        for tag, (model, _) in zip(("h1", "h2"), states):
            _save_snapshot(os.path.join(args.work_dir, f"{kind}_{tag}.npz"), model)
    with open(os.path.join(args.work_dir, "summary.json"), "w") as f:
        json.dump({"classify_ap": ap, "segment_ap": seg_ap, "pairs": len(meta)}, f)
    return {"classify_ap": ap, "segment_ap": seg_ap, "match_file": match_file}


if __name__ == "__main__":
    main()
