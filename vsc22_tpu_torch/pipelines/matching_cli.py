"""Matching-track inference CLI (the infer_matching.py / infer.sh entry).

Counterpart of `vsc22_tpu/pipelines/matching_cli.py`, stages 2-6 over
descriptor features written by the extraction CLIs:

  python -m vsc22_tpu_torch.pipelines.matching_cli \\
      --query_features q.npz --ref_features r.npz \\
      --norm_refs noise.npz --out test_matching.csv \\
      [--cls_params h1.npz h2.npz] [--refine_params h1.npz h2.npz] \\
      [--query_len_map lens.json] [--device cpu]

Classify and refine weights are the flat `params/...` and
`batch_stats/...` npz files of the JAX package's `save_cnn_snapshot`
(read by `jax_params.npz_tree`); `-` stands for seeded random weights
(plumbing runs only). Runs on the card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.core.storage import load_features
from vsc22_tpu_torch.core.types import Dataset, _write_rows
from vsc22_tpu_torch.models.hrnet import sam_hrnet_tiny_test, sam_hrnet_w18
from vsc22_tpu_torch.models.layers import reset_parameters
from vsc22_tpu_torch.models.mobilenetv3 import mobilenetv3_small
from vsc22_tpu_torch.pipelines.matching_infer import (
    ClassifyEnsemble,
    RefineEnsemble,
    matching_inference,
)
from vsc22_tpu_torch.pipelines.query_extract import calculate_low_var_dim
from vsc22_tpu_torch.retrieval.score_norm import query_score_normalize, ref_score_normalize
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator
from vsc22_tpu_torch.utils.jax_params import load_mobilenetv3, load_sam_hrnet, npz_tree

logger = logging.getLogger("matching_cli")

COLUMNS = ["query_id", "ref_id", "query_start", "query_end", "ref_start", "ref_end", "score"]


def _load_cnn(build, loader, params_paths, device):
    """One model per path: `-` seeded random weights, else the snapshot."""
    out = []
    for p in params_paths:
        model = build()
        if p == "-":
            reset_parameters(model, torch.Generator().manual_seed(0))
        else:
            loader(model, npz_tree(p))  # a save_cnn_snapshot npz
        out.append(model.to(device).eval())
    return out


def write_matches_csv(rows, path: str) -> None:
    """The JAX CLI's CSV (pandas `to_csv`, index off): float64 starts and
    ends and scores, written as their shortest repr."""
    _write_rows(path, COLUMNS,
                ([q, r] + [repr(float(v)) for v in rest] for q, r, *rest in rows))


def main(argv=None):
    tune_host_allocator()
    parser = argparse.ArgumentParser()
    parser.add_argument("--query_features", required=True)
    parser.add_argument("--ref_features", required=True)
    parser.add_argument("--norm_refs", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--cls_params", nargs="*", default=["-", "-"])
    parser.add_argument("--refine_params", nargs="*", default=["-", "-"])
    parser.add_argument("--query_len_map", default=None, help="json vid->num_frames")
    parser.add_argument("--beta", type=float, default=1.5)
    parser.add_argument("--nk", type=int, default=10)
    parser.add_argument("--cls_threshold", type=float, default=0.0005)
    parser.add_argument(
        "--tiny", action="store_true", help="tiny models (plumbing smoke tests)"
    )
    parser.add_argument("--device", default="cuda", help="torch device of stages 2-5")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve(args.device)

    queries = load_features(args.query_features, Dataset.QUERIES)
    refs = load_features(args.ref_features, Dataset.REFS)
    noise = load_features(args.norm_refs, Dataset.REFS)

    if args.query_len_map:
        with open(args.query_len_map) as f:
            len_map = {k: int(v) for k, v in json.load(f).items()}
    else:
        len_map = {v.video_id: len(v) for v in queries}

    low_var_dim = calculate_low_var_dim(noise)
    sn_queries = query_score_normalize(
        queries, noise, video_scores=None, low_var_dim=low_var_dim,
        beta=args.beta, nk=args.nk, device=device,
    )
    sn_refs = ref_score_normalize(refs, noise, beta=args.beta, nk=args.nk)

    cpu = dict(device="cpu")  # built on the CPU, then moved with their weights
    refine_build = (lambda: sam_hrnet_tiny_test()) if args.tiny else (
        lambda: sam_hrnet_w18(s2d=True, **cpu))
    classify = ClassifyEnsemble(
        _load_cnn(lambda: mobilenetv3_small(**cpu), load_mobilenetv3, args.cls_params, device),
        device=device,
    )
    refine = RefineEnsemble(
        _load_cnn(refine_build, load_sam_hrnet, args.refine_params, device), device=device)

    rows = matching_inference(
        queries, refs, sn_queries, sn_refs, len_map, classify, refine,
        cls_threshold=args.cls_threshold, device=device,
    )
    write_matches_csv(rows, args.out)
    logger.info("wrote %d matches to %s", len(rows), args.out)
    return args.out


if __name__ == "__main__":
    main()
