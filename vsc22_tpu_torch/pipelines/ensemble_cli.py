"""Ensemble fusion CLI (the concat_pca_sn.py entry point).

Counterpart of `vsc22_tpu/pipelines/ensemble_cli.py`: fit PCA(512) on the
train refs' normalized concat (on the card unless `--device` says
otherwise), project train and test refs, then score-normalize each phase
against the other as its noise corpus.

Usage:
  python -m vsc22_tpu_torch.pipelines.ensemble_cli \
      --train_refs m1/train_refs.npz m2/train_refs.npz ... \
      --test_refs m1/test_refs.npz m2/test_refs.npz ... \
      --out_dir outputs [--components 512] [--pca_out pca_model.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.core.storage import load_features, store_features
from vsc22_tpu_torch.pipelines.ensemble import apply_ensemble_pca, fit_ensemble_pca
from vsc22_tpu_torch.retrieval.score_norm import ref_score_normalize
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator

logger = logging.getLogger("ensemble_cli")


def main(argv=None):
    tune_host_allocator()
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_refs", nargs="+", required=True, help="per-model npz")
    parser.add_argument("--test_refs", nargs="+", required=True, help="per-model npz")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--components", type=int, default=512)
    parser.add_argument("--pca_out", default=None)
    parser.add_argument("--nk", type=int, default=1)
    parser.add_argument("--beta", type=float, default=1.2)
    parser.add_argument("--device", default="cuda", help="where the PCA fit runs")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    train_models = [load_features(p) for p in args.train_refs]
    test_models = [load_features(p) for p in args.test_refs]

    pca = fit_ensemble_pca(train_models, n_components=args.components, device=device)
    pca.save(args.pca_out or os.path.join(args.out_dir, "pca_model.npz"))
    logger.info("PCA(%d) fit on %d train videos", args.components, len(train_models[0]))

    train_refs = apply_ensemble_pca(train_models, pca)
    test_refs = apply_ensemble_pca(test_models, pca)
    store_features(os.path.join(args.out_dir, "train_refs.npz"), train_refs)
    store_features(os.path.join(args.out_dir, "test_refs.npz"), test_refs)

    # Mutual score normalization (each phase's refs as the other's noise).
    test_sn = ref_score_normalize(test_refs, train_refs, nk=args.nk, beta=args.beta)
    store_features(os.path.join(args.out_dir, "test_refs_sn.npz"), test_sn)
    train_sn = ref_score_normalize(train_refs, test_refs, nk=args.nk, beta=args.beta)
    store_features(os.path.join(args.out_dir, "train_refs_sn.npz"), train_sn)
    logger.info("wrote fused + score-normalized ref sets to %s", args.out_dir)
    return args.out_dir


if __name__ == "__main__":
    main()
