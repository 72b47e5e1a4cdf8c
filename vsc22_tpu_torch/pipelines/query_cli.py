"""Query feature-extraction CLI (the extract_query_feats.py entry point).

Counterpart of `vsc22_tpu/pipelines/query_cli.py`, with the same flags and
`--device` (the card unless it names another). Each ensemble member is a
registry backbone with the JAX package's npz snapshot (`-`: seeded random
weights); the query videos are decoded (`data/frames.read_frames`) and run
through the per-video `QueryPipeline` (the VED gate when `--clip` and
`--vsm` are given, FSD, the ensemble, dedup, PCA); the per-model
sub-features and the score-normalized fused features are written.

Usage:
  python -m vsc22_tpu_torch.pipelines.query_cli \
      --videos DIR --out_dir outputs --split test \
      --model vit_v68:vit_base_patch32_384:ckpt.params.npz:384:efficientnet \
      [--model ...x4] --pca pca_model.npz --norm_refs train_refs.npz \
      [--clip clip.params.npz --vsm vsm.params.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Iterable, Iterator, List, Sequence, Tuple

import torch

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.core.storage import load_features, store_features
from vsc22_tpu_torch.core.types import Dataset
from vsc22_tpu_torch.data.frames import read_frames
from vsc22_tpu_torch.models.layers import reset_parameters
from vsc22_tpu_torch.models.registry import build_backbone
from vsc22_tpu_torch.ops.pca import PCAModel
from vsc22_tpu_torch.pipelines.preprocess import discover_videos
from vsc22_tpu_torch.pipelines.query_extract import (
    BETA,
    NK,
    SCORE_THRESHOLD,
    DescriptorExtractor,
    QueryPipeline,
    VideoEditDetector,
    calculate_low_var_dim,
)
from vsc22_tpu_torch.retrieval.score_norm import query_score_normalize
from vsc22_tpu_torch.train.checkpoint import load_params_snapshot
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator

logger = logging.getLogger("query_cli")


def load_model(backbone: str, params_path: str, device):
    """A registry backbone on `device` with the weights of `params_path`
    (either package's npz snapshot), or seeded random weights for `-`."""
    model = build_backbone({"type": backbone}, device=device)
    if params_path == "-":
        reset_parameters(model, torch.Generator().manual_seed(0))
    else:
        load_params_snapshot(params_path, model)
    return model.eval()


def build_extractor(spec: str, device) -> tuple:
    """'name:backbone_type:params.npz:size:preset' -> (name, extractor)."""
    name, backbone, params_path, size, preset = spec.split(":")
    model = load_model(backbone, params_path, device)
    return name, DescriptorExtractor(model=model, size=int(size), preset=preset, device=device)


def decoded_videos(videos_dir: str, fps: float) -> Iterator[Tuple[str, list]]:
    """(vid, frames) of every video under `videos_dir` that decodes; the
    others are skipped with a warning."""
    for vid, path in discover_videos(videos_dir):
        frames = read_frames(path, fps=fps)
        if not frames:
            logger.warning("skipping %s (decode failed)", vid)
            continue
        yield vid, frames


def extract_queries(
    videos: Iterable[Tuple[str, Sequence]],
    pipe: QueryPipeline,
    names: List[str],
    out_dir: str,
    split: str,
    norm_refs: str,
) -> str:
    """The work after decode: each (vid, frames) through `pipe` (ids get a
    `Q` prefix where they lack one), the sub-features of member i under
    `out_dir/names[i]/<split>_query.npz`, then the fused features
    score-normalized against `norm_refs` (query score-norm, nk 1) in
    `out_dir/<split>_query_sn.npz`, whose path is returned."""
    os.makedirs(out_dir, exist_ok=True)
    fused, subs = [], []
    for vid, frames in videos:
        feat, sub_feats = pipe.process_video(vid if vid.startswith("Q") else f"Q{vid}", frames)
        fused.append(feat)
        subs.append(sub_feats)
        logger.info("%s: %d frames -> %d descriptors", vid, len(frames), len(feat))

    for i, name in enumerate(names):
        sub_dir = os.path.join(out_dir, name)
        os.makedirs(sub_dir, exist_ok=True)
        store_features(os.path.join(sub_dir, f"{split}_query.npz"), [s[i] for s in subs])

    score_norm_refs = load_features(norm_refs, Dataset.REFS)
    low_var_dim = calculate_low_var_dim(score_norm_refs)
    normalized = query_score_normalize(
        fused,
        score_norm_refs,
        pipe.video_scores,
        SCORE_THRESHOLD,
        low_var_dim,
        nk=NK,
        beta=BETA,
        device=pipe.device,
    )
    out = os.path.join(out_dir, f"{split}_query_sn.npz")
    store_features(out, normalized)
    logger.info("wrote %s (%d videos)", out, len(normalized))
    return out


def main(argv=None):
    tune_host_allocator()
    parser = argparse.ArgumentParser()
    parser.add_argument("--videos", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--model", action="append", required=True)
    parser.add_argument("--pca", default=None)
    parser.add_argument("--norm_refs", required=True)
    parser.add_argument("--clip", default=None, help="CLIP params npz ('-' = random init)")
    parser.add_argument("--vsm", default=None, help="video-score params npz")
    parser.add_argument("--fps", type=float, default=1.0)
    parser.add_argument("--no_fsd", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve(args.device)

    names, extractors = zip(*(build_extractor(s, device) for s in args.model))
    pca = PCAModel.load(args.pca) if args.pca else None
    ved = None
    if args.clip and args.vsm:
        ved = VideoEditDetector(load_model("clip_vit_l14", args.clip, device),
                                load_model("video_score_ms", args.vsm, device), device=device)
    pipe = QueryPipeline(list(extractors), pca=pca, ved=ved, use_fsd=not args.no_fsd,
                         device=device)
    return extract_queries(decoded_videos(args.videos, args.fps), pipe, list(names),
                           args.out_dir, args.split, args.norm_refs)


if __name__ == "__main__":
    main()
