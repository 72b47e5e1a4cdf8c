"""Reference feature-extraction CLI (the extract_ref_feats.py /
infer_ref.sh entry point).

Counterpart of `vsc22_tpu/pipelines/ref_cli.py`, with the same flags and
`--device` (the card unless it names another). Run once per model, as
infer_ref.sh does. No FSD on references; features are per frame and not
L2-normalized (that happens at fusion). Multi-process runs write one npz
per shard; process 0 merges (after all shards exist) unless `--no_merge`.

Usage:
  python -m vsc22_tpu_torch.pipelines.ref_cli \
      --videos DIR --out outputs/swinv2_v106/train_refs \
      --model swinv2_base_256:ckpt.params.npz:256:vit \
      [--process_index 0 --process_count 1] [--no_merge] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.pipelines.query_cli import decoded_videos, load_model
from vsc22_tpu_torch.pipelines.query_extract import DescriptorExtractor
from vsc22_tpu_torch.pipelines.ref_extract import extract_references, merge_shards
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator

logger = logging.getLogger("ref_cli")


def main(argv=None):
    tune_host_allocator()
    parser = argparse.ArgumentParser()
    parser.add_argument("--videos", required=True)
    parser.add_argument("--out", required=True, help="output prefix (no extension)")
    parser.add_argument(
        "--model", required=True, help="backbone_type:params.npz|-:size:preset"
    )
    parser.add_argument("--fps", type=float, default=1.0)
    parser.add_argument("--process_index", type=int, default=0)
    parser.add_argument("--process_count", type=int, default=1)
    parser.add_argument("--no_merge", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve(args.device)

    backbone, params_path, size, preset = args.model.split(":")
    extractor = DescriptorExtractor(model=load_model(backbone, params_path, device),
                                    size=int(size), preset=preset, device=device)
    videos = [(vid if vid.startswith("R") else f"R{vid}", frames)
              for vid, frames in decoded_videos(args.videos, args.fps)]
    extract_references(
        videos,
        extractor,
        args.out,
        process_index=args.process_index,
        process_count=args.process_count,
        merge=False,
    )
    if args.process_index == 0 and not args.no_merge:
        out = merge_shards(args.out)
        logger.info("merged -> %s", out)
        return out
    return None


if __name__ == "__main__":
    main()
