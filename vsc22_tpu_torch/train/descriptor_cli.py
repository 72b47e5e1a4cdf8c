"""Descriptor-training CLI: one ensemble member trained on a frame store.

Counterpart of `vsc22_tpu/train/descriptor_cli.py`, with the same
argparse surface and log lines, plus `--device` (the card unless the
caller passes `--device cpu`; without a card it raises). The model comes
from an executable config file (`model`: a registry dict, optionally
`data`: dataset kwargs, `img_width`, `preprocess`), built by
`models/registry.build_backbone` at the registry's default dtype (bf16
with f32 masters for the Base models) with weights seeded from `--seed`;
the step's dropout generator is seeded from `--seed` as well. Batches come
from the port's data layer (`data/store.FrameStore`,
`data/datasets.DataLoader`) and go to the device with
`torch.from_numpy(...).to(device)`; metrics are read (`.item()`) only at
`--print_freq`. Every epoch ends with a checkpoint
(`train/checkpoint.CheckpointManager`, the dropout generator's state
included) and `epoch_<e>_ema.npz` in the JAX package's snapshot layout.

Usage:
  python -m vsc22_tpu_torch.train.descriptor_cli --config cfg.py \
      --store frames.rec --work_dir runs/v1 --batch_size 32 --epochs 2 \
      [--device cpu] [model.type=...]

One process and one device: a mesh of one device on the data axis
(multi-GPU training is not ported).
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import torch

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.data.datasets import (
    ConcatDataset,
    DataLoader,
    FramePairDataset,
    LabeledFramePairDataset,
)
from vsc22_tpu_torch.data.store import FrameStore
from vsc22_tpu_torch.models.layers import reset_parameters
from vsc22_tpu_torch.models.registry import build_backbone
from vsc22_tpu_torch.train.checkpoint import CheckpointManager, save_ema_snapshot
from vsc22_tpu_torch.train.contrastive import (
    ContrastiveConfig,
    create_train_state,
    load_masters,
    make_train_step,
)
from vsc22_tpu_torch.utils.config import Config, parse_override_args
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator
from vsc22_tpu_torch.utils.observability import StageTimer, setup_logging

ANN_COLUMNS = ("query_id", "ref_id", "query_start", "query_end", "ref_start", "ref_end")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--store", required=True, action="append",
                   help="frame record store path (repeatable: datasets concatenate)")
    p.add_argument("--work_dir", required=True)
    p.add_argument("--ann_path", default=None, help="matching GT csv (labeled sampler)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--t", type=float, default=0.05)
    p.add_argument("--margin", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--clip_grad_norm", type=float, default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--entropy_weight", type=float, default=30.0)
    p.add_argument("--ici_weight", type=float, default=1.0)
    p.add_argument("--do_ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--do_fgm", action="store_true")
    p.add_argument("--product_loss", action="store_true")
    p.add_argument("--checkpointing", action="store_true", help="activation remat")
    p.add_argument("--print_freq", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless told otherwise (cpu: the plain path)")
    p.add_argument("overrides", nargs="*", default=[])
    return p.parse_args(argv)


def read_annotations(path: str) -> list:
    """The matching GT csv's (query_id, ref_id, query_start, query_end,
    ref_start, ref_end) rows, the spans as floats."""
    with open(path, newline="") as f:
        return [[row[c] if c.endswith("_id") else float(row[c]) for c in ANN_COLUMNS]
                for row in csv.DictReader(f)]


def build_dataset(cfg: Config, args, store: FrameStore):
    data_kwargs = cfg.get("data", Config()).to_dict() if "data" in cfg else {}
    data_kwargs.setdefault("width", cfg.get("img_width", 256))
    data_kwargs.setdefault("preset", cfg.get("preprocess", "vit"))
    if args.ann_path:
        return LabeledFramePairDataset(store, read_annotations(args.ann_path), **data_kwargs)
    return FramePairDataset(store, **data_kwargs)


def main(argv=None):
    tune_host_allocator()
    args = parse_args(argv)
    cfg = Config.fromfile(args.config).merge_flags(parse_override_args(args.overrides))
    logger = setup_logging("descriptor_train", args.work_dir)
    logger.info("config: %s", cfg.to_dict())
    device = resolve(args.device)

    dp = 1  # the data axis: one device
    if args.batch_size % dp:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be divisible by the data-axis "
            f"size {dp} (devices visible to this process)"
        )
    stores = [FrameStore(path) for path in args.store]
    datasets = [build_dataset(cfg, args, store) for store in stores]
    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    loader = DataLoader(
        dataset,
        batch_size=args.batch_size,
        seed=args.seed,
        num_workers=args.num_workers,
    )
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    total_steps = steps_per_epoch * args.epochs

    train_cfg = ContrastiveConfig(
        temperature=args.t,
        margin=args.margin,
        ici_weight=args.ici_weight,
        entropy_weight=args.entropy_weight,
        product_loss=args.product_loss,
        learning_rate=args.lr,
        warmup_ratio=args.warmup_ratio,
        total_steps=total_steps,
        clip_grad_norm=args.clip_grad_norm,
        ema_decay=args.ema_decay if args.do_ema else None,
        fgm_epsilon=0.1 if args.do_fgm else None,
        remat=args.checkpointing,
    )
    model = build_backbone(cfg.model.to_dict(), device=device)
    reset_parameters(model, torch.Generator().manual_seed(args.seed))
    state, tx = create_train_state(model, train_cfg)
    step_fn = make_train_step(model, tx, train_cfg)
    generator = torch.Generator().manual_seed(args.seed)  # dropout and DropPath masks

    ckpt = CheckpointManager(os.path.join(args.work_dir, "checkpoints"))
    start_epoch = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state, generator=generator)
        load_masters(model, state.params)
        start_epoch = state.step // steps_per_epoch
        logger.info("resumed from step %s (epoch %d)", ckpt.latest_step(), start_epoch)

    timer = StageTimer()
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        batches = loader.epoch(epoch)
        b = 0
        while True:
            with timer.stage("data"):
                batch = next(batches, None)
            if batch is None:
                break
            with timer.stage("train_step"):
                images = {k: torch.from_numpy(batch[k]).to(device) for k in ("img_a", "img_b")}
                state, metrics = step_fn(state, images, generator)
            if b % args.print_freq == 0:
                logger.info(
                    "Epoch %d Batch %d Loss %.3f, ICI Loss %.3f, Entropy loss %.3f.",
                    epoch,
                    b,
                    metrics["loss"].item(),
                    metrics["ici_loss"].item(),
                    metrics["entropy_loss"].item(),
                )
            b += 1
        with timer.stage("checkpoint"):
            ckpt.save(state.step, state, generator)
            save_ema_snapshot(os.path.join(args.work_dir, f"epoch_{epoch}_ema.npz"), state, model)
        logger.info("epoch %d done in %.1fs", epoch, time.time() - t0)
    logger.info("timing:\n%s", timer.report())
    return state


if __name__ == "__main__":
    main()
