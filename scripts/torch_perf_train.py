"""Training-step throughput of the PyTorch port on one card (images/s, fwd + bwd).

The port's counterpart of `scripts/perf_train.py`: the contrastive train
step (global-batch InfoNCE + KoLeo entropy, optional FGM second pass, f32
EMA, AdamW on f32 masters) of one production backbone in bf16, seeded
random weights and one fixed batch of seeded noise images: a warm-up step,
then `--steps` timed steps.

  python scripts/torch_perf_train.py --model vit --batch 48 --fgm
  python scripts/torch_perf_train.py --model swin --batch 32 --fgm [--parts]

Prints one JSON line: train_images_per_sec, step_ms, batch_pairs, fgm,
ema, remat, loss (the last step's), peak_mem_gib (peak
`max_memory_allocated` over the timed steps) and the achieved model
TFLOP/s (forward FLOPs by the shapes x 3 x passes per step); with
`--parts`, also `parts_ms`: the step's forward, backward and update run
apart (`phase_ms`). It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16 tensor cores (datasheet)


def vit_forward_flops(cfg, head_dim: int = 2048, out_dim: int = 512) -> int:
    """Multiply-add FLOPs (2 per MAC) of one ViT descriptor image: patch
    embedding, per block QKV, q k^T and P v, proj, fc1 and fc2, the GeM
    projection of every token and the head."""
    c, p = cfg.embed_dim, cfg.num_patches
    l = p + 1
    hidden = int(c * cfg.mlp_ratio)
    block = 2 * l * c * 3 * c + 4 * l * l * c + 2 * l * c * c + 4 * l * c * hidden
    return (2 * p * 3 * cfg.patch_size ** 2 * c + cfg.depth * block
            + 2 * l * c * head_dim + 2 * head_dim * out_dim)


def swin_forward_flops(cfg) -> int:
    """The same for one SwinV2 image: patch embedding, per block QKV, the
    window attention (q k^T and P v over each N-token window), proj and the
    MLP, each patch merge's reduction, and the head (the CPB MLPs, ~0.1%,
    left out)."""
    res = cfg.img_size // cfg.patch_size
    total = 2 * res * res * 3 * cfg.patch_size ** 2 * cfg.embed_dim
    for s, depth in enumerate(cfg.depths):
        c, r = cfg.embed_dim * 2 ** s, res // 2 ** s
        l, n = r * r, min(cfg.window_size, r) ** 2
        hidden = int(c * cfg.mlp_ratio)
        total += depth * (2 * l * c * 3 * c + 4 * l * n * c + 2 * l * c * c + 4 * l * c * hidden)
        if s < len(cfg.depths) - 1:
            total += 2 * (l // 4) * 4 * c * 2 * c
    return total + 2 * cfg.num_features * cfg.output_dim


@dataclasses.dataclass
class TrainBench:
    """One model's train step on a fixed batch, ready to run."""

    name: str
    model: torch.nn.Module
    state: object
    step_fn: object
    batch: dict
    generator: torch.Generator
    passes: int  # forward + backward passes a step (2 with FGM)
    flops_per_step: float
    cfg: object

    @property
    def images_per_step(self) -> int:
        return 2 * self.batch["img_a"].shape[0]

    def step(self) -> dict:
        self.state, metrics = self.step_fn(self.state, self.batch, self.generator)
        return metrics


def setup(model: str = "vit", batch: int = 48, fgm: bool = True, remat: bool = False,
          device="cuda", lr: float = 5e-5, warmup_ratio: float = 0.1,
          total_steps: int = 1000, seed: int = 0) -> TrainBench:
    """Build the model in bf16 on `device` with seeded random weights, the
    train state (f32 masters, EMA on) and one batch of seeded noise; the
    optimizer settings are `scripts/perf_train.py`'s unless given."""
    from vsc22_tpu_torch.core.device import resolve
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.models.swinv2 import SWINV2_BASE_256, swinv2_base_256_descriptor
    from vsc22_tpu_torch.models.vit import VIT_BASE_PATCH32_384, vit_base_patch32_384_descriptor
    from vsc22_tpu_torch.train.contrastive import (
        ContrastiveConfig,
        create_train_state,
        make_train_step,
    )

    dev = resolve(device)
    if model == "vit":
        net = vit_base_patch32_384_descriptor(torch.bfloat16, dev)
        size, flops = 384, vit_forward_flops(VIT_BASE_PATCH32_384)
    elif model == "swin":
        # per-block remat lives in the model, as in the JAX package
        net = swinv2_base_256_descriptor(torch.bfloat16, dev, remat=remat)
        size, flops = 256, swin_forward_flops(SWINV2_BASE_256)
    else:
        raise ValueError(f"unknown model {model!r}")
    reset_parameters(net, torch.Generator().manual_seed(seed))
    cfg = ContrastiveConfig(learning_rate=lr, warmup_ratio=warmup_ratio,
                            total_steps=total_steps, entropy_weight=30.0,
                            fgm_epsilon=0.1 if fgm else None, remat=remat and model == "vit")
    state, tx = create_train_state(net, cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    images = {k: torch.randn((batch, size, size, 3), generator=gen, device=dev)
              for k in ("img_a", "img_b")}
    passes = 2 if fgm else 1
    return TrainBench(model, net, state, make_train_step(net, tx, cfg), images,
                      torch.Generator().manual_seed(seed + 2), passes,
                      float(flops) * 3 * passes * 2 * batch, cfg)


def measure(bench: TrainBench, steps: int) -> dict:
    """`steps` timed steps (host clock, the card synchronised at both
    ends), after which the losses are read; the peak memory over them."""
    dev = bench.batch["img_a"].device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses = [bench.step()["loss"] for _ in range(steps)]
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    step_s = elapsed / steps
    tflops = bench.flops_per_step / step_s / 1e12
    return {
        "model": bench.name,
        "train_images_per_sec": bench.images_per_step / step_s,
        "step_ms": 1e3 * step_s,
        "batch_pairs": bench.images_per_step // 2,
        "fgm": bench.passes == 2,
        "ema": bench.state.ema_params is not None,
        "remat": bool(bench.cfg.remat or getattr(bench.model, "remat", False)),
        "loss": float(losses[-1]),
        "losses": [float(v) for v in losses],
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "model_tflops": tflops,
        "tflops_share_of_bf16_peak": tflops * 1e12 / PEAK_BF16_FLOPS,
    }


def phase_ms(bench: TrainBench, reps: int = 3) -> dict:
    """Median device ms (CUDA events) of a step's parts, run apart on the
    bench's batch: one training forward, the gradients (every forward and
    backward of the step) and the update (optimizer, EMA, the masters
    written back, on a copy of the state); backward = gradients - passes x
    forward. The bench's state and model are left as they were."""
    import copy

    import numpy as np

    from vsc22_tpu_torch.models.layers import DropRng
    from vsc22_tpu_torch.train.contrastive import load_masters

    def timed(fn):
        out = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return float(np.median(out))

    step, b = bench.step_fn, bench.batch
    gen = torch.Generator().manual_seed(0)
    images = torch.cat([b["img_a"], b["img_b"]])
    fwd = timed(lambda: bench.model(images, train=True, rng=DropRng(gen)))
    grads_ms = timed(lambda: step.gradients(b, gen))
    _, grads = step.gradients(b, gen)
    scratch = copy.deepcopy(bench.state)
    upd = timed(lambda: step.update(scratch, grads))
    del scratch, grads
    load_masters(bench.model, bench.state.params)
    return {"forward_ms": fwd, "gradients_ms": grads_ms,
            "backward_ms": grads_ms - bench.passes * fwd, "update_ms": upd}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vit", choices=["vit", "swin"])
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--fgm", action="store_true",
                    help="FGM adversarial second pass (reference v106 default)")
    ap.add_argument("--remat", action="store_true",
                    help="activation checkpointing (reference --checkpointing)")
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--warmup_ratio", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parts", action="store_true",
                    help="also time the step's forward, backward and update apart (CUDA)")
    args = ap.parse_args(argv)
    bench = setup(args.model, args.batch, args.fgm, args.remat, args.device, args.lr,
                  args.warmup_ratio)
    bench.step()  # warm-up (builds the kernels on a first run)
    out = measure(bench, args.steps)
    del out["losses"]
    if args.parts:
        out["parts_ms"] = phase_ms(bench)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
