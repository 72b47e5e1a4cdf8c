#!/usr/bin/env python3
"""Drive the PyTorch port's query, eval, matching, training, offline, legacy-zoo and sharded paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints no
result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of every CUDA kernel from `vsc22_tpu_torch/csrc/`, one
     nvcc per source, all started together, and beside them the g++ build
     of the host library of the alignment methods (`vta_kernels.cpp`);
  2. each kernel against its plain PyTorch version on the card, in float32
     (TF32 off) and bfloat16: K1 and K2 at a full 128-frame chunk of each
     model (ViT-B/32, CLIP ViT-L/14), each naming the loop of its products
     (bf16: the tensor-core loop, which must be taken), with their products
     as cuBLAS calls beside, and K2's LN-rows kernel alone (bit for bit);
     B1 at all four SwinV2-Base stage
     shapes of a 128-frame chunk, shifted and unshifted where the stage has
     both; B6 and B7 at the stage 1 and stage 4 shapes (B7 naming each
     product's loop: bf16 tensor cores, f32 3xTF32 tensor cores; checked,
     with its products as cuBLAS calls beside); B5 at the search's
     shape (a 4096-row query tile against 1.28M refs; f16 on the
     tensor-core route, f32 and f16 D 511 on the FFMA route, each naming
     its route), and K3 at a 4096-row slice of the eval's score-norm shape
     (against 128,000 noise frames, D 511), both with their products as
     chunked cuBLAS calls beside.
     Max error and the share of elements that differ, against the stated
     bounds; median
     kernel, plain and (where one PyTorch call computes the function)
     library times, and the least time the card could take (the bound);
     B8, B9 and B10 at a full 128-frame chunk of each model, f32 and bf16,
     B9 and B10 naming where their LNs are computed and the loop of each
     product (bf16: the tensor-core loop, or the 128x128 FFMA tile where
     the module keeps the plain version's order; checked), with their
     products as cuBLAS calls beside; each attention case names the core it
     took (bf16: tensor cores; f32: FFMA);
  3. the slice end to end: first on a small input (tiny ViT + three tiny
     SwinV2 members on the module path, i.e. B6 and B7), the port on the
     card against the port's plain path on the CPU (same weights, float32);
     then at full width -- ViT-B/32@384 + three SwinV2-Base@256 descriptor
     members, CLIP ViT-L/14 + VSM base VED gate (bf16, random weights from
     a seeded torch.Generator), FSD, PCA(2048 -> 512), query score-norm --
     over 24 synthetic 32-frame 360x640 videos, checking finite 512-d rows,
     that the models ran full 128-frame chunks, and that every kernel's
     launch count grew by what the models' depths require; the pass's stage
     split (every K1 and K2 call on the tensor-core loop, by `routes`) and,
     in one more pass under torch.profiler, its device time by kernel (the
     attention cores named; no launch of the FFMA GEMM tile, one LN-rows
     launch per K2); then K3 against its plain
     version on the operands score-norm gave it in the warm-up pass (its
     bound at the f16 peak: its products are f16 x f16); and the matching
     track's stage 1, the same extractors and PCA without the VED gate,
     one warm pass (`matching_stage1` videos/s); and the pipeline's other
     FSD setting (`use_device_fsd_maps=False`: the exact maps) on the
     letterboxed and the 2-up video: boxes inside the frame, finite rows,
     whether the boxes equal the default's;
  4. the SwinV2 path cross-check: one SwinV2-Base member in float32 on 16
     frames, with the default block dispatch (B1, and B6 + B7 in stage 4)
     and with `fused_block=False` (B6 + B7 everywhere): the L2-normalised
     descriptors agree to 1e-3, and each of the 26 B7 launches took 3xTF32
     for both products;
  5. the descriptor-track eval path at the reference corpus size of
     `scripts/scaled_eval.py` (40,000 ref videos x 32 frames x 512-d on the
     card, 4,000 noise videos, 100 planted copies), on 1,000 query videos:
     score-norm, the exact global budget search of 1200 hits per query
     (B5), the top 25 candidates, TN localization of the top 5 (the host
     library, in the calling process), candidate µAP > 0.95; B5's launches
     cover every 4096-row query
     tile, all on the tensor-core route; for 256 sampled query rows
     `row_topk` on B5 equals the exact per-tile path. Every
     stage's wall time is printed, and the K3 call inside each score-norm,
     and K3 alone on the eval score-norm's own operands ([32000,511] x
     [128000,511]) against its plain version and its chunked f16 products;
  6. the CLIP block variants: the VED gate's CLIP ViT-L/14 at full width
     and depth in the JAX `CLIPBlock`'s three configurations (default K1 +
     K2, `use_half_block` on B9 + K2, `use_block_kernel` on B10): CLS
     features of all three agree to 1e-3 in float32 on 16 frames; in bf16,
     `BatchedVED.scores` over phase 3's 24 videos in each, the scores within
     VED_SCORE_TOL of the default's and the gate decisions alike, with the
     launch counts the depth requires; ms per 128-frame tower chunk of
     each; `MultiHeadAttention` without a bias (B8) against the same module
     with a zero bias (its einsum path) at CLIP's shape;
  7. the matching track (stages 3-6 of `pipelines/matching_infer.py`):
     first full-width MobileNetV3-Small and the tiny SAM in float32 on a
     small corpus with FSD splits, the card against the CPU (the same
     candidates, kept pairs and match rows; probabilities and heatmaps
     within MATCH_PROB_TOL), and SAM HRNet-W18 (s2d numerics off and on,
     2 x 224^2) and MobileNetV3-Small (8 x 160^2) in float32, card against
     CPU; then `bench.py`'s matching protocol at phase 5's corpus: 48 query
     videos against all 40,000 refs, score-norm against the 4,000 noise
     videos at beta 1.5, nk 10 (B5, FFMA route, D 511), 2 x
     MobileNetV3-Small-100 + 2 x SAM HRNet-W18 in bf16, refs normalised
     once, a warm-up, one timed pass (videos/s and the stage split) and
     one more over the first 8 query videos under torch.profiler (the
     device's idle share and its kernels; its wall is not in the rate);
     every planted pair recalled, every
     probability and heatmap finite in [0, 1], every match row inside its
     videos, B5 launched, every model input on the card;
  8. the descriptor track's training step (`vsc22_tpu_torch/train/`): (a)
     the gradients of K1, K2 and B7 at the train step's shapes and of B1,
     B6, B8, B9 and B10 at one phase-2 shape each, bf16, through each
     wrapper's recompute VJP against autograd of its plain version, and B5
     and K3 raising on an operand that requires grad; (b) three f32 steps
     of the tiny ViT and the tiny SwinV2 with FGM and EMA, card against
     CPU (loss, gradients, params and EMA); (c) ViT-B/32@384 at 48 pairs
     and (d) SwinV2-Base@256 at 32 pairs (drop-path 0.2), bf16 with f32
     masters, FGM and EMA (`scripts/torch_perf_train.py`'s bench, lr 1e-4
     without warm-up): a warm-up step, 8 (ViT) or 4 (SwinV2) timed steps
     whose loss must fall,
     the launches per step (K1 and K2 24 each; B7 48 on bf16 tensor cores,
     no B1 or B6), images/s, step ms, peak memory, model TFLOP/s; (e) one
     profiled step of each, device time by family and the idle share;
  9. the matching track's trainers (`train/matching.py`) and alignment
     methods, with cuDNN's TF32 flag on: (a) three f32 steps of
     MobileNetV3-Small (64^2, batch 8, dropout 0) and the tiny SAM (32^2,
     batch 2), card against CPU (first-step gradients, losses, BN buffers,
     params after); (b) MobileNetV3-Small at 160^2, batch 64, dropout 0.2
     and (c) SAM HRNet-W18 at 128^2, batch 8, soft-band labels, both f32 at
     AdamW lr 1e-4, wd 5e-5 on one fixed batch of planted and noise sim
     images: a warm-up step, 8 (MobileNetV3) or 3 (SAM) timed steps
     whose loss must fall, step ms,
     images/s, peak memory and one profiled step's idle share; (d) the
     training CLI (`train/matching_cli.py`) end to end on a planted corpus
     of 6 queries x 2 candidates with both full-width models, its files
     checked, and its four snapshots loaded into the inference CLI
     (`pipelines/matching_cli.py`) and run over the same corpus; (e) native
     TN equal to the Python DAG on phase 5's first 200 eval maps, the
     native DP fill equal to numpy's bit for bit on 5, DTW, DP and HV each
     finding a planted copy, and phase 5's TN wall;
 10. the per-video query path and the offline CLIs
     (`pipelines/query_extract.py`, `query_cli`, `ref_cli`, `ensemble_cli`,
     `clip_features`): (a) which decoders the host has (cv2, ffmpeg, PIL,
     torchvision); (b) OpenCV's cubic resize (360x640 to 384^2, 256^2,
     224x398 and an FSD crop to 384^2), Canny(50, 400) and the float64 FSD
     maps as the port computes them, the card's bits equal to the CPU's;
     (c) the per-video `QueryPipeline` at full width on phase 3's models
     and PCA (bf16), the exact host FSD on the card, over phase 3's first 8
     videos (one letterboxed, one a 2-up stack that FSD splits) + query
     score-norm (nk 1): videos/s, the launches of K1, K2, B1 and K3 against
     the models' depths, and K1, K2 and B1 against their plain versions at
     phase 2's bf16 bar on the operands of a full 48-frame chunk, and the
     pipeline's other FSD setting (`use_device_fsd_maps=True`: the 8-round
     device maps) on the letterboxed and the 2-up video, checked as in
     phase 3; (d) the
     offline flow on phase 3's videos 8-23 as decoded frames: `ref_extract`
     for each member in two shards and the merge, `ensemble_cli` (PCA 2048
     -> 512 on the card, saved; mutual ref score-norm), `query_cli`'s query
     function with that PCA and the train refs as the noise corpus, the
     eval with 4 planted exact copies (candidate µAP; every planted copy
     the VED did not gate ranks its ref first), a `clip_features` zip read
     back; then, where the host has a decoder, `ref_cli` and `query_cli`
     from mp4 files (a tiny member: the decode and the CLIs' plumbing);
 11. the descriptor trainer's CLI (`train/descriptor_cli.py`) in process
     on the port's data layer: a frame store built from JPEGs of 6 of
     phase 3's synthetic videos (192 frames of 360x640; 3 queries, 3 refs,
     a GT csv of 2 planted copies), `configs/vit_v68.py` (ViT-B/32@384,
     bf16 with f32 masters) at 48 pairs with FGM and EMA, lr 1e-4: one
     epoch (4 steps), then `--epochs 2 --resume` (4 more); every logged
     loss finite, the step counter at 8, checkpoints 4 and 8 and both
     epochs' EMA snapshots there, each snapshot loaded into a
     VitDescriptor giving finite unit-norm 512-d rows, K1 and K2 24
     launches a step, every batch on the card; images/s over each run's
     steps after its first beside phase 8(c)'s fixed-batch rate, the CLI's
     stage split (data, train_step, checkpoint) and peak memory;
 12. (run after phase 10, while phase 3's models are alive) the reference's
     checkpoints and the export (`utils/port_weights.py`,
     `utils/export.py`): (a) the ViT-B/32@384 member written as the v68
     checkpoint (timm + SSCD head under `module.backbone.model.`) and its
     backbone as an AugReg npz, a SwinV2-Base@256 member in the official
     keys, CLIP ViT-L/14 as OpenAI's visual tower under `visual.` and the
     VSM as the BERT MS checkpoint under `module.`, each in f32 to a file
     and read back into a fresh module: every tensor bit for bit, and the
     outputs on one full 128-frame chunk (the VSM: two 256-frame clips) bit
     for bit, K1 and K2 (ViT 12, CLIP 24) and B1 (24) launched as the
     depths say; (b) the ViT member exported at a 128-frame bf16 chunk and
     reloaded: 12 K1 and 12 K2 op nodes in the program, as many launches,
     the eager output bit for bit, another batch size refused; export and
     load seconds, eager and exported ms per chunk in turns;
 13. (run after phase 11, on its frame store) the legacy model zoo of the
     JAX registry at its published widths, seeded weights: (a) a forward
     of Swin-T v1@224 (f32), EfficientNetV2-S@256 (bf16) and MAE
     ViT-B/16@224 (bf16) on 32 images each, RoBERTa-base on [16, 128] ids
     with a mask, the DeConv decoder on [4, 8, 8, 2048] and the VSM's `MD`
     head on [8, 256, 1024]: outputs finite and of their shapes, each
     forward's ms, the launches its depth gives (12 K1 and 12 K2 for MAE,
     12 B7 for Swin-T v1, none for the rest), and every K1, K2 and B7 call
     held to its plain version at phase 2's bars, naming its routes, the
     first of each shape timed with its products as cuBLAS calls beside;
     (b) `query_cli` with the three legacy descriptor members (seeded `-`
     weights, efficientnet preset) over 2 of phase 3's videos from mp4
     files, its outputs read back; (c) the descriptor CLI for 2 steps on
     `swin_v1_tiny_224` (f32, 96 pairs, B7 forward and recompute VJP) from
     phase 11's frame store, its EMA snapshot loaded; (d) two BYOL steps on
     MAE-B/16@224 bf16 x 16 pairs (hidden 4096, projection 256): the
     target moves by exactly (1 - 0.99) of its gap, K1 and K2 48 launches
     a step;
 14. the sharded paths (`vsc22_tpu_torch/parallel/`; the host has one
     card, and NCCL puts no two ranks of one communicator on one device):
     (a) in this process, a world of one under NCCL at full width: the
     ViT-B/32 x 48-pair FGM step on the mesh, its gradients and loss bit
     for bit the unsharded step's on phase 8's model and batch, K1 and K2
     24 launches, and one update through the sharded state; the sharded
     row top-128 and global top-30,720 over phase 5's 1.28M refs (f16, B5
     on the shard) for 256 query rows, equal to the one-device searcher's;
     the sharded extractor over one 128-frame chunk, equal to the
     unsharded one; (b) beside (a), two gloo ranks spawned once, sharing
     the card (ViT-B/32 widths at depth 2, f32, 4 pairs; 65,536 refs; 16
     frames): each rank's sharded gradients within phase 8(b)'s bar of
     its one-rank gradients, its search equal, its extractor within 1e-4,
     and K1, K2 and B5 launched on the card in both ranks;
 15. a JSON line of per-kernel numbers (B5's launches: phases 5 and 7;
     `launches_per_video`: phase 10(c); `zoo_launches` and `zoo_cases`:
     phase 13; `parallel_launches`: phase 14(a)), then the device line.

With `--training-only` it runs phases 1, 8, 9 and 11 alone (9(e) then on
synthetic maps of phase 5's shape), with `--zoo-only` phases 1 and 13 (on
videos and a frame store drawn for it), with `--parallel-only` phases 1
and 14 (on a corpus drawn as phase 5's), and prints no result lines.

Needs CUDA (it refuses to run without) and no network; builds in
`vsc22_tpu_torch/_build/`. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F


def synth_videos(n_videos: int, frames: int, h: int, w: int, seed: int = 0):
    """Synthetic corpus with a realistic FSD mix, uint8 (a copy of
    `bench.synth_videos`): ~75% plain, ~12% letterboxed, ~12% 2-stacks."""
    rng = np.random.default_rng(seed)
    vids = []

    def content(fr, hh, ww):
        yy = np.linspace(0, 255, hh, dtype=np.float32)[:, None, None]
        xx = np.linspace(0, 255, ww, dtype=np.float32)[None, :, None]
        base = 0.5 * yy + 0.5 * xx
        return np.clip(
            base[None] + rng.normal(0, 18, (fr, hh, ww, 3)), 0, 255
        ).astype(np.uint8)

    for i in range(n_videos):
        kind = i % 8
        if kind == 6:  # letterboxed: static black bars top/bottom
            inner = content(frames, h - 2 * (h // 6), w)
            vid = np.zeros((frames, h, w, 3), np.uint8)
            vid[:, h // 6 : h // 6 + inner.shape[1]] = inner
        elif kind == 7:  # vertical 2-stack with a static gap
            half = (h - 24) // 2
            a = content(frames, half, w)
            b = content(frames, half, w)
            vid = np.zeros((frames, h, w, 3), np.uint8)
            vid[:, :half] = a
            vid[:, half + 24 : half + 24 + half] = b
        else:
            vid = content(frames, h, w)
        vids.append(vid)
    return vids


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Median device milliseconds of fn() over `reps` timed runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# --- the least time the card could take ------------------------------------

# One NVIDIA H100 SXM at its full 700 W (published datasheet peaks):
# bf16 and f16 dense tensor-core rate (f32 accumulate), float32 rate
# outside the tensor cores (the port's f32 GEMMs run with TF32 off), HBM
# bandwidth. The rate is the card's for the operands' type, whatever
# units a kernel's design uses, except for B7's f32 products on 3xTF32:
# three tf32 products per f32 one, at the dense TF32 rate ("tf32").
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12,
              "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, dtype) -> dict:
    """bound_ms = max(operations / peak rate of their type, bytes / HBM rate):
    each input read once, each output written once."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def work_attn_proj(b, l, c, h, isz):
    """K1: QK^T and PV per head, the projection; x, qkv, W, b in, out."""
    flops = 4 * b * h * l * l * (c // h) + 2 * b * l * c * c
    return flops, (5 * b * l * c + c * c) * isz + 4 * c


def work_attn(b, l, h, hd, isz):
    """B8: QK^T and PV per head; q, k, v in, out."""
    return 4 * b * h * l * l * hd, 4 * b * l * h * hd * isz


def work_ln_attn_proj(b, l, c, h, isz):
    """B9: the QKV product, K1's work; x, weights in, out; LN params and
    biases f32."""
    flops = 8 * b * l * c * c + 4 * b * h * l * l * (c // h)
    return flops, (2 * b * l * c + 4 * c * c) * isz + 4 * 6 * c


def work_vit_block(b, l, c, h, f, isz):
    """B10: QKV, proj, fc1, fc2 and the attention core; x in, out; weights;
    LN params and biases f32."""
    weights = 4 * c * c + 2 * c * f
    flops = 2 * b * l * weights + 4 * b * h * l * l * (c // h)
    return flops, (2 * b * l * c + weights) * isz + 4 * (9 * c + f)


def work_mlp(m, c, hidden, isz, ln=True):
    """K2 / B7: two products; x, W1, W2 in, out (biases, LN params f32)."""
    return 4 * m * c * hidden, (2 * m * c + 2 * c * hidden) * isz + 4 * (hidden + c * (3 if ln else 1))


def work_ln_rows(m, c, isz):
    """K2's LN-rows kernel: ~8 f32/f64 operations per element; x in, LN
    out; scale and bias f32."""
    return 8 * m * c, 2 * m * c * isz + 8 * c


def work_window_attn(w, h, n, hd, nw, isz):
    """B6: q k^T and P v per (window, head); q, k, v in, out; rpb, mask."""
    return 4 * w * h * n * n * hd, 4 * w * h * n * hd * isz + 4 * (h * n * n + nw * n * n + h)


def work_swin_block(w, n, c, h, f, nw, isz):
    """B1: QKV, proj, fc1, fc2 and the attention core; x in, out; weights;
    the f32 vectors, rpb and (shifted blocks) the mask."""
    m = w * n
    weights = 4 * c * c + 2 * c * f
    flops = 2 * m * weights + 4 * w * h * n * n * (c // h)
    mask = nw * n * n if nw > 1 else 0
    return flops, (2 * m * c + weights) * isz + 4 * (9 * c + f + h * n * n + h + mask)


def work_row_max(nq, nr, d):
    """K3: f32 products of f16-rounded rows; queries, refs in, row max out."""
    return 2 * nq * nr * d, 4 * (nq * d + nr * d + nq)


def work_extract_topk(nq, nr, num_valid, d, k, isz):
    """B5: the products over the valid columns; queries and refs in, the
    row top-k (f32 scores, i32 columns) and the f32 bound out."""
    return 2 * nq * num_valid * d, (nq + nr) * d * isz + nq * (8 * k + 4)


# --- phase 2: kernels against their plain versions ------------------------

# float32: elementwise |kernel - plain| <= atol + rtol |plain|. Both sides
# are exact f32 arithmetic; only the summation order differs.
F32_TOL = (1e-4, 1e-4)
ROW_MAX_TOL = (1e-5, 0.0)  # f16 operands, exact f32 products, f32 sums
# bfloat16 outputs: elementwise |kernel - plain| <= BF16_ATOL + 2 ulps of
# |plain|, and at most BF16_MAX_SHARE of the elements may differ at all.
# BF16_ATOL is one bf16 ulp at |y| = 1, the scale of the residual and of the
# block output: where they cancel, one intermediate that rounds the other
# way leaves an absolute error of that scale. The share is what catches a
# misplaced rounding: summation order alone changes well under 1% of the
# outputs, while a rounding step left out or added (LN output,
# probabilities, hidden) changes 30-50% of them.
BF16_ATOL = 2.0**-7
BF16_MAX_SHARE = 0.02
# B1 (the whole SwinV2 block, `block=True`) rounds seven times inside, the
# residual stream x1 among them, and out = x1 + LN2(...): one x1 that rounds
# the other way moves the output by one ulp of |x1|, the scale of the
# block's largest activations. So its atol is one bf16 ulp at max |plain|.
# Its share limit stays 2%: on the card, summation order alone changes
# 0.1-0.4% of B1's outputs at the four SwinV2-Base stage shapes, while each
# single rounding left out or added changes 30-61% of them (a CPU
# simulation at the same widths).


def bf16_ulp(y: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |y| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(y.abs().clamp_min(2.0**-126))) - 7)


def agreement(got: torch.Tensor, want: torch.Tensor, tol, block: bool = False,
              max_share: float = BF16_MAX_SHARE) -> tuple:
    """(ok, max_abs_err, share of elements that differ, the bound in words).
    `block` selects B1's bf16 atol; `max_share` bounds the bf16 share."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    share = float((got != want).float().mean())
    if got.dtype == torch.bfloat16:
        atol = float(bf16_ulp(want.float().abs().max())) if block else BF16_ATOL
        limit = max_share
        ok = bool((diff <= atol + 2 * bf16_ulp(want.float())).all())
        ok = ok and share <= limit
        words = (f"tol atol {atol:g} + 2 bf16 ulps, differing share {share:.4%} "
                 f"(limit {limit:.0%})")
    else:
        ok = bool((diff <= tol[0] + tol[1] * want.float().abs()).all())
        words = f"tol atol {tol[0]:g} rtol {tol[1]:g}, differing share {share:.4%}"
    return ok, err, share, words


def compare(name, kernel_fn, plain_fn, tol=F32_TOL, reps=5, block=False, work=None,
            dtype=torch.float32, library_fn=None, products_fn=None):
    """Hold kernel_fn() against plain_fn() and time both (and library_fn(),
    one PyTorch call computing the same function, where there is one; and
    products_fn(), the kernel's dense products as cuBLAS calls, a yardstick
    for its GEMM loop that computes only part of the function): medians of
    `reps` timed runs (10 until phase 13 needed the time: PERF.md §4)."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"{name}: non-finite kernel output")
    ok, err, share, words = agreement(got, want, tol, block)
    del got, want
    ms = cuda_ms(kernel_fn, reps)
    plain_ms = cuda_ms(plain_fn, reps)
    library_ms = cuda_ms(library_fn, reps) if library_fn is not None else None
    products_ms = cuda_ms(products_fn, reps) if products_fn is not None else None
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               **bound(*work, dtype))
    lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
    if products_ms is not None:
        res["products_cublas_ms"] = products_ms
        lib += f", its products as cuBLAS calls {products_ms:.3f} ms"
    print(f"  {name}: max_abs_err {err:.3e} ({words}) {'ok' if ok else 'FAIL'}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound {res['bound_ms']:.3f} ms "
          f"({res['bound_by']})", flush=True)
    check(ok, f"{name}: kernel disagrees with its plain version (max_abs_err {err}, "
              f"differing share {share})")
    return res


def randn(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen) * std).to(dtype).to(device)


def dname(dt) -> str:
    return "f32" if dt == torch.float32 else "bf16"


# A 128-frame chunk of each model that has pre-LN blocks.
BLOCK_SHAPES = {
    "vit": dict(b=128, l=145, c=768, h=12, hidden=3072, act="gelu", eps=1e-6),
    "clip": dict(b=128, l=257, c=1024, h=16, hidden=4096, act="quick_gelu", eps=1e-5),
}


def core_words(dt, hd) -> str:
    """Which attention core K1, B8, B9 and B10 take at (dtype, hd)."""
    from vsc22_tpu_torch.ops.attn import attn_core

    return f"{attn_core(dt, hd)} attention core"


def k1_routes(x, pw, h) -> tuple:
    """(K1's routes, in words): its attention core and projection loop."""
    from vsc22_tpu_torch.ops.attn_proj import routes

    r = routes(x, pw, h)
    return r, f"{r['core']} attention core, projection {r['proj']}"


def k2_routes(rows, w1, w2) -> tuple:
    """(K2's routes, in words): where its LN is computed, fc1's and fc2's loop."""
    from vsc22_tpu_torch.ops.mlp import routes

    r = routes(rows, w1, w2)
    return r, f"LN {r['ln']}, fc1/fc2 {r['fc1']}/{r['fc2']}"


def check_kernels(device) -> dict:
    """K1 and K2 at the shapes of a full 128-frame chunk of each model; in
    bf16 every product must take the tensor-core loop, and K2's LN-rows
    kernel alone must equal its plain version bit for bit."""
    from vsc22_tpu_torch.ops import attn_proj, mlp

    gen = torch.Generator().manual_seed(0)
    results = {}
    for tag, s in BLOCK_SHAPES.items():
        b, l, c, hidden = s["b"], s["l"], s["c"], s["hidden"]
        for dt in (torch.float32, torch.bfloat16):
            isz = torch.empty((), dtype=dt).element_size()
            bf16 = dt == torch.bfloat16
            # A small residual and peaky softmax, so attention errors show.
            x = randn(gen, (b, l, c), 0.05, dt, device)
            qkv = randn(gen, (b, l, 3 * c), 1.5, dt, device)
            pw = randn(gen, (c, c), c**-0.5, dt, device)
            pb = randn(gen, (c,), 0.1, torch.float32, device)
            r1, words = k1_routes(x, pw, s["h"])
            check(r1["proj"] == ("mma" if bf16 else "ffma"), f"K1 {tag}: projection {r1}")
            attn_rows = randn(gen, (b * l, c), 1.0, dt, device) if bf16 else None
            res = compare(
                f"attn_proj_residual {tag} {dname(dt)} [{b},{l},{c}] h={s['h']} ({words})",
                lambda: attn_proj.attn_proj_residual(x, qkv, pw, pb, s["h"]),
                lambda: attn_proj.attn_proj_residual_reference(x, qkv, pw, pb, s["h"]),
                work=work_attn_proj(b, l, c, s["h"], isz), dtype=dt,
                products_fn=(lambda: torch.mm(attn_rows, pw.t())) if bf16 else None,
            )
            results[("attn_proj_residual", tag, dname(dt))] = dict(res, routes=r1)
            del x, qkv, attn_rows
            rows = randn(gen, (b * l, c), 1.0, dt, device)
            ln_s = 1 + randn(gen, (c,), 0.1, torch.float32, device)
            ln_b = randn(gen, (c,), 0.1, torch.float32, device)
            w1 = randn(gen, (hidden, c), c**-0.5, dt, device)
            b1 = randn(gen, (hidden,), 0.1, torch.float32, device)
            w2 = randn(gen, (c, hidden), hidden**-0.5, dt, device)
            b2 = randn(gen, (c,), 0.1, torch.float32, device)
            args = (rows, ln_s, ln_b, w1, b1, w2, b2, s["act"], s["eps"])
            r2, words = k2_routes(rows, w1, w2)
            want = dict(ln="rows", fc1="mma", fc2="mma") if bf16 else dict(
                ln="prologue", fc1="ffma", fc2="ffma")
            check(r2 == want, f"K2 {tag}: routes {r2}")
            hid = randn(gen, (b * l, hidden), 1.0, dt, device) if bf16 else None
            res = compare(
                f"ln_mlp_residual {tag} {dname(dt)} [{b * l},{c}] hidden={hidden} {s['act']} "
                f"({words})",
                lambda: mlp.ln_mlp_residual(*args),
                lambda: mlp.ln_mlp_residual_reference(*args),
                work=work_mlp(b * l, c, hidden, isz), dtype=dt,
                products_fn=(lambda: (torch.mm(rows, w1.t()), torch.mm(hid, w2.t())))
                if bf16 else None,
            )
            results[("ln_mlp_residual", tag, dname(dt))] = dict(res, routes=r2)
            if bf16:
                ln = compare(
                    f"ln_rows_kernel {tag} bf16 [{b * l},{c}] (K2's LN before fc1, "
                    "bit for bit)",
                    lambda: mlp.layernorm_rows(rows, ln_s, ln_b, s["eps"]),
                    lambda: mlp.ln_rows(rows.float(), ln_s, ln_b, s["eps"]).to(dt),
                    work=work_ln_rows(b * l, c, isz), dtype=torch.float32,
                )
                check(ln["max_abs_err"] == 0.0, f"ln_rows_kernel {tag}: not bit for bit")
                results[("ln_mlp_residual", tag, "bf16")]["ln_rows_ms"] = ln["ms"]
            del rows, w1, w2, hid
            torch.cuda.empty_cache()
    return results


def block_params(gen, c, f, dt, device) -> dict:
    """LN1, qkv, proj, LN2, fc1, fc2 of a pre-LN block (Linear layouts)."""
    vec = lambda n, std: randn(gen, (n,), std, torch.float32, device)
    w = lambda o, i: randn(gen, (o, i), i**-0.5, dt, device)
    return dict(ln1_s=1 + vec(c, 0.1), ln1_b=vec(c, 0.1), qkv_w=w(3 * c, c),
                qkv_b=vec(3 * c, 0.1), proj_w=w(c, c), proj_b=vec(c, 0.05),
                ln2_s=1 + vec(c, 0.1), ln2_b=vec(c, 0.1), fc1_w=w(f, c), fc1_b=vec(f, 0.05),
                fc2_w=w(c, f), fc2_b=vec(c, 0.05))


def block_routes(x, p, h, whole: bool) -> tuple:
    """(B10's routes if `whole`, else B9's, in words): where each LN is
    computed, the attention core and the loop of each product. In bf16 the
    LNs must be LN-rows launches, QKV (and B10's proj) the 128x128 FFMA
    tile in the plain version's order ("ffma128"), the other products the
    tensor-core loop ("mma"); in f32 the 64x64 FFMA tile, LNs in its
    prologue."""
    from vsc22_tpu_torch.ops import attn_proj, vit_block

    bf16 = x.dtype == torch.bfloat16
    ln = "rows" if bf16 else "prologue"
    ordered, mma = ("ffma128", "mma") if bf16 else ("ffma", "ffma")
    if whole:
        r = vit_block.routes(x, p["fc1_w"], p["fc2_w"], h)
        want = dict(ln1=ln, qkv=ordered, proj=ordered, ln2=ln, fc1=mma, fc2=mma)
        names = ("qkv", "proj", "fc1", "fc2")
    else:
        r = attn_proj.routes(x, p["proj_w"], h, half_block=True)
        want = dict(ln=ln, qkv=ordered, proj=mma)
        names = ("qkv", "proj")
    check(all(r[k] == v for k, v in want.items()),
          f"{'B10' if whole else 'B9'}: routes {r}, expected {want}")
    return r, (f"{r['core']} attention core; products {'/'.join(names)} "
               + "/".join(r[k] for k in names))


def block_products(x, p, whole: bool):
    """B9's (QKV, proj) or B10's (QKV, proj, fc1, fc2) products as cuBLAS
    calls (`torch.mm`, no bias) on operands of the kernel's shapes and
    dtype, prepared outside the timed call."""
    rows = x.reshape(-1, x.shape[-1])
    if not whole:
        return lambda: (torch.mm(rows, p["qkv_w"].t()), torch.mm(rows, p["proj_w"].t()))
    hid = torch.randn((rows.shape[0], p["fc1_w"].shape[0]), device=x.device).to(x.dtype)
    return lambda: (torch.mm(rows, p["qkv_w"].t()), torch.mm(rows, p["proj_w"].t()),
                    torch.mm(rows, p["fc1_w"].t()), torch.mm(hid, p["fc2_w"].t()))


def check_block_kernels(device) -> dict:
    """B8, B9 and B10 at the shapes of a full 128-frame chunk of each model
    (B8 there as `MultiHeadAttention` would call it, B9 and B10 as the CLIP
    block variants and a ViT-width block would), f32 and bf16, B9 and B10
    with the loop of each product and (bf16) their products as cuBLAS
    calls. B10's bf16 atol is B1's: its residual x1 is rounded inside the
    block."""
    from vsc22_tpu_torch.ops import attn, attn_proj, vit_block

    gen = torch.Generator().manual_seed(4)
    results = {}
    for tag, s in BLOCK_SHAPES.items():
        b, l, c, h, f = s["b"], s["l"], s["c"], s["h"], s["hidden"]
        hd = c // h
        for dt in (torch.float32, torch.bfloat16):
            isz = torch.empty((), dtype=dt).element_size()
            bf16 = dt == torch.bfloat16
            # q carries the softmax scale, as MultiHeadAttention passes it.
            q = randn(gen, (b, l, h, hd), 1.5 * hd**-0.5, dt, device)
            k, v = (randn(gen, (b, l, h, hd), 1.5, dt, device) for _ in range(2))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            results[("packed_attention", tag, dname(dt))] = compare(
                f"packed_attention {tag} {dname(dt)} [{b},{l},{h},{hd}] ({core_words(dt, hd)})",
                lambda: attn.packed_attention(q, k, v),
                lambda: attn.packed_attention_reference(q, k, v),
                work=work_attn(b, l, h, hd, isz), dtype=dt,
                library_fn=lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0),
            )
            del q, k, v, qt, kt, vt
            x = randn(gen, (b, l, c), 1.0, dt, device)
            p = block_params(gen, c, f, dt, device)
            half = (x, *(p[n] for n in ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w",
                                        "proj_b")), h, s["eps"])
            r9, words = block_routes(x, p, h, whole=False)
            res = compare(
                f"ln_attn_proj_residual {tag} {dname(dt)} [{b},{l},{c}] h={h} ({words})",
                lambda: attn_proj.ln_attn_proj_residual(*half),
                lambda: attn_proj.ln_attn_proj_residual_reference(*half),
                work=work_ln_attn_proj(b, l, c, h, isz), dtype=dt,
                products_fn=block_products(x, p, whole=False) if bf16 else None,
            )
            results[("ln_attn_proj_residual", tag, dname(dt))] = dict(res, routes=r9)
            whole = (x, *p.values(), h, s["act"], s["eps"])
            r10, words = block_routes(x, p, h, whole=True)
            res = compare(
                f"vit_block {tag} {dname(dt)} [{b},{l},{c}] h={h} F={f} {s['act']} ({words})",
                lambda: vit_block.vit_block(*whole),
                lambda: vit_block.vit_block_reference(*whole),
                block=True, work=work_vit_block(b, l, c, h, f, isz), dtype=dt, reps=5,
                products_fn=block_products(x, p, whole=True) if bf16 else None,
            )
            results[("vit_block", tag, dname(dt))] = dict(res, routes=r10)
            del x, p, half, whole
            torch.cuda.empty_cache()
    return results


# One 128-frame chunk of SwinV2-Base@256 per stage: (resolution, window, C, heads).
SWIN_STAGES = {1: (64, 16, 128, 4), 2: (32, 16, 256, 8), 3: (16, 16, 512, 16),
               4: (8, 8, 1024, 32)}


def window_words(dt, n, hd, round_qk=False) -> str:
    """Which window-attention core B6 (or B1's attention, `round_qk`) takes
    at (dtype, N, hd), and how it takes each product."""
    from vsc22_tpu_torch.ops.window_attn import window_core

    if window_core(n, hd) == "ffma":
        return "ffma window core"
    if dt != torch.bfloat16:
        return "mma window core: q̂k̂ 3xTF32, P·V 3xTF32"
    if round_qk:
        return "mma window core: q̂k̂ bf16, P·V FMA chains in key order"
    return "mma window core: qk bf16 on the raw q, k, then the f32 norms, P·V bf16"


def block_words(args, h) -> str:
    """B1's attention core and the loop of each of its four products."""
    from vsc22_tpu_torch.ops.swin_block import routes

    r = routes(*(args[i] for i in (0, 1, 3, 7, 9)), h)
    x = args[0]
    prods = "/".join(r[k] for k in ("qkv", "proj", "fc1", "fc2"))
    return (f"{window_words(x.dtype, x.shape[1], x.shape[2] // h, round_qk=True)}; "
            f"products qkv/proj/fc1/fc2 {prods}")


def products_yardstick(args):
    """B1's four products as cuBLAS calls (`torch.mm`, no bias) on operands
    of B1's shapes and dtype, prepared outside the timed call: x W_qkv^T,
    a W_proj^T, x1 W_fc1^T, hidden W_fc2^T."""
    x, qkv_w, proj_w, fc1_w, fc2_w = (args[i] for i in (0, 1, 3, 7, 9))
    a = x.reshape(-1, x.shape[-1])
    hidden = torch.randn((a.shape[0], fc1_w.shape[0]), device=a.device).to(a.dtype)
    return lambda: (torch.mm(a, qkv_w.t()), torch.mm(a, proj_w.t()), torch.mm(a, fc1_w.t()),
                    torch.mm(hidden, fc2_w.t()))


def window_tables(gen, h, n, mask, device):
    """rpb = 16 sigmoid(N(0, 1)) and scale = exp(N(2, 0.3^2)) (the learned
    logit scale starts at ln 10), f32 on the card, beside the given mask."""
    rpb = (16 * torch.sigmoid(torch.randn((h, n, n), generator=gen))).to(device)
    scale = torch.exp(2 + 0.3 * torch.randn((h,), generator=gen)).to(device)
    return rpb, scale, torch.as_tensor(mask).to(device)


def sdpa_yardstick(q, k, v, rpb, scale, mask, nw):
    """B6's function as one scaled_dot_product_attention call, on inputs
    prepared outside the timed call: q̂ * scale[h], k̂ and the summed bias."""
    w = q.shape[0]
    qs = (F.normalize(q.float(), dim=-1) * scale[:, None, None]).to(q.dtype)
    kn = F.normalize(k.float(), dim=-1).to(q.dtype)
    idx = torch.arange(w, device=q.device) % nw
    bias = (rpb[None] + mask[idx][:, None]).to(q.dtype)
    return lambda: F.scaled_dot_product_attention(qs, kn, v, attn_mask=bias, scale=1.0)


def check_swin_kernels(device) -> dict:
    """B1 at every stage shape of a 128-frame chunk (shifted and unshifted
    where the stage has both); B6 and B7 at the stage 1 and stage 4 shapes."""
    from vsc22_tpu_torch.models.swinv2 import _shift_attn_mask
    from vsc22_tpu_torch.ops import mlp, swin_block, window_attn

    gen = torch.Generator().manual_seed(1)
    results = {}
    frames = 128
    for stage, (res, window, c, h) in SWIN_STAGES.items():
        n, per_item, f, hd = window * window, (res // window) ** 2, 4 * c, c // h
        w = frames * per_item
        for dt in (torch.float32, torch.bfloat16):
            isz = torch.empty((), dtype=dt).element_size()
            for shifted in ((False, True) if per_item > 1 else (False,)):
                nw = per_item if shifted else 1
                mask = (_shift_attn_mask(res, res, window, window // 2) if shifted
                        else np.zeros((1, n, n), np.float32))
                qkv_b = randn(gen, (3 * c,), 0.05, torch.float32, device)
                qkv_b[c : 2 * c] = 0.0  # the zero k bias of the contract
                args = (
                    randn(gen, (w, n, c), 1.0, dt, device),
                    randn(gen, (3 * c, c), c**-0.5, dt, device), qkv_b,
                    randn(gen, (c, c), c**-0.5, dt, device),
                    randn(gen, (c,), 0.05, torch.float32, device),
                    1 + randn(gen, (c,), 0.1, torch.float32, device),
                    randn(gen, (c,), 0.1, torch.float32, device),
                    randn(gen, (f, c), c**-0.5, dt, device),
                    randn(gen, (f,), 0.05, torch.float32, device),
                    randn(gen, (c, f), f**-0.5, dt, device),
                    randn(gen, (c,), 0.05, torch.float32, device),
                    1 + randn(gen, (c,), 0.1, torch.float32, device),
                    randn(gen, (c,), 0.1, torch.float32, device),
                    *window_tables(gen, h, n, mask, device), h, nw,
                )
                case = f"stage{stage}{' shifted' if shifted else ''}"
                results[("swin_block", case, dname(dt))] = compare(
                    f"swin_block {case} {dname(dt)} [{w},{n},{c}] h={h} nW={nw} "
                    f"({block_words(args, h)})",
                    lambda: swin_block.swin_block(*args),
                    lambda: swin_block.swin_block_reference(*args),
                    block=True, work=work_swin_block(w, n, c, h, f, nw, isz), dtype=dt,
                    products_fn=products_yardstick(args) if dt == torch.bfloat16 else None,
                )
                del args
            if stage not in (1, 4):
                continue
            nw = per_item
            mask = (_shift_attn_mask(res, res, window, window // 2) if per_item > 1
                    else np.zeros((1, n, n), np.float32))
            q, k, v = (randn(gen, (w, h, n, hd), 1.0, dt, device) for _ in range(3))
            args = (q, k, v, *window_tables(gen, h, n, mask, device), nw)
            results[("window_attention", f"stage{stage}", dname(dt))] = compare(
                f"window_attention stage{stage} {dname(dt)} [{w},{h},{n},{hd}] nW={nw} "
                f"({window_words(dt, n, hd)})",
                lambda: window_attn.window_attention(*args),
                lambda: window_attn.window_attention_reference(*args),
                work=work_window_attn(w, h, n, hd, nw, isz), dtype=dt,
                library_fn=sdpa_yardstick(*args),
            )
            del q, k, v, args
            results[("fused_mlp", f"stage{stage}", dname(dt))] = check_fused_mlp(
                fused_mlp_args(gen, w * n, c, f, dt, device), f"stage{stage}")
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return results


def fused_mlp_args(gen, rows, c, f, dt, device) -> tuple:
    """B7's x, w1, b1, w2, b2, the biases in the dtype as `layers.Mlp`
    passes them."""
    return (randn(gen, (rows, c), 1.0, dt, device), randn(gen, (f, c), c**-0.5, dt, device),
            randn(gen, (f,), 0.05, dt, device), randn(gen, (c, f), f**-0.5, dt, device),
            randn(gen, (c,), 0.05, dt, device))


def check_fused_mlp(args, case: str) -> dict:
    """B7 against its plain version, naming each product's loop, which at
    the SwinV2-Base shapes must be the tensor-core loop ("mma") in bf16 and
    3xTF32 ("tf32x3") in f32; its products as `torch.mm` calls in the
    operands' type beside. The bound is the route's: on 3xTF32 three tf32
    products per f32 FLOP at the TF32 rate, with the f32 FFMA bound
    beside."""
    from vsc22_tpu_torch.ops import mlp

    x, w1, b1, w2, b2 = args
    dt, (rows, c), f = x.dtype, x.shape, w1.shape[0]
    r = mlp.fused_mlp_routes(x, w1, w2)
    loop = "mma" if dt == torch.bfloat16 else "tf32x3"
    check(r == dict(fc1=loop, fc2=loop), f"B7 {case} {dname(dt)}: routes {r}")
    flops, nbytes = work_mlp(rows, c, f, x.element_size(), ln=False)
    hid = torch.randn((rows, f), device=x.device).to(dt)
    res = compare(
        f"fused_mlp {case} {dname(dt)} [{rows},{c}] hidden={f} (fc1/fc2 {r['fc1']}/{r['fc2']})",
        lambda: mlp.fused_mlp(*args), lambda: mlp.fused_mlp_reference(*args),
        work=(3 * flops, nbytes) if loop == "tf32x3" else (flops, nbytes),
        dtype="tf32" if loop == "tf32x3" else dt,
        products_fn=lambda: (torch.mm(x, w1.t()), torch.mm(hid, w2.t())),
    )
    if loop == "tf32x3":
        res["ffma_bound_ms"] = bound(flops, nbytes, torch.float32)["bound_ms"]
        print(f"    (the f32 FFMA tile's bound: {res['ffma_bound_ms']:.3f} ms)", flush=True)
    return dict(res, routes=r)


# B5 against its plain version: scores and bound within TOPK_TOL (f16
# products are exact in f32, and both sides sum them in f32 in another
# order); per row the same set of columns, except where the plain k-th and
# (k+1)-th scores lie within TOPK_TOL, so a near tie at the cut may go
# either way.
TOPK_TOL = 1e-5


def topk_agreement(got, want) -> tuple:
    """(ok, max_abs_err, rows whose column sets differ) of B5's (scores,
    indices, bound) against the plain version's, the latter run with k + 1."""
    gs, gi, gb = got
    ws, wi, wb = want
    k = gs.shape[1]
    err = max(float((gs - ws[:, :k]).abs().max()), float((gb - wb).abs().max()))
    near_tie = (ws[:, k - 1] - ws[:, k]).abs() <= TOPK_TOL
    same = (gi.sort(dim=1).values == wi[:, :k].sort(dim=1).values).all(dim=1)
    ok = err <= TOPK_TOL and bool((same | near_tie).all())
    return ok, err, int((~same).sum())


def unit_rows(gen, n, d, device):
    x = torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def mm_chunks(q, r, chunk=131_072):
    """The products q r^T as cuBLAS calls in q's type (TF32 off), over
    `chunk`-row slices of r into one reused output: the product part of
    B5 and K3 as a library would compute it, a yardstick for their loop."""
    out = torch.empty((q.shape[0], min(chunk, r.shape[0])), dtype=q.dtype, device=q.device)

    def run():
        for c0 in range(0, r.shape[0], chunk):
            c1 = min(r.shape[0], c0 + chunk)
            torch.mm(q, r[c0:c1].t(), out=out[:, : c1 - c0])
        return out

    return run


def check_topk_kernel(device) -> dict:
    """B5 at the main-path shape: one 4096-row query tile against the
    1.28M-row reference corpus (40,000 videos x 32 frames), 512-d, the
    tail past num_valid masked, e 4 over 1024-column blocks, k 128; in
    f16 (the eval's transfer type: the tensor-core route), f32, and f16 at
    D 511 (both the FFMA route). Each case names its route and times its
    products as chunked cuBLAS calls in its own type beside it."""
    from vsc22_tpu_torch.ops import topk

    gen = torch.Generator(device=device).manual_seed(3)
    nq, nr, nv, e, tile_r, k = 4096, 1_280_000, 1_279_000, 4, 1024, 128
    q32, r32 = unit_rows(gen, nq, 512, device), unit_rows(gen, nr, 512, device)
    results = {}
    for dt, d, reps in ((torch.float16, 512, 5), (torch.float32, 512, 2), (torch.float16, 511, 2)):
        q = q32[:, :d].to(dt).contiguous()
        r = r32[:, :d].to(dt).contiguous()
        kw = dict(e=e, tile_r=tile_r)
        route = topk.topk_route(dt, d, q, r)
        check(route == ("mma" if (dt, d) == (torch.float16, 512) else "ffma"),
              f"extract_topk {dname(dt)} D{d}: route {route}")
        got = topk.extract_topk(q, r, nv, k=k, **kw)
        want = topk.extract_topk_reference(q, r, nv, k=k + 1, **kw)
        torch.cuda.synchronize()
        ok, err, differ = topk_agreement(got, want)
        del got, want
        ms = cuda_ms(lambda: topk.extract_topk(q, r, nv, k=k, **kw), reps)
        plain_ms = cuda_ms(lambda: topk.extract_topk_reference(q, r, nv, k=k, **kw), reps)
        products_ms = cuda_ms(mm_chunks(q, r), reps)
        torch.cuda.empty_cache()
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                   products_cublas_ms=products_ms, loop=route,
                   **bound(*work_extract_topk(nq, nr, nv, d, k, q.element_size()), dt))
        tag = "f16" if dt == torch.float16 else "f32"
        # the FFMA route's own floor: every product an f32 FFMA
        ffma_ms = 1e3 * 2 * nq * nv * d / PEAK_FLOPS[torch.float32]
        print(f"  extract_topk {tag} [{nq},{d}]x[{nr},{d}] num_valid {nv} e={e} tile_r={tile_r} "
              f"k={k}, route {route}: max_abs_err {err:.3e} (tol {TOPK_TOL:g}), {differ} rows "
              f"with another column set (near ties only) {'ok' if ok else 'FAIL'}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, its products as cuBLAS calls "
              f"{products_ms:.3f} ms, bound {res['bound_ms']:.3f} ms ({res['bound_by']}), FFMA "
              f"floor {ffma_ms:.3f} ms", flush=True)
        check(ok, f"extract_topk {tag} D{d}: kernel disagrees with its plain version "
                  f"(max_abs_err {err}, {differ} rows)")
        results[("extract_topk", f"D{d}", tag)] = res
        del q, r
    del q32, r32
    torch.cuda.empty_cache()
    return results


def check_row_max(name, q, r, reps=10) -> dict:
    """K3 against its plain version, with its products as f16 cuBLAS calls
    beside (on f16 copies made outside the timed call) and the bound at the
    f16 peak: its products are f16 x f16, whatever type it is handed."""
    from vsc22_tpu_torch.ops.sim import row_max_gemm, row_max_gemm_reference, row_max_grid

    nq, nr, d = q.shape[0], r.shape[0], q.shape[1]
    tiles, splits = row_max_grid(nq, nr)
    qh, rh = q.half(), r.half()
    res = compare(
        f"row_max_gemm {name} [{nq},{d}]x[{nr},{d}], grid {tiles} query tiles x {splits} ref "
        "splits",
        lambda: row_max_gemm(q, r), lambda: row_max_gemm_reference(q, r), ROW_MAX_TOL,
        reps=reps, work=work_row_max(nq, nr, d), dtype=torch.float16,
        products_fn=mm_chunks(qh, rh))
    del qh, rh
    torch.cuda.empty_cache()
    return res


def check_row_max_kernel(device) -> dict:
    """K3 at a 4096-row slice of the eval's score-norm shape (32,000 query
    frames against the 128,000 noise frames, D 511 after the deleted
    dimension): the plain version's [Nq, Nr] product stays at 2 GB."""
    gen = torch.Generator(device=device).manual_seed(4)
    q, r = unit_rows(gen, 4096, 511, device), unit_rows(gen, 128_000, 511, device)
    res = check_row_max("eval score-norm slice f32", q, r, reps=5)
    del q, r
    torch.cuda.empty_cache()
    return {("row_max_gemm", "eval4096", "f32"): res}


# --- phase 3: the slice ----------------------------------------------------


def build_slice(device, full: bool, seed: int = 0):
    """(pipeline, noise corpus, models) with seeded random weights: the ViT
    member, three SwinV2 members (each with its own weights) and the VED
    gate."""
    from vsc22_tpu_torch.core.types import VideoFeature
    from vsc22_tpu_torch.models import clip, swinv2, vit, vsm
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.ops.pca import pca_fit
    from vsc22_tpu_torch.pipelines.batch_query import (
        BatchedExtractor,
        BatchedQueryPipeline,
        BatchedVED,
    )

    if full:
        vit_m = vit.vit_base_patch32_384_descriptor(torch.bfloat16, device)
        swins = [swinv2.swinv2_base_256_descriptor(torch.bfloat16, device) for _ in range(3)]
        clip_m = clip.clip_vit_l14(torch.bfloat16, device)
        vsm_m = vsm.vsm_base(torch.bfloat16, device)
        vit_size, swin_size, out, max_frames, chunk = 384, 256, 512, 256, 128
    else:
        vit_m = vit.vit_tiny_test_descriptor(torch.float32, device)
        swins = [swinv2.swinv2_tiny_test_descriptor(torch.float32, device) for _ in range(3)]
        clip_m = clip.clip_tiny_test(torch.float32, device)
        vsm_m = vsm.VideoScoreModel(vsm.VSMConfig(feat_dim=32, hidden=32, layers=1, heads=2,
                                                  max_frames=8), torch.float32, device)
        vit_size, swin_size, out, max_frames, chunk = 64, 32, 8, 8, 4
    gen = torch.Generator().manual_seed(seed)
    for m in (vit_m, *swins, clip_m, vsm_m):
        reset_parameters(m, gen)
    extractors = [BatchedExtractor(vit_m, vit_size, "efficientnet", chunk)] + [
        BatchedExtractor(m, swin_size, "vit", chunk) for m in swins
    ]
    feat_dim = sum(e.model.out_dim for e in extractors)
    rng = np.random.default_rng(0)
    pca = pca_fit(rng.standard_normal((2048, feat_dim)).astype(np.float32), out, device)
    pipe = BatchedQueryPipeline(
        extractors,
        pca=pca,
        ved=BatchedVED(clip_m, vsm_m, max_frames, chunk),
        use_fsd=True,
        score_threshold=0.0,
        out_dim=out,
        device=device,
    )
    rng_n = np.random.default_rng(1)
    noise = [
        VideoFeature(
            video_id=f"R{i:06d}", timestamps=np.arange(20, dtype=np.float32),
            feature=rng_n.standard_normal((20, out)).astype(np.float32),
        )
        for i in range(100)
    ]
    return pipe, noise, dict(vit=vit_m, swins=swins, clip=clip_m, vsm=vsm_m)


def prepare_host(device) -> dict:
    """What phases 3 and 5 draw on the host, made while the kernels build
    (none of it launches a kernel): the full-width slice (seeded weights on
    the card, the PCA fit) with its 24 synthetic videos, and the eval
    corpus; each with its seconds."""
    t0 = time.perf_counter()
    pipe, noise, models = build_slice(device, full=True)
    videos = synth_videos(24, 32, 360, 640)
    dev_videos = [torch.from_numpy(v).to(device) for v in videos]
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sizes = EVAL_SIZES
    corpus = make_corpus(sizes["queries"], sizes["refs"], sizes["noise"], sizes["frames"],
                         sizes["dim"], sizes["planted"])
    return dict(slice=(pipe, noise, models, videos, dev_videos), slice_s=slice_s,
                corpus=corpus, corpus_s=time.perf_counter() - t0)


def run_slice(pipe, noise, names, videos, device, dev_videos=None, batch=24):
    from vsc22_tpu_torch.retrieval.score_norm import query_score_normalize

    feats = pipe.process_many(names, videos, batch=batch, device_videos=dev_videos)
    normed = query_score_normalize(
        feats, noise, video_scores=pipe.video_scores, score_threshold=0.0,
        beta=1.2, nk=1, device=device,
    )
    return feats, normed


def zero_counts(wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        for route in getattr(w, "route_launches", {}):
            w.route_launches[route] = 0


def counts(wrappers) -> dict:
    return {w.__name__: w.launches for w in wrappers}


def check_small_slice(device, wrappers) -> None:
    """The port on the card against the port's plain path on the CPU, at
    the tiny configs in float32 with identical weights. The tiny SwinV2
    members take the module path, so B6 and B7 run on the card here."""
    videos = synth_videos(8, 6, 128, 128)
    names = [f"Q{i:06d}" for i in range(len(videos))]
    cpu_pipe, noise, _ = build_slice("cpu", full=False)
    gpu_pipe = copy.deepcopy(cpu_pipe)
    gpu_pipe.device = torch.device(device)
    for m in [e.model for e in gpu_pipe.extractors] + [gpu_pipe.ved.clip_model,
                                                        gpu_pipe.ved.vsm_model]:
        m.to(device)
    want_f, want_n = run_slice(cpu_pipe, noise, names, videos, "cpu", batch=4)
    zero_counts(wrappers)
    got_f, got_n = run_slice(gpu_pipe, noise, names, videos, device, batch=4)
    launches = counts(wrappers)
    err = 0.0
    for w, g, wn, gn in zip(want_f, got_f, want_n, got_n):
        check(w.video_id == g.video_id, "small slice: names differ")
        check(np.array_equal(w.timestamps, g.timestamps),
              f"small slice {w.video_id}: timestamps (FSD boxes or dedup) differ")
        err = max(err, float(np.abs(w.feature - g.feature).max()),
                  float(np.abs(wn.feature - gn.feature).max()))
    score_err = max(abs(cpu_pipe.video_scores[n] - gpu_pipe.video_scores[n]) for n in names)
    print(f"  small slice (tiny configs, f32): card vs CPU plain path: features max_abs_err "
          f"{err:.3e} (tol 1e-3), VED scores {score_err:.3e} (tol 1e-4); launches {launches}",
          flush=True)
    check(err <= 1e-3 and score_err <= 1e-4, "small slice: card and CPU disagree")
    check(launches["window_attention"] > 0 and launches["fused_mlp"] > 0,
          "small slice: the tiny SwinV2 members did not run B6 and B7 on the card")


def record_chunks(module) -> list:
    """The batch size of every later forward call of `module`."""
    sizes = []

    def hook(mod, args):
        sizes.append(int(args[0].shape[0]))

    module.register_forward_pre_hook(hook)
    return sizes


def capture_row_max_operands(run) -> list:
    """run() with score-norm's K3 calls recorded: [(queries, refs), ...]."""
    from vsc22_tpu_torch.retrieval import score_norm

    seen = []
    real = score_norm.row_max_gemm

    def spy(queries, refs):
        seen.append((queries, refs))
        return real(queries, refs)

    score_norm.row_max_gemm = spy
    try:
        run()
    finally:
        score_norm.row_max_gemm = real
    return seen


@contextlib.contextmanager
def spy_routes(targets):
    """Every call of module.name for (module, name, label, routes) in
    `targets`, as (label, width C, routes(*args)), while the block runs."""
    seen = []

    def spy(real, label, routes):
        def call(*args, **kwargs):
            seen.append((label, int(args[0].shape[-1]), routes(*args)))
            return real(*args, **kwargs)
        return call

    saved = [(m, n, getattr(m, n)) for m, n, _, _ in targets]
    for (m, n, label, routes), (_, _, real) in zip(targets, saved):
        setattr(m, n, spy(real, label, routes))
    try:
        yield seen
    finally:
        for m, n, real in saved:
            setattr(m, n, real)


def k1_k2_routes():
    """Every K1 and K2 call the models make, spied on where
    `models/clip.py` and `models/layers.py` make them."""
    from vsc22_tpu_torch.models import clip, layers
    from vsc22_tpu_torch.ops import attn_proj, mlp

    k1 = lambda x, qkv, pw, pb, h: attn_proj.routes(x, pw, h)
    k2 = lambda x, ln_s, ln_b, w1, b1, w2, *rest: mlp.routes(x, w1, w2)
    return spy_routes([(m, n, label, routes) for m in (clip, layers)
                       for n, label, routes in (("attn_proj_residual", "K1", k1),
                                                ("ln_mlp_residual", "K2", k2))])


def stage_split(pipe, run) -> dict:
    """Seconds per pipeline stage over run(), host clock with a device sync
    at both edges of each stage (so the stages do not overlap, as they do
    not in the unsplit pass): VED, FSD, each extractor's model, the shared
    crop-resize, and the rest (dedup, PCA, score-norm, host glue)."""
    times: dict = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    names = ["extract ViT-B/32"] + [f"extract SwinV2 {i + 1}"
                                    for i in range(len(pipe.extractors) - 1)]
    patched = [(pipe.ved, "scores", "VED"), (pipe, "_fsd_boxes", "FSD"),
               (pipe, "_extract", "extract stage")]
    patched += [(e, "extract", n) for e, n in zip(pipe.extractors, names)]
    for obj, attr, name in patched:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for obj, attr, _ in patched:
            delattr(obj, attr)
    models = sum(times[n] for n in names)
    split = {"VED": times["VED"], "FSD": times["FSD"]}
    split.update({n: times[n] for n in names})
    split["crop-resize"] = times["extract stage"] - models
    split["rest"] = total - times["VED"] - times["FSD"] - times["extract stage"]
    split["total"] = total
    return split


def profile_pass(run, kernel_families=None) -> dict:
    """run() under torch.profiler, recording device activity only (host ops
    would make the trace of a pass of many ops several times heavier, and
    only the device events are read): device time by kernel, its share of
    all device time, calls, and the device's idle share of the wall clock
    under the profiler. Returns {family: (seconds, calls)} for
    `kernel_families` (default KERNEL_FAMILIES)."""
    kernel_families = KERNEL_FAMILIES if kernel_families is None else kernel_families
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_s = sum(r[0] for r in rows) / 1e6
    print(f"  profiled pass: wall {wall:.3f} s, device kernel time {device_s:.3f} s, "
          f"device idle {1 - device_s / wall:.1%} of the wall (under the profiler)", flush=True)
    top = sorted(rows, reverse=True)
    # the 15 largest, then the hand kernels' families wherever they rank
    ours = [r for r in top[15:] if any(f in r[2] for f in kernel_families)]
    for us, calls, key in top[:15] + ours:
        print(f"    {us / 1e6:8.3f} s {us / 1e6 / device_s:6.1%} {calls:7d} calls  {key[:110]}",
              flush=True)
    families = {}
    for family, words in kernel_families.items():
        picked = [r for r in rows if family + "<" in r[2] or family + "(" in r[2]
                  or r[2].startswith(family)]
        fam_us = sum(r[0] for r in picked)
        families[family] = (fam_us / 1e6, sum(r[1] for r in picked))
        print(f"    {family} ({words}): {fam_us / 1e3:.3f} ms, "
              f"{fam_us / 1e6 / device_s:.1%} of device time, {families[family][1]} calls",
              flush=True)
    return families


# Kernel names the profiler pass sums by (demangled names start with the
# return type, so the name is matched before its template arguments).
KERNEL_FAMILIES = {
    "gemm_mma_kernel": "K1's projection (so B9's), K2's fc1 and fc2 (so B10's), B1's proj, "
                       "fc1 and fc2 on bf16 tensor cores",
    "ln_rows_kernel": "the LN rows before a bf16 product: K2's, B9's, B10's two",
    "gemm128_bias_kernel": "B1's, B9's and B10's QKV and B10's proj on the 128x128 FFMA tile",
    "gemm_bias_act_kernel": "FFMA GEMM tile: f32 and off-rule products",
    "window_attn_mma_kernel": "window-attention core on tensor cores",
    "window_attn_kernel": "FFMA window-attention core",
    "attn_core_mma_kernel": "bf16 attention core of K1, B8-B10",
    "attn_core_kernel": "FFMA attention core",
    "row_max_mma_kernel": "K3 (score-norm's row max) on f16 tensor cores",
}


# --- phase 4: the SwinV2 block paths ----------------------------------------


def check_swin_paths(device, wrappers) -> dict:
    """One SwinV2-Base member in float32 on a 16-frame chunk, under the
    default block dispatch (B1 in stages 1-3; stage 4 takes the module path
    in f32) and under `fused_block=False` (B6 + B7 in every block), with the
    same weights: the L2-normalised descriptors agree to 1e-3, and every B7
    launch took 3xTF32 for both products, as the rule names at these
    widths. The card counterpart of tests/test_swin_block_fused.py's path
    test."""
    from vsc22_tpu_torch.models import layers
    from vsc22_tpu_torch.models.layers import l2_normalize, reset_parameters
    from vsc22_tpu_torch.models.swinv2 import swinv2_base_256_descriptor
    from vsc22_tpu_torch.ops.mlp import fused_mlp_routes

    fused = swinv2_base_256_descriptor(torch.float32, device)
    reset_parameters(fused, torch.Generator().manual_seed(7))
    module = swinv2_base_256_descriptor(torch.float32, device, fused_block=False)
    module.load_state_dict(fused.state_dict())
    gen = torch.Generator().manual_seed(8)
    images = torch.randn((16, 256, 256, 3), generator=gen).to(device)
    zero_counts(wrappers)
    b7 = lambda x, w1, b1, w2, b2: fused_mlp_routes(x, w1, w2)
    with spy_routes([(layers, "fused_mlp", "B7", b7)]) as calls, torch.inference_mode():
        a = l2_normalize(fused(images))
        b = l2_normalize(module(images))
    torch.cuda.synchronize()
    launches = counts(wrappers)
    off = [(c, r) for _, c, r in calls if r != dict(fc1="tf32x3", fc2="tf32x3")]
    print(f"  B7 calls by route: {len(calls) - len(off)} with fc1/fc2 tf32x3/tf32x3, "
          f"{len(off)} off it {off[:3]}", flush=True)
    err = float((a - b).abs().max())
    print(f"  SwinV2-Base f32, 16 frames: default dispatch vs fused_block=False: "
          f"descriptors max_abs_err {err:.3e} (tol 1e-3); launches {launches} "
          f"(expected B1 22, B6 and B7 2 + 24)", flush=True)
    check(bool(torch.isfinite(a).all()) and a.shape == (16, 512), "path check: bad descriptors")
    check(err <= 1e-3, "path check: the two SwinV2 block paths disagree")
    check(launches["swin_block"] == 22, "path check: B1 launch count")
    check(launches["window_attention"] == 26 and launches["fused_mlp"] == 26,
          "path check: B6/B7 launch counts")
    check(len(calls) == 26 and not off, "path check: a B7 launch off the 3xTF32 route")
    del fused, module, images
    torch.cuda.empty_cache()
    return launches


# --- phase 5: the descriptor-track eval path -----------------------------------

# The reference operating point of `scripts/scaled_eval.py` (10k query
# videos x 40k ref videos x 32 frames, 512-d, 4k noise videos, 100 planted
# copies), cut to 1,000 query videos, so that the host-side TN localization
# of 5 pairs per query fits the time limit. Until the per-video phase came, a
# second pass timed the search alone at a larger query count (10,000, then
# 5,000 with the matching phase, 2,000 with the training phase: `PERF.md`
# §4).
EVAL_SIZES = dict(queries=1_000, refs=40_000, noise=4_000, frames=32, dim=512, planted=100)


def make_corpus(n_queries, n_refs, n_noise, frames, dim, planted=100, seed=0):
    """The planted-copy corpus of `scripts/scaled_eval.make_corpus`, as the
    port's VideoFeatures: unit random frames; query i < planted carries
    frames 10-19 of ref i, lightly noised, at its frames 5-14. Returns
    (queries, refs, noise, gt). Each corpus is one draw, which gives the
    same values as the script's draw per video from the same seed."""
    from vsc22_tpu_torch.core.types import VideoFeature

    rng = np.random.default_rng(seed)

    def mk(prefix, count, start=0):
        f = rng.standard_normal((count * frames, dim), dtype=np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        return [VideoFeature(video_id=f"{prefix}{start + i:06d}",
                             timestamps=np.arange(frames, dtype=np.float32),
                             feature=f[i * frames : (i + 1) * frames])
                for i in range(count)]

    refs = mk("R", n_refs)
    queries = mk("Q", n_queries)
    noise = mk("R", n_noise, start=n_refs)  # ids disjoint from the evaluated refs
    planted = min(planted, n_queries, n_refs)
    gt = []
    span = min(10, frames - 5)
    for i in range(planted):
        q, r = queries[i], refs[i]
        q.feature[5 : 5 + span] = r.feature[10 : 10 + span] + rng.normal(
            0, 0.05, (span, dim)).astype(np.float32)
        q.feature /= np.linalg.norm(q.feature, axis=1, keepdims=True)
        gt.append((q.video_id, r.video_id, 5.0, 5.0 + span, 10.0, 10.0 + span))
    return queries, refs, noise, gt


@contextlib.contextmanager
def call_times(targets):
    """Seconds spent inside each (owner, attribute, name) method while the
    block runs, summed over calls, with a device sync at both edges of
    every call (nested calls count in both)."""
    times: dict = {}
    saved = []
    for owner, attr, name in targets:
        fn = getattr(owner, attr)  # bound, where owner is a class

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[_name] = times.get(_name, 0.0) + time.perf_counter() - t0
            return out

        saved.append((owner, attr, vars(owner)[attr]))
        setattr(owner, attr, wrapper)
    try:
        yield times
    finally:
        for owner, attr, raw in saved:
            setattr(owner, attr, raw)


def search_split(search_fn) -> tuple:
    """(search_fn(), its split): the searcher's row_topk (B5 + rescans +
    transfers), within it the exact per-tile rescans and the torch fast
    scan (deeper rounds, where B5's rule fails), global_topk's host
    selection, the index build (ref packing and upload), and the per-pair
    aggregation (with the query packing)."""
    from vsc22_tpu_torch.retrieval import index, search

    targets = [(search.SimilaritySearcher, "row_topk", "row_topk"),
               (search, "_row_topk_exact", "exact rescans"),
               (search, "_row_topk_fast", "torch fast scan"),
               (search.SimilaritySearcher, "global_topk", "global_topk"),
               (index.VideoIndex, "_ensure_built", "index build"),
               (index.VideoIndex, "search_max_aggregated", "search_max_aggregated")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with call_times(targets) as t:
        out = search_fn()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    split = {
        "row_topk": t.get("row_topk", 0.0),
        "of it exact rescans": t.get("exact rescans", 0.0),
        "of it torch fast scan": t.get("torch fast scan", 0.0),
        "global selection": t.get("global_topk", 0.0) - t.get("row_topk", 0.0),
        "index build": t.get("index build", 0.0),
        "per-pair aggregation": (t.get("search_max_aggregated", 0.0) - t.get("global_topk", 0.0)
                                 - t.get("index build", 0.0)),
        "rest": total - t.get("search_max_aggregated", 0.0),
    }
    print("    split: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()), flush=True)
    return out, split


def timed_stage(stages: dict, name: str, fn):
    """fn() on the host clock, with a device sync at both edges."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stages[name] = time.perf_counter() - t0
    print(f"  {name}: {stages[name]:.3f} s", flush=True)
    return out


def check_b5_against_exact(sn_queries, sn_refs, device, rows=256, k=128) -> None:
    """For `rows` sampled query rows, `row_topk` (on B5) against the exact
    per-tile path on the card, on the same f16 corpus: the same top-k sets
    (near ties at the cut aside) and scores within TOPK_TOL. Rows that fail
    B5's certificate come back from the exact path inside `row_topk`, so at
    most a quarter of them may, or the check would hold the exact path
    against itself."""
    from vsc22_tpu_torch.ops.topk import extract_topk
    from vsc22_tpu_torch.retrieval import search
    from vsc22_tpu_torch.retrieval.packed import PackedFeatures

    packed = PackedFeatures.from_video_features(sn_refs)
    searcher = search.SimilaritySearcher(packed.features[: packed.num_rows], device=device,
                                         transfer_dtype=np.float16)
    all_q = np.concatenate([q.feature for q in sn_queries])
    pick = np.sort(np.random.default_rng(5).choice(len(all_q), rows, replace=False))
    before = extract_topk.launches
    exact = search._row_topk_exact
    rescanned = []
    search._row_topk_exact = lambda q, *a: rescanned.append(q.shape[0]) or exact(q, *a)
    try:
        s, i = searcher.row_topk(all_q[pick], k)
    finally:
        search._row_topk_exact = exact
    check(extract_topk.launches == before + 1, "cross-check: row_topk did not run B5")
    es, ei = exact(searcher._to_device(all_q[pick]), searcher.refs, searcher.num_refs, k + 1,
                   searcher.ref_tile)
    zero = torch.zeros(rows)
    ok, err, differ = topk_agreement(
        (torch.from_numpy(s), torch.from_numpy(i).long(), zero), (es.cpu(), ei.cpu(), zero))
    print(f"  cross-check, {rows} sampled query rows, k={k}: row_topk on B5 vs the exact "
          f"per-tile path on the card: max_abs_err {err:.3e} (tol {TOPK_TOL:g}), {differ} rows "
          f"with another column set (near ties only) {'ok' if ok else 'FAIL'}; "
          f"{sum(rescanned)} of {rows} rows failed B5's certificate and were rescanned "
          f"(limit {rows // 4})", flush=True)
    check(ok, "cross-check: row_topk on B5 disagrees with the exact path")
    check(sum(rescanned) <= rows // 4,
          f"cross-check: {sum(rescanned)} of {rows} rows came from the exact rescan, not B5")
    del searcher, packed
    torch.cuda.empty_cache()


def run_eval(device, wrappers, card: str, corpus, corpus_s: float) -> dict:
    """The descriptor-track eval path as `scripts/scaled_eval.py` runs it:
    score-norm (beta 1.2, nk 1), the global budget search of 1200 hits per
    query (f16 transfer), the top 25 candidates per query, TN localization
    of the top 5 (score-normalised, in this process: the host library
    aligns the 5,000 pairs in ~1 s, a pool of 8 workers took ~10 s to
    start on the card's host), candidate µAP on the
    planted copies. Then the B5 cross-check, on `corpus` (`make_corpus`'s,
    drawn in `corpus_s` seconds). Returns (the launches of the eval path, the corpus (queries,
    refs, noise) for phase 7, and phase 9's TN maps and the TN wall)."""
    from vsc22_tpu_torch.align.vta import BaseVtaModel
    from vsc22_tpu_torch.core.metrics import average_precision
    from vsc22_tpu_torch.core.types import CandidatePair
    from vsc22_tpu_torch.ops.topk import extract_topk
    from vsc22_tpu_torch.pipelines.descriptor_eval import localize_and_verify, search
    from vsc22_tpu_torch.retrieval import score_norm
    from vsc22_tpu_torch.retrieval.score_norm import (
        _min_variance_dim,
        query_score_normalize,
        ref_score_normalize,
    )
    from vsc22_tpu_torch.retrieval.search import QUERY_TILE  # one B5 launch per tile

    sizes = EVAL_SIZES
    stages: dict = {}
    queries, refs, noise, gt = corpus
    stages["corpus_gen"] = corpus_s
    print(f"  corpus_gen: {corpus_s:.3f} s (drawn on the host while the kernels built)",
          flush=True)
    n_eval, eval_q = len(queries), queries
    print(f"  corpus: {len(queries)} query x {len(refs)} ref videos of {sizes['frames']} "
          f"frames, {sizes['dim']}-d, {len(noise)} noise videos, {len(gt)} planted",
          flush=True)
    gt_pairs = [CandidatePair(query_id=q, ref_id=r, score=1.0) for q, r, *_ in gt]
    low_var = _min_variance_dim(noise)

    k3 = [(score_norm, "row_max_gemm", "K3")]  # the call inside each score-norm
    zero_counts(wrappers)
    with call_times(k3) as k3_times:
        sn_q, sn_refs = timed_stage(stages, "score_norm", lambda: (
            query_score_normalize(eval_q, noise, low_var_dim=low_var, beta=1.2, nk=1,
                                  device=device),
            ref_score_normalize(refs, noise, beta=1.2, nk=1)))
    print(f"    split: K3 (one call, {sum(len(q.feature) for q in eval_q)} x "
          f"{sum(len(n.feature) for n in noise)} rows, synchronised at both "
          f"edges) {k3_times['K3']:.3f} s", flush=True)
    candidates, _ = timed_stage(stages, "search_1200_per_query", lambda: search_split(
        lambda: search(sn_q, sn_refs, transfer_dtype=np.float16, device=device)))
    b5_search = extract_topk.launches
    check(extract_topk.route_launches == {"mma": b5_search, "ffma": 0},
          f"eval: B5 launches by route {extract_topk.route_launches}, not all on the "
          "tensor-core route")
    with call_times([(BaseVtaModel, "forward_sim", "alignment")]) as tn_times:
        matches = timed_stage(stages, "tn_localization", lambda: localize_and_verify(
            sn_q, sn_refs, candidates, score_normalization=True))
    print(f"    split: TN alignment (native, in this process) {tn_times['alignment']:.3f} s, "
          f"the rest (maps, matches) {stages['tn_localization'] - tn_times['alignment']:.3f} s",
          flush=True)
    ap = timed_stage(stages, "metrics", lambda: average_precision(gt_pairs, candidates)).ap
    launches = counts(wrappers)
    # Phase 9's TN check: the maps the alignment got for the first candidates.
    q_feats = {q.video_id: q.feature for q in sn_q}
    r_feats = {r.video_id: r.feature for r in sn_refs}
    tn_maps = [np.matmul(q_feats[c.query_id], r_feats[c.ref_id].T) + 0.5
               for c in candidates[:TN_MAPS]]
    # K3 alone on the operands of that score-norm, with its products as
    # chunked f16 cuBLAS calls beside.
    q_rows, n_rows = (np.concatenate([f.feature for f in score_norm._prepare(v, low_var, True)])
                      for v in (eval_q, noise))
    check_row_max("eval score-norm f32 (the eval's own operands)",
                  torch.from_numpy(q_rows).to(device), torch.from_numpy(n_rows).to(device), reps=3)
    del q_rows, n_rows
    torch.cuda.empty_cache()

    q_rows = sum(len(q.feature) for q in sn_q)
    tiles = -(-q_rows // QUERY_TILE)
    located = {(m.query_id, m.ref_id) for m in matches} & {(p.query_id, p.ref_id)
                                                           for p in gt_pairs}
    print(f"  eval path ({n_eval} x {len(refs)} videos, {q_rows} x "
          f"{sum(len(r.feature) for r in sn_refs)} rows): {len(candidates)} candidates, "
          f"{len(matches)} matches ({len(located)} of {len(gt)} planted pairs localized), "
          f"candidate µAP {ap:.4f} (bar 0.95); launches {launches} (B5 >= {tiles}, the "
          f"4096-row query tiles of the first row_topk; all on the tensor-core route)",
          flush=True)
    check(0 < len(candidates) <= 25 * n_eval, f"eval: {len(candidates)} candidates")
    check(all(np.isfinite(c.score) for c in candidates), "eval: non-finite candidate scores")
    check(ap > 0.95, f"eval: candidate µAP {ap:.4f} <= 0.95 on the planted copies")
    check(b5_search >= tiles, f"eval: B5 launched {b5_search} times, fewer than the {tiles} "
                              "query tiles of the first row_topk")

    check_b5_against_exact(sn_q, sn_refs, device)

    print(f"  stage walls on {card}: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()),
          flush=True)
    return launches, (queries, refs, noise), (tn_maps, stages["tn_localization"])


# --- phase 6: the CLIP block variants ------------------------------------------

CLIP_PATHS = ("default", "half_block", "block_kernel")
# The largest |score difference| of a bf16 block variant's VED scores from
# the default path's, over phase 3's 24 videos: ten times the spread that
# 1-ulp flips of the residual stream through 24 layers give (PERF.md). A
# gate decision may differ only for a score within this distance of the
# threshold.
VED_SCORE_TOL = 0.02


def set_clip_path(model, path: str) -> None:
    """Switch every block of a CLIPVisual to one of the JAX `CLIPBlock`'s
    three configurations (plain attributes, read at each call)."""
    for block in model.blocks:
        block.use_half_block = path == "half_block"
        block.use_block_kernel = path == "block_kernel"


def check_clip_paths(device, wrappers, ved, dev_videos, card: str) -> dict:
    """The VED gate's CLIP tower on each block path; returns the launches of
    B8 (the MultiHeadAttention check), B9 (the half-block VED run) and B10
    (the block-kernel VED run)."""
    from vsc22_tpu_torch.models.clip import clip_vit_l14
    from vsc22_tpu_torch.models.layers import MultiHeadAttention, reset_parameters
    from vsc22_tpu_torch.pipelines.query_extract import SCORE_THRESHOLD

    layers, size = len(ved.clip_model.blocks), ved.clip_model.cfg.img_size
    # float32 on 16 frames: CLS features of the three paths, same weights.
    model = clip_vit_l14(torch.float32, device)
    reset_parameters(model, torch.Generator().manual_seed(9))
    width = model.cfg.width
    images = torch.randn((16, size, size, 3), generator=torch.Generator().manual_seed(10))
    images = images.to(device)
    cls = {}
    with torch.inference_mode():
        for path in CLIP_PATHS:
            set_clip_path(model, path)
            cls[path] = model(images)[:, 0]
    torch.cuda.synchronize()
    errs = {path: float((cls[path] - cls["default"]).abs().max()) for path in CLIP_PATHS[1:]}
    ok = all(bool(torch.isfinite(c).all()) and c.shape == (16, width) for c in cls.values())
    print(f"  CLIP ViT-L/14 f32, 16 frames: CLS features vs the default path: "
          + ", ".join(f"{k} max_abs_err {v:.3e}" for k, v in errs.items()) + " (tol 1e-3)",
          flush=True)
    check(ok and max(errs.values()) <= 1e-3, "CLIP paths: f32 CLS features disagree")
    del model, images, cls
    torch.cuda.empty_cache()

    # bf16: the VED gate over phase 3's videos on each path.
    chunks = record_chunks(ved.clip_model)
    scores, launches, chunk_ms = {}, {}, {}
    frames = torch.randn((128, size, size, 3), generator=torch.Generator().manual_seed(11))
    frames = frames.to(device)
    for path in CLIP_PATHS:
        set_clip_path(ved.clip_model, path)
        with torch.inference_mode():
            ved.scores(dev_videos)  # warm-up
            chunks.clear()
            zero_counts(wrappers)
            scores[path] = ved.scores(dev_videos)
            torch.cuda.synchronize()
            launches[path] = counts(wrappers)
            n_chunks = len(chunks)
            chunk_ms[path] = cuda_ms(lambda: ved.clip_model(frames), reps=3)
    set_clip_path(ved.clip_model, "default")
    depth = layers * n_chunks
    b9_b10 = max(abs(a - b) for a, b in zip(scores["half_block"], scores["block_kernel"]))
    print(f"  VED bf16: max |score difference| half_block vs block_kernel {b9_b10:.3e}",
          flush=True)
    for path in CLIP_PATHS:
        gated = [sc < SCORE_THRESHOLD for sc in scores[path]]
        diff = max(abs(a - b) for a, b in zip(scores[path], scores["default"]))
        print(f"  VED bf16 on {path}: {len(dev_videos)} videos, {n_chunks} CLIP chunks, "
              f"{chunk_ms[path]:.3f} ms per 128-frame tower chunk on {card}; scores "
              f"{min(scores[path]):.4f}..{max(scores[path]):.4f}, max |diff| vs default "
              f"{diff:.3e} (bound {VED_SCORE_TOL}); gated below {SCORE_THRESHOLD}: "
              f"{sum(gated)} of {len(gated)}; launches {launches[path]}", flush=True)
        check(all(np.isfinite(scores[path])), f"VED {path}: non-finite scores")
        check(diff <= VED_SCORE_TOL, f"VED {path}: scores {diff} from the default path's")
        for a, b in zip(scores[path], scores["default"]):
            check((a < SCORE_THRESHOLD) == (b < SCORE_THRESHOLD)
                  or abs(b - SCORE_THRESHOLD) <= VED_SCORE_TOL,
                  f"VED {path}: a gate decision flipped away from the threshold")
    check(launches["default"]["attn_proj_residual"] == depth
          and launches["default"]["ln_mlp_residual"] == depth, "VED default: K1/K2 launches")
    check(launches["half_block"]["ln_attn_proj_residual"] == depth
          and launches["half_block"]["ln_mlp_residual"] == depth
          and launches["half_block"]["attn_proj_residual"] == 0, "VED half block: B9/K2 launches")
    check(launches["block_kernel"]["vit_block"] == depth
          and launches["block_kernel"]["ln_mlp_residual"] == 0, "VED block kernel: B10 launches")
    del frames

    # B8 through MultiHeadAttention at CLIP's shape, against its einsum path.
    mha = MultiHeadAttention(1024, 16, torch.bfloat16, device=device)
    reset_parameters(mha, torch.Generator().manual_seed(12))
    x = torch.randn((128, 257, 1024), generator=torch.Generator().manual_seed(13))
    x = x.to(torch.bfloat16).to(device)
    zero_bias = torch.zeros((1, 1, 1, 257), device=device)
    with torch.inference_mode():
        zero_counts(wrappers)
        got = mha(x)
        torch.cuda.synchronize()
        b8 = counts(wrappers)["packed_attention"]
        want = mha(x, zero_bias)
    torch.cuda.synchronize()
    ok, err, share, words = agreement(got, want, F32_TOL)
    print(f"  MultiHeadAttention bf16 [128,257,1024] h=16: no bias (B8, {b8} launch) vs a zero "
          f"bias (einsum path): max_abs_err {err:.3e} ({words}) {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok and b8 == 1, "MultiHeadAttention: B8 path disagrees with the einsum path")
    del mha, x, got, want
    torch.cuda.empty_cache()
    return {"packed_attention": b8,
            "ln_attn_proj_residual": launches["half_block"]["ln_attn_proj_residual"],
            "vit_block": launches["block_kernel"]["vit_block"]}


# --- phase 7: the matching track -------------------------------------------------

# bench.py's matching protocol (`measure_matching`, bench.py:185-306) at the
# reference corpus of phase 5: 48 query videos (0-23 carry planted copies of
# refs 0-23, 100-123 none) against all 40,000 ref videos, score-norm against
# the 4,000 noise videos (beta 1.5, nk 10: B5 over 128,000 rows), 2 x
# MobileNetV3-Small-100 and 2 x SAM HRNet-W18 (s2d numerics) in bf16 with
# seeded random weights, at most 25 candidates per query, the top 5% of
# them by classify probability refined.
MATCH_QUERIES = tuple(range(24)) + tuple(range(100, 124))
MATCH_PLANTED = 24
MATCH_STAGES = ("score_norm", "recall", "pack_descriptors", "classify_simmats",
                "classify_predict", "refine", "decode")
# float32 card vs CPU: cuDNN's convolution algorithms (Winograd among them)
# sum in other orders than the CPU's, through up to ~100 layers.
MATCH_TIMED_PASSES = 1  # unprofiled; three until phase 10 needed the time (PERF.md §4)
# The pass profiled for the idle share alone: the first MATCH_PROFILED query
# videos (all 48 until phase 11 needed the time, its trace taking ~14 s to
# read; 8 until phase 13 did: PERF.md §4).
MATCH_PROFILED = 4
MATCH_PROB_TOL = 1e-4  # probabilities and heatmaps
MATCH_SCORE_TOL = 1e-3  # match-row scores: max - std * ratio of heatmap values
MATCH_RECALL_TOL = 2e-5  # recall scores: f32 products of unit vectors


def stage_timer():
    """`matching_inference`'s timer: host seconds per stage, summed over
    calls, with a device sync at both edges of each stage."""
    from vsc22_tpu_torch.utils.observability import StageTimer

    return StageTimer(sync=torch.cuda.synchronize)


@contextlib.contextmanager
def matching_spy():
    """What `matching_inference` hands between its stages while the block
    runs: the recall lists, the classify probabilities (device path) and
    the refined heatmaps (device path), one entry per call."""
    from vsc22_tpu_torch.pipelines import matching_infer as mi

    seen = {"candidates": [], "probs": [], "refined": []}
    saved = (mi.recall_candidates, mi.ClassifyEnsemble.predict_device,
             mi.RefineEnsemble.predict_device)

    def recall(*args, **kwargs):
        seen["candidates"].append(saved[0](*args, **kwargs))
        return seen["candidates"][-1]

    def classify(self, chunks):
        seen["probs"].append(saved[1](self, chunks))
        return seen["probs"][-1]

    def refine(self, builder, pairs):
        seen["refined"].append(saved[2](self, builder, pairs))
        return seen["refined"][-1]

    mi.recall_candidates = recall
    mi.ClassifyEnsemble.predict_device, mi.RefineEnsemble.predict_device = classify, refine
    try:
        yield seen
    finally:
        mi.recall_candidates = saved[0]
        mi.ClassifyEnsemble.predict_device, mi.RefineEnsemble.predict_device = saved[1:]


def lively_weights(model, gen) -> None:
    """Seeded random weights under which a random CNN's output depends on
    its input (under `reset_parameters` alone a random MobileNetV3's
    features shrink to ~1e-6): BN scales U(1, 2), running variances
    U(0.5, 1.5), BN biases, running means and Linear biases N(0, 0.02^2),
    as `tests/test_torch_matching_models.py` draws the JAX variables."""
    from vsc22_tpu_torch.models.layers import BatchNorm, Linear, reset_parameters

    reset_parameters(model, gen)
    small = lambda t: torch.randn(t.shape, generator=gen) * 0.02
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 1.0)
                m.var.copy_(torch.rand(m.var.shape, generator=gen) + 0.5)
                m.bias.copy_(small(m.bias))
                m.mean.copy_(small(m.mean))
            elif isinstance(m, Linear) and m.bias is not None:
                m.bias.copy_(small(m.bias))


@torch.no_grad()
def calibrate_head(model, weight, bias, sample, std: float = 2.0, mean: float = 0.0) -> None:
    """Rescale and shift a 2-class head so that over `sample` (on the CPU)
    the logit difference has mean `mean` and std `std`: varied,
    unsaturated probabilities."""
    out = model(sample)
    diff = out[..., 1] - out[..., 0]
    scale = std / max(float(diff.std()), 1e-6)
    weight.mul_(scale)
    bias.mul_(scale)
    bias[1] -= scale * float(diff.mean()) - mean


@torch.no_grad()
def sim_reading_sam(model) -> None:
    """Tiny-SAM weights whose class-1 logit is 12 relu(sim - 0.6) - 3, as
    `tests/test_torch_matching_cli.py` sets them: stem channel 0 passes the
    centre tap through an identity BN, fuse1 channel 0 reads it with bias
    -0.6, fuse2 scales it; every other weight zero. Its heatmaps light up
    the planted copies' diagonals, so the decode has lines to find."""
    from vsc22_tpu_torch.models.layers import BatchNorm

    for p in model.parameters():
        p.zero_()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.mean.zero_()
            m.var.fill_(1.0)
    model.backbone.stem1.conv.weight[0, 0, 1, 1] = 1.0
    model.backbone.stem1.bn.var.fill_(1.0 - 1e-5)
    model.fuse1_weight[0, 0] = 1.0
    model.fuse1_bias[0] = -0.6
    model.fuse2_weight[1, 0] = 12.0
    model.fuse2_bias[1] = -3.0


def sim_like_images(rng, n, res, lo, hi):
    """n [res, res, 3] float32 images: an h x w block of N(0, 0.25^2)
    values (h, w in [lo, hi)) in the corner, zeros around, as padded sim
    matrices look."""
    x = np.zeros((n, res, res, 3), np.float32)
    for i in range(n):
        h, w = rng.integers(lo, hi, 2)
        x[i, :h, :w] = rng.normal(0, 0.25, (h, w, 1))
    return torch.from_numpy(x)


def small_matching_corpus():
    """6 query videos (32-d) with FSD splits (Q1 two segments of 24, Q2
    three of 16 with a partial last, Q4 two of 18) and planted copies in
    Q0, Q1's second segment and Q2's first, against 10 ref videos."""
    from vsc22_tpu_torch.core.types import VideoFeature

    rng = np.random.default_rng(11)

    def unit(n):
        x = rng.standard_normal((n, 32)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    def video(vid, f):
        return VideoFeature(video_id=vid, timestamps=np.arange(len(f), dtype=np.float32),
                            feature=f)

    refs = [unit(24 + 4 * i) for i in range(10)]
    qs = [unit(n) for n in (30, 48, 40, 20, 36, 28)]
    qs[0][6:18] = refs[0][2:14]
    qs[1][30:42] = refs[1][5:17]
    qs[2][3:13] = refs[2][8:18]
    nf = {"Q000000": 30, "Q000001": 24, "Q000002": 16, "Q000003": 20, "Q000004": 18,
          "Q000005": 28}
    return ([video(f"Q{i:06d}", f) for i, f in enumerate(qs)],
            [video(f"R{i:06d}", f) for i, f in enumerate(refs)], nf)


def check_small_matching(device) -> None:
    """Stages 3-6 with full-width MobileNetV3-Small and the tiny SAM in
    float32 (TF32 off) on the card against the same weights on the CPU:
    the same candidates, the same kept pairs, probabilities and heatmaps
    within MATCH_PROB_TOL, the same match rows (scores within
    MATCH_SCORE_TOL), every kept planted pair matched. The second SAM fold
    reads the sim image (`sim_reading_sam`), so there are rows to compare."""
    from vsc22_tpu_torch.models.hrnet import sam_hrnet_tiny_test
    from vsc22_tpu_torch.models.mobilenetv3 import mobilenetv3_small
    from vsc22_tpu_torch.pipelines.matching_infer import (
        ClassifyEnsemble,
        RefineEnsemble,
        matching_inference,
    )

    queries, refs, nf = small_matching_corpus()
    gen, rng = torch.Generator().manual_seed(12), np.random.default_rng(12)
    cls_models = []
    for _ in range(2):
        m = mobilenetv3_small(device="cpu")
        lively_weights(m, gen)
        calibrate_head(m, m.classifier.weight, m.classifier.bias,
                       sim_like_images(rng, 8, 160, 16, 48))
        cls_models.append(m)
    sam = sam_hrnet_tiny_test()
    lively_weights(sam, gen)
    # low and narrow (p ~ 0.12 +- 0.05), so the merged maps keep the reader's lines
    calibrate_head(sam, sam.fuse2_weight, sam.fuse2_bias, sim_like_images(rng, 2, 64, 16, 48),
                   std=0.5, mean=-2.0)
    reader = sam_hrnet_tiny_test()
    sim_reading_sam(reader)
    runs = {}
    for dev in ("cpu", device):
        classify = ClassifyEnsemble([copy.deepcopy(m).to(dev) for m in cls_models], batch=16,
                                    device=dev)
        refine = RefineEnsemble([copy.deepcopy(m).to(dev) for m in (sam, reader)], batch=4,
                                device=dev)
        with matching_spy() as seen:
            rows = matching_inference(queries, refs, queries, refs, nf, classify, refine,
                                      cls_threshold=0.0, cls_keep_fraction=0.5,
                                      max_candidates=16, device=dev)
        runs[dev] = (rows, seen)
    (want, ws), (got, gs) = runs["cpu"], runs[device]
    wc, gc = ws["candidates"][0], gs["candidates"][0]
    check([c[:2] for c in gc] == [c[:2] for c in wc], "small matching: candidates differ")
    recall_err = max(abs(a[2] - b[2]) for a, b in zip(gc, wc))
    prob_err = max(float(np.abs(g - w).max()) for g, w in zip(gs["probs"][0], ws["probs"][0]))
    gk, wk = gs["refined"][0], ws["refined"][0]
    check([k[:2] for k in gk] == [k[:2] for k in wk], "small matching: kept pairs differ")
    heat_err = max(float(np.abs(g[2] - w[2]).max()) for g, w in zip(gk, wk))
    want_score = {tuple(r[:6]): r[6] for r in want}
    same_rows = sorted(tuple(r[:6]) for r in got) == sorted(want_score)
    score_err = max((abs(r[6] - want_score[tuple(r[:6])]) for r in got), default=0.0) \
        if same_rows else float("inf")
    kept_planted = {("Q000000", "R000000"), ("Q000001", "R000001"),
                    ("Q000002", "R000002")} & {k[:2] for k in gk}
    found = kept_planted & {(r[0], r[1]) for r in got}
    print(f"  small check (full-width MobileNetV3-Small + tiny SAM, f32, TF32 off), card vs "
          f"CPU: {len(gc)} candidates (scores {recall_err:.3e}, tol {MATCH_RECALL_TOL:g}), "
          f"{len(gk)} kept pairs, probabilities {prob_err:.3e} and heatmaps {heat_err:.3e} "
          f"(tol {MATCH_PROB_TOL:g}), {len(got)} match rows {'the same' if same_rows else 'DIFFER'}"
          f" (scores {score_err:.3e}, tol {MATCH_SCORE_TOL:g}); {len(kept_planted)} of 3 planted "
          f"pairs kept, {len(found)} of them matched", flush=True)
    check(recall_err <= MATCH_RECALL_TOL, "small matching: recall scores differ")
    check(prob_err <= MATCH_PROB_TOL and heat_err <= MATCH_PROB_TOL,
          "small matching: probabilities or heatmaps differ")
    check(same_rows and score_err <= MATCH_SCORE_TOL and found == kept_planted,
          "small matching: match rows differ, or a kept planted copy was not matched")


def check_full_width_f32(device) -> None:
    """SAM HRNet-W18 (s2d numerics off and on) on 2 images at 224^2 and
    MobileNetV3-Small on 8 at 160^2, float32 (TF32 off), the card against
    the CPU on the same weights: probabilities within MATCH_PROB_TOL."""
    from vsc22_tpu_torch.models.hrnet import sam_hrnet_w18
    from vsc22_tpu_torch.models.mobilenetv3 import mobilenetv3_small

    gen, rng = torch.Generator().manual_seed(13), np.random.default_rng(13)
    cases = []
    x = sim_like_images(rng, 2, 224, 24, 224)
    sam = sam_hrnet_w18(torch.float32, device="cpu")
    lively_weights(sam, gen)
    calibrate_head(sam, sam.fuse2_weight, sam.fuse2_bias, x)
    for s2d in (False, True):
        m = sam_hrnet_w18(torch.float32, s2d=s2d, device="cpu")
        m.load_state_dict(sam.state_dict())
        cases.append((f"SAM HRNet-W18 s2d={'on' if s2d else 'off'} [2, 224, 224]", m, x))
    mnv3 = mobilenetv3_small(device="cpu")
    lively_weights(mnv3, gen)
    x = sim_like_images(rng, 8, 160, 16, 160)
    calibrate_head(mnv3, mnv3.classifier.weight, mnv3.classifier.bias, x)
    cases.append(("MobileNetV3-Small [8, 160, 160]", mnv3, x))
    for name, model, x in cases:
        with torch.no_grad():
            want = torch.softmax(model(x), dim=-1)[..., 1]
            got = torch.softmax(model.to(device)(x.to(device)), dim=-1)[..., 1].cpu()
        err = float((got - want).abs().max())
        print(f"  full-width f32 cross-check, {name}: card vs CPU probabilities max_abs_err "
              f"{err:.3e} (tol {MATCH_PROB_TOL:g}; spread {float(want.std()):.3f})", flush=True)
        check(err <= MATCH_PROB_TOL, f"full-width f32 cross-check: {name} disagrees")
        model.cpu()


def check_b5_matching(q, r, k: int = 16) -> None:
    """B5 alone at the matching score-norm's shape, on its own operands
    (the query rows and the noise corpus, f32, D 511: the FFMA route), as
    `SimilaritySearcher.row_topk` calls it (nk 10 padded to k 16): against
    its plain version (TOPK_TOL, the same column sets near ties aside),
    with its products as chunked f32 cuBLAS calls and the bound beside.
    These launches are not counted as the main path's."""
    from vsc22_tpu_torch.ops import topk
    from vsc22_tpu_torch.retrieval.search import B5_E, B5_TILE_R

    (nq, d), nr = q.shape, r.shape[0]
    kw = dict(e=B5_E, tile_r=B5_TILE_R)
    route = topk.topk_route(q.dtype, d, q, r)
    got = topk.extract_topk(q, r, nr, k=k, **kw)
    want = topk.extract_topk_reference(q, r, nr, k=k + 1, **kw)
    torch.cuda.synchronize()
    ok, err, differ = topk_agreement(got, want)
    del got, want
    with topk.no_tf32():
        ms = cuda_ms(lambda: topk.extract_topk(q, r, nr, k=k, **kw), 5)
        plain_ms = cuda_ms(lambda: topk.extract_topk_reference(q, r, nr, k=k, **kw), 3)
        products_ms = cuda_ms(mm_chunks(q, r), 5)
    b = bound(*work_extract_topk(nq, nr, nr, d, k, q.element_size()), q.dtype)
    print(f"  extract_topk matching score-norm f32 [{nq},{d}]x[{nr},{d}] e={B5_E} "
          f"tile_r={B5_TILE_R} k={k} (route {route}): max_abs_err {err:.3e} (tol {TOPK_TOL:g}), "
          f"{differ} rows with another column set {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, its products as cuBLAS calls {products_ms:.3f} ms, bound "
          f"{b['bound_ms']:.3f} ms ({b['bound_by']})", flush=True)
    check(ok, "B5 at the matching score-norm's shape disagrees with its plain version")


def run_matching(device, wrappers, card: str, corpus, stage1_vps: float) -> int:
    """Phase 7 (see MATCH_QUERIES): the small check, the full-width f32
    cross-check, then the matching track at the reference corpus: refs
    score-normalised once, a warm-up and MATCH_TIMED_PASSES timed passes of
    query score-norm + `matching_inference`, then one more over the first
    MATCH_PROFILED queries under the profiler for the device's idle share
    alone. Returns B5's launches."""
    from vsc22_tpu_torch.models.hrnet import sam_hrnet_w18
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.models.mobilenetv3 import mobilenetv3_small
    from vsc22_tpu_torch.ops.topk import extract_topk
    from vsc22_tpu_torch.pipelines.matching_infer import (
        ClassifyEnsemble,
        RefineEnsemble,
        matching_inference,
    )
    from vsc22_tpu_torch.pipelines.query_extract import calculate_low_var_dim
    from vsc22_tpu_torch.retrieval.score_norm import (
        _prepare,
        query_score_normalize,
        ref_score_normalize,
    )

    t0 = time.perf_counter()
    check_small_matching(device)
    t1 = time.perf_counter()
    check_full_width_f32(device)
    print(f"  small check {t1 - t0:.1f} s, full-width f32 cross-check "
          f"{time.perf_counter() - t1:.1f} s (their CPU sides included)", flush=True)

    t_setup = time.perf_counter()
    queries, refs, noise = corpus
    q48 = [queries[i] for i in MATCH_QUERIES]
    qlen = {v.video_id: len(v) for v in q48}
    ref_len = {v.video_id: len(v) for v in refs}
    gen = torch.Generator().manual_seed(7)
    cls_models = [mobilenetv3_small(dtype=torch.bfloat16, device=device) for _ in range(2)]
    sams = [sam_hrnet_w18(torch.bfloat16, s2d=True, device=device) for _ in range(2)]
    seen_devices = set()
    for m in cls_models + sams:
        reset_parameters(m, gen)
        m.register_forward_pre_hook(lambda mod, args: seen_devices.add(args[0].device.type))
    classify = ClassifyEnsemble(cls_models, device=device)
    refine = RefineEnsemble(sams, device=device)
    print(f"  set-up of the bf16 models {time.perf_counter() - t_setup:.1f} s", flush=True)
    print(f"  corpus: {len(q48)} query videos (planted copies in {MATCH_PLANTED}) x "
          f"{len(refs)} ref videos ({sum(len(r) for r in refs)} rows), noise "
          f"{sum(len(n) for n in noise)} rows; 2 x MobileNetV3-Small-100 + 2 x SAM "
          "HRNet-W18 (s2d), bf16, seeded random weights; max_candidates "
          f"{25 * len(q48)}, cls_keep_fraction 0.05", flush=True)

    low_var = calculate_low_var_dim(noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sn_refs = ref_score_normalize(refs, noise, beta=1.5, nk=10)
    ref_norm_s = time.perf_counter() - t0
    print(f"  ref_score_normalize (beta 1.5, nk 10), once for the corpus: {ref_norm_s:.3f} s "
          "(host: the min-variance dim out, L2, a column of ones; no search). bench.py's "
          "run() redoes its 480 refs every pass; here the 40,000 refs are normalised once "
          "and the passes below exclude it", flush=True)

    def one_pass(timer, queries):
        with timer.stage("score_norm"):
            sn_q = query_score_normalize(queries, noise, low_var_dim=low_var, beta=1.5, nk=10,
                                         device=device)
        return matching_inference(queries, refs, sn_q, sn_refs, qlen, classify, refine,
                                  cls_keep_fraction=0.05, max_candidates=25 * len(queries),
                                  timer=timer, device=device)

    def timed_pass(timer, queries=q48):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = one_pass(timer, queries)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    zero_counts(wrappers)
    walls, splits = [], []
    with matching_spy() as seen:
        for i in range(MATCH_TIMED_PASSES + 1):
            timer = stage_timer()
            rows, wall = timed_pass(timer)
            print(f"  {'warm-up' if i == 0 else f'pass {i}'}: {wall:.3f} s, "
                  f"{len(q48) / wall:.3f} videos/s, {len(rows)} match rows; "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in timer.as_dict().items()), flush=True)
            if i:
                walls.append(wall)
                splits.append(timer.as_dict())
        print(f"  one more pass, over the first {MATCH_PROFILED} query videos, under "
              "torch.profiler, for the device's idle share alone (device activity only; the "
              "trace is processed after its clock stops):", flush=True)
        out, timer = [], stage_timer()
        t0 = time.perf_counter()
        profile_pass(lambda: out.append(timed_pass(timer, q48[:MATCH_PROFILED])),
                     {"extract_topk_kernel": "B5"})
        (_, wall), = out
        print(f"  (the profiled pass: {wall:.3f} s under the profiler, not in the rate below; "
              f"with its trace {time.perf_counter() - t0:.1f} s)", flush=True)
    b5 = extract_topk.launches
    routes = dict(extract_topk.route_launches)
    launches = counts(wrappers)
    q_rows, n_rows = (np.concatenate([f.feature for f in _prepare(v, low_var, True)])
                      for v in (q48, noise))
    check_b5_matching(torch.from_numpy(q_rows).to(device), torch.from_numpy(n_rows).to(device))
    del q_rows, n_rows

    rates = [len(q48) / w for w in walls]
    median = float(np.median(rates))
    mean_split = {k: float(np.mean([s.get(k, 0.0) for s in splits])) for k in MATCH_STAGES}
    print(f"  matching_stages2_6 on {card}: median {median:.3f} videos/s over {len(rates)} "
          f"unprofiled timed pass(es) ({', '.join(f'{r:.3f}' for r in rates)}); per pass (mean of "
          f"{len(rates)}, synchronised at "
          "each stage edge): " + ", ".join(f"{k} {v:.3f} s" for k, v in mean_split.items())
          + f", rest {np.mean(walls) - sum(mean_split.values()):.3f} s", flush=True)
    print(f"  matching_stage1 {stage1_vps:.3f} videos/s (phase 3); combined serial "
          f"{1.0 / (1.0 / stage1_vps + 1.0 / median):.3f} videos/s", flush=True)
    print(f"  launches {launches}; B5 {b5} in phase 7 by route {routes} (query score-norm, "
          "nk 10 over the 128,000 noise rows, D 511, f32; ref score-norm runs no search)",
          flush=True)

    n_cand = [len(c) for c in seen["candidates"]]
    pass_queries = [len(q48)] * (MATCH_TIMED_PASSES + 1) + [MATCH_PROFILED]
    check(len(n_cand) == len(pass_queries), f"matching: {len(n_cand)} candidate lists")
    for n, cands in zip(pass_queries, seen["candidates"]):
        # the planted copies are the first MATCH_PLANTED query videos
        planted = {(f"Q{i:06d}", f"R{i:06d}") for i in range(min(n, MATCH_PLANTED))}
        missing = planted - {(q, r) for q, r, _ in cands}
        check(not missing,
              f"matching: planted pairs not among the candidates: {sorted(missing)[:4]}")
    for po, pt in seen["probs"]:
        check(all(bool(np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all())
                  for p in (po, pt)), "matching: a classify probability outside [0, 1]")
    n_maps = 0
    for refined in seen["refined"]:
        for _, _, heat, _ in refined:
            check(bool(np.isfinite(heat).all() and (heat >= 0).all() and (heat <= 1).all()),
                  "matching: a heatmap value outside [0, 1]")
            n_maps += 1
    for qid, rid, qs, qe, rs, re, score in rows:
        check(0 <= qs <= qe < qlen[qid] and 0 <= rs <= re < ref_len[rid] and np.isfinite(score),
              f"matching: a malformed match row {[qid, rid, qs, qe, rs, re, score]}")
    print(f"  checks: candidates per pass {n_cand} (every planted pair of the pass's queries "
          f"in each: {MATCH_PLANTED} of {len(q48)}, {min(MATCH_PROFILED, MATCH_PLANTED)} of "
          f"{MATCH_PROFILED}), {n_maps} heatmaps and all probabilities finite in [0, 1], "
          f"{len(rows)} match rows of the last pass well formed; model inputs on "
          f"{sorted(seen_devices)}", flush=True)
    check(b5 > 0 and sum(routes.values()) == b5, f"matching: B5 launches {b5}, routes {routes}")
    check(seen_devices == {"cuda"} and classify.device.type == refine.device.type == "cuda",
          f"matching: a model ran on {seen_devices}")
    check(all("pack_descriptors" in s for s in splits),
          "matching: the sim images were not built on the card")
    return b5


# --- main -------------------------------------------------------------------

# --- phase 8: training on the card -------------------------------------------------

# Card against CPU, the tiny train steps in float32: the bars of
# tests/test_torch_train.py (the port against JAX on the CPU). Gradients
# within TRAIN_GRAD_TOL of each leaf's max |g|; loss relative
# TRAIN_LOSS_TOL; params and EMA after three steps at lr 1e-3 within
# TRAIN_PARAM_ATOL but for TRAIN_PARAM_MAX_SHARE of the elements, all
# within TRAIN_PARAM_WORST. Left out: the elements whose first-step CPU
# gradient is at most TRAIN_ROUNDING_GRAD of the step's largest |g| (zero
# but for rounding, as the ViT's k bias: Adam's m / (sqrt(v) + 1e-6) turns
# such a residue into a step of up to lr / (4 eps) = 250 times it).
TRAIN_GRAD_TOL = 1e-4
TRAIN_LOSS_TOL = 1e-5
TRAIN_PARAM_ATOL = 1e-6
TRAIN_PARAM_MAX_SHARE = 1e-3
TRAIN_PARAM_WORST = 1e-5
TRAIN_ROUNDING_GRAD = 1e-6
SWIN_TIMED_STEPS = 4  # 8(d); 8 until phase 11 needed the time (PERF.md §4)
# Kernel names of the train step's profiled families.
TRAIN_HAND_KERNELS = ("gemm_mma_kernel", "ln_rows_kernel", "gemm_bias_act_kernel",
                      "gemm128_bias_kernel", "gemm_tf32x3_kernel", "attn_core_mma_kernel",
                      "attn_core_kernel", "window_attn_mma_kernel", "window_attn_kernel")
TRAIN_CUBLAS_WORDS = ("gemm", "xmma", "cutlass", "cublas", "splitK", "gemv")
TRAIN_OPTIMIZER_WORDS = ("multi_tensor_apply", "foreach")


def grad_check(name, wrapper, plain, args, static, block: bool = False, reps: int = 1,
               plain_out=None) -> None:
    """Forward and backward of `wrapper` (the kernel, its recompute VJP) and
    of `plain` under autograd, on the same inputs and cotangent. The
    wrapper's output (the kernel's) against the plain version's by phase
    2's bar (`block` as there; `plain_out`, where given, is the plain
    version that rounds as the kernel does, where the recompute's rounds as
    the JAX oracle: B10's q scale off a power of two); its grad_fn and the
    kernel's launch; every
    floating input's gradient, f32 within TRAIN_GRAD_TOL of its max |g|,
    bf16 by phase 2's bar (the backward is autograd of the plain version
    on the saved inputs, so this checks the VJP's wiring: argument order,
    the non-tensor arguments, dtypes); the times of both (forward +
    backward)."""
    gen = torch.Generator().manual_seed(0)

    def run(fn, want_grad_fn):
        ins = [a.detach().clone().requires_grad_() for a in args]
        out = fn(*ins, *static)
        check(out.grad_fn is not None or not want_grad_fn, f"{name}: no grad_fn on the card")
        out.backward(cot)
        return out.detach(), [t.grad for t in ins]

    launches = wrapper.launches
    want_out = (plain_out or plain)(*args, *static)
    cot = torch.randn(want_out.shape, generator=gen).to(want_out.dtype).to(want_out.device)
    out, got = run(wrapper, True)
    check(wrapper.launches > launches, f"{name}: the kernel did not launch")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
    ok, out_err, _, out_words = agreement(out, want_out, F32_TOL, block)
    check(ok, f"{name}: the kernel's output disagrees with its plain version (max_abs_err "
              f"{out_err}, {out_words})")
    del out, want_out
    _, want = run(plain, False)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g is not None and g.dtype == w.dtype and bool(torch.isfinite(g).all()),
              f"{name}: input {i} has no finite gradient")
        if g.dtype == torch.bfloat16:
            ok, err, share, words = agreement(g, w, F32_TOL)
            rel = err / max(float(w.float().abs().max()), 1e-30)
        else:
            err = float((g - w).abs().max())
            rel = err / max(float(w.abs().max()), 1e-30)
            ok = rel <= TRAIN_GRAD_TOL
        check(ok, f"{name}: input {i}'s gradient through the kernel disagrees "
                  f"(max_abs_err {err}, {rel:.3e} of max |g|)")
        worst = max(worst, rel)
    del got, want
    ms = cuda_ms(lambda: run(wrapper, True), reps)
    plain_ms = cuda_ms(lambda: run(plain, False), reps)
    print(f"  {name}: output max_abs_err {out_err:.3e} ({out_words}); {len(args)} input "
          f"gradients through the recompute VJP = autograd of the plain version (worst "
          f"{worst:.3e} of max |g|); forward + backward {ms:.3f} ms (kernel forward) vs "
          f"{plain_ms:.3f} ms (plain)", flush=True)


def check_kernel_grads(device) -> None:
    """8(a): K1, K2 and B7 at the train step's shapes (ViT-B/32 at 48
    pairs, SwinV2-Base stages 1 and 4 at 32 pairs), B1, B6, B8, B9 and
    B10 at one phase-2 shape each, all bf16; B5 and K3 refuse an operand
    that requires grad."""
    from vsc22_tpu_torch.ops import attn, attn_proj, mlp, sim, swin_block, topk, vit_block
    from vsc22_tpu_torch.ops import window_attn

    gen = torch.Generator().manual_seed(81)
    bf = torch.bfloat16
    r = lambda shape, std=1.0, dt=bf: randn(gen, shape, std, dt, device)
    f32v = lambda n, std=0.05: randn(gen, (n,), std, torch.float32, device)
    b, l, c, h, hid = 96, 145, 768, 12, 3072
    grad_check("K1 attn_proj_residual bf16 [96,145,768] h12 (ViT-B/32 train)",
               attn_proj.attn_proj_residual, attn_proj.attn_proj_residual_reference,
               [r((b, l, c)), r((b, l, 3 * c)), r((c, c), c**-0.5), f32v(c)], (h,))
    grad_check("K2 ln_mlp_residual bf16 [13920,768]x3072 (ViT-B/32 train)",
               mlp.ln_mlp_residual, mlp.ln_mlp_residual_reference,
               [r((b * l, c)), 1 + f32v(c, 0.1), f32v(c, 0.1), r((hid, c), c**-0.5), f32v(hid),
                r((c, hid), hid**-0.5), f32v(c)], ("gelu", 1e-6))
    for stage, (rows, cc) in {1: (262144, 128), 4: (4096, 1024)}.items():
        grad_check(f"B7 fused_mlp bf16 [{rows},{cc}]x{4 * cc} (SwinV2-Base stage {stage} train)",
                   mlp.fused_mlp, mlp.fused_mlp_reference,
                   [r((rows, cc)), r((4 * cc, cc), cc**-0.5), f32v(4 * cc).to(bf),
                    r((cc, 4 * cc), (4 * cc) ** -0.5), f32v(cc).to(bf)], ())
    p = block_params(gen, c, hid, bf, device)
    x = r((128, l, c))
    half = [x, p["ln1_s"], p["ln1_b"], p["qkv_w"], p["qkv_b"], p["proj_w"], p["proj_b"]]
    grad_check("B9 ln_attn_proj_residual bf16 [128,145,768] h12", attn_proj.ln_attn_proj_residual,
               attn_proj.ln_attn_proj_residual_reference, half, (h, 1e-6))
    grad_check("B10 vit_block bf16 [128,145,768] h12 F 3072", vit_block.vit_block,
               vit_block.vit_block_reference,
               half + [p["ln2_s"], p["ln2_b"], p["fc1_w"], p["fc1_b"], p["fc2_w"], p["fc2_b"]],
               (h, "gelu", 1e-6), block=True)
    grad_check("B8 packed_attention bf16 [128,257,16,64]", attn.packed_attention,
               attn.packed_attention_reference, [r((128, 257, 16, 64), 0.125), r((128, 257, 16, 64)),
                                                 r((128, 257, 16, 64))], ())
    _, win, cs, hs = SWIN_STAGES[4]
    n = win * win
    rpb, scale, mask = window_tables(gen, hs, n, np.zeros((1, n, n), np.float32), device)
    grad_check("B6 window_attention bf16 [128,32,64,32] (stage 4)", window_attn.window_attention,
               window_attn.window_attention_reference,
               [r((128, hs, n, cs // hs)) for _ in range(3)] + [rpb, scale, mask], (1,))
    sp = block_params(gen, cs, 4 * cs, bf, device)
    qkv_b = sp["qkv_b"].clone()
    qkv_b[cs:2 * cs] = 0.0
    grad_check("B1 swin_block bf16 [128,64,1024] h32 (stage 4)", swin_block.swin_block,
               swin_block.swin_block_reference,
               [r((128, n, cs)), sp["qkv_w"], qkv_b, sp["proj_w"], sp["proj_b"], sp["ln1_s"],
                sp["ln1_b"], sp["fc1_w"], sp["fc1_b"], sp["fc2_w"], sp["fc2_b"], sp["ln2_s"],
                sp["ln2_b"], rpb, scale, mask], (hs, 1), block=True)
    q = r((64, 512), dt=torch.float32).requires_grad_()
    refs = r((1000, 512), dt=torch.float32)
    for label, fn in (("B5", lambda: topk.extract_topk(q, refs, 1000, e=4, tile_r=256, k=8)),
                      ("K3", lambda: sim.row_max_gemm(q, refs))):
        try:
            fn()
        except RuntimeError as e:
            check("not differentiable" in str(e), f"{label}: raised {e}")
        else:
            raise Failed(f"{label} ran on an operand that requires grad")
    print("  B5 and K3 raise on an operand that requires grad (no VJP, as in JAX)", flush=True)


def _flat_masters(model, tree) -> dict:
    from vsc22_tpu_torch.utils import jax_params

    entries = (jax_params.vit_entries(model) if hasattr(model, "backbone")
               else jax_params.swinv2_entries(model))
    return jax_params.jax_flat_params(entries, {id(p): tree[n]
                                                for n, p in model.named_parameters()})


def check_tiny_train(device) -> None:
    """8(b): three f32 steps of the tiny ViT and the tiny SwinV2 with FGM
    and EMA, card against CPU, same weights and batch."""
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.models.swinv2 import swinv2_tiny_test_descriptor
    from vsc22_tpu_torch.models.vit import vit_tiny_test_descriptor
    from vsc22_tpu_torch.train.contrastive import (
        ContrastiveConfig,
        create_train_state,
        make_train_step,
    )

    cfg = ContrastiveConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
                            fgm_epsilon=0.1, ema_decay=0.9)
    for label, build, size in (("ViT tiny", vit_tiny_test_descriptor, 64),
                               ("SwinV2 tiny", swinv2_tiny_test_descriptor, 32)):
        cpu = build()
        reset_parameters(cpu, torch.Generator().manual_seed(82))
        card = copy.deepcopy(cpu).to(device)
        rng = np.random.default_rng(83)
        imgs = {k: torch.from_numpy(rng.standard_normal((3, size, size, 3)).astype(np.float32))
                for k in ("img_a", "img_b")}
        runs = []
        for model, dev in ((cpu, "cpu"), (card, device)):
            batch = {k: v.to(dev) for k, v in imgs.items()}
            state, tx = create_train_state(model, cfg)
            step = make_train_step(model, tx, cfg)
            _, grads = step.gradients(batch, torch.Generator().manual_seed(0))
            gen = torch.Generator().manual_seed(0)
            losses = []
            for _ in range(3):
                state, metrics = step(state, batch, gen)
                losses.append(float(metrics["loss"]))
            runs.append(([g.cpu() for g in grads], losses,
                         {k: v.cpu() for k, v in state.params.items()},
                         {k: v.cpu() for k, v in state.ema_params.items()}))
        (g_cpu, l_cpu, p_cpu, e_cpu), (g_card, l_card, p_card, e_card) = runs
        grad_err = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                       for a, b in zip(g_cpu, g_card))
        loss_err = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_card))
        ref = _flat_masters(cpu, {n: g for (n, _), g in zip(cpu.named_parameters(), g_cpu)})
        top = max(float(np.abs(g).max()) for g in ref.values())
        left_out = sum(int((np.abs(g) <= TRAIN_ROUNDING_GRAD * top).sum()) for g in ref.values())
        over, total, worst = 0, 0, 0.0
        for want_tree, got_tree in ((p_cpu, p_card), (e_cpu, e_card)):
            want, got = _flat_masters(cpu, want_tree), _flat_masters(cpu, got_tree)
            for k in want:
                keep = np.abs(ref[k]) > TRAIN_ROUNDING_GRAD * top
                err = np.abs(got[k] - want[k])[keep]
                worst = max(worst, float(err.max(initial=0.0)))
                over += int((err > TRAIN_PARAM_ATOL).sum())
                total += err.size
        print(f"  {label} f32, 3 steps with FGM and EMA, card vs CPU: first-step gradients "
              f"{grad_err:.3e} of each leaf's max (tol {TRAIN_GRAD_TOL:g}), losses "
              f"{l_card} (rel {loss_err:.3e}, tol {TRAIN_LOSS_TOL:g}), params and EMA worst "
              f"{worst:.3e} (tol {TRAIN_PARAM_WORST:g}), {over} of {total} over "
              f"{TRAIN_PARAM_ATOL:g} ({left_out} elements with a rounding-residue gradient "
              "left out)", flush=True)
        check(grad_err <= TRAIN_GRAD_TOL and loss_err <= TRAIN_LOSS_TOL
              and worst <= TRAIN_PARAM_WORST and over <= TRAIN_PARAM_MAX_SHARE * total,
              f"{label}: the train step on the card disagrees with the CPU's")


def train_profile(run) -> dict:
    """run() under torch.profiler (device activity): device ms by family
    (the hand kernels, cuBLAS's products, the optimizer's foreach
    kernels, everything else), the idle share of the wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fam = {"hand kernels (forward)": [0.0, 0], "cuBLAS products": [0.0, 0],
           "optimizer (foreach)": [0.0, 0], "everything else": [0.0, 0]}
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        key = e.key
        if any(k in key for k in TRAIN_HAND_KERNELS):
            f = "hand kernels (forward)"
        elif any(k in key for k in TRAIN_OPTIMIZER_WORDS):
            f = "optimizer (foreach)"
        elif any(k in key.lower() for k in TRAIN_CUBLAS_WORDS):
            f = "cuBLAS products"
        else:
            f = "everything else"
        fam[f][0] += e.self_device_time_total / 1e3
        fam[f][1] += e.count
        top.append((e.self_device_time_total / 1e3, e.count, key))
    device_ms = sum(v[0] for v in fam.values())
    print(f"  profiled step: wall {1e3 * wall:.1f} ms, device {device_ms:.1f} ms, idle "
          f"{1 - device_ms / 1e3 / wall:.1%} of the wall (under the profiler)", flush=True)
    for f, (ms, calls) in fam.items():
        print(f"    {f}: {ms:.1f} ms ({ms / device_ms:.1%}), {calls} launches", flush=True)
    for ms, calls, key in sorted(top, reverse=True)[:8]:
        print(f"      {ms:8.2f} ms {ms / device_ms:6.1%} {calls:6d} calls  {key[:100]}",
              flush=True)
    return {f: v[0] for f, v in fam.items()} | {"idle": 1 - device_ms / 1e3 / wall}


def run_train_model(model: str, pairs: int, card: str, wrappers: dict, steps: int) -> dict:
    """8(c)/(d): `scripts/torch_perf_train.py`'s bench at full width, bf16
    with f32 masters, FGM and EMA on, lr 1e-4 with no warm-up: one warm-up
    step, `steps` timed steps (the launches of the path's kernels counted
    over them), one profiled step (the step's parts, run apart: the
    script's `--parts`)."""
    from scripts.torch_perf_train import measure, setup

    t0 = time.perf_counter()
    bench = setup(model, pairs, fgm=True, lr=1e-4, warmup_ratio=0.0)
    bench.step()
    torch.cuda.synchronize()
    print(f"  {model}: set-up and warm-up step {time.perf_counter() - t0:.1f} s", flush=True)
    zero_counts(wrappers.values())
    res = measure(bench, steps)
    res["launches_per_step"] = {k: w.launches / steps for k, w in wrappers.items()}
    losses = res["losses"]
    print(f"  {model} train step, {pairs} pairs ({2 * pairs} images a pass, FGM: 2 passes), "
          f"bf16, EMA: {res['train_images_per_sec']:.1f} images/s, step {res['step_ms']:.1f} ms, "
          f"peak memory {res['peak_mem_gib']:.2f} GiB, model {res['model_tflops']:.1f} TFLOP/s "
          f"({res['tflops_share_of_bf16_peak']:.1%} of 989) on {card}", flush=True)
    print(f"    losses over the timed steps {[round(v, 4) for v in losses]}; launches per step "
          f"{res['launches_per_step']}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{model}: the loss did not fall over the timed steps: {losses}")
    res["profile"] = train_profile(bench.step)
    del bench
    torch.cuda.empty_cache()
    return res


def run_training(device, card: str) -> dict:
    """Phase 8: the descriptor track's training step on the card; returns
    8(c)'s ViT-B/32 result."""
    from vsc22_tpu_torch.models import layers
    from vsc22_tpu_torch.ops import attn_proj, mlp, swin_block, window_attn
    from vsc22_tpu_torch.ops.mlp import fused_mlp_routes

    t0 = time.perf_counter()
    check_kernel_grads(device)
    print(f"  8(a) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    check_tiny_train(device)
    print(f"  8(b) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    vit_res = run_train_model("vit", 48, card, {"K1": attn_proj.attn_proj_residual,
                                                 "K2": mlp.ln_mlp_residual}, steps=8)
    per_step = vit_res["launches_per_step"]
    check(per_step["K1"] == 24 and per_step["K2"] == 24,
          f"ViT-B/32: K1 and K2 launches per step {per_step}, not 12 per forward x 2 passes")
    print(f"  8(c) took {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    b7 = lambda x, w1, b1, w2, b2: fused_mlp_routes(x, w1, w2)
    with spy_routes([(layers, "fused_mlp", "B7", b7)]) as calls:
        swin_res = run_train_model("swin", 32, card, {
            "B7": mlp.fused_mlp, "B1": swin_block.swin_block, "B6": window_attn.window_attention},
            steps=SWIN_TIMED_STEPS)
    per_step = swin_res["launches_per_step"]
    check(per_step["B7"] == 48 and per_step["B1"] == 0 and per_step["B6"] == 0,
          f"SwinV2-Base: launches per step {per_step}, not B7 24 per forward x 2 passes and "
          "no B1 or B6")
    loops = {(r["fc1"], r["fc2"]) for _, _, r in calls}
    print(f"  SwinV2-Base B7 calls {len(calls)}, their loops (fc1, fc2): {sorted(loops)}",
          flush=True)
    check(loops == {("mma", "mma")}, f"a B7 product of the train step left bf16 tensor cores: "
                                     f"{loops}")
    print(f"  8(d)-(e) took {time.perf_counter() - t0:.1f} s", flush=True)
    return vit_res


# --- phase 9: the matching track's trainers and the alignment methods ---------------

# Card against CPU, three f32 train steps of each matching CNN from the same
# weights and batch, at the trainers' lr: the bars of
# tests/test_torch_matching_train.py (the port against JAX on the CPU). The
# first step's gradients per leaf within TRAIN_GRAD_TOL of the CPU leaf's max
# |g| (a leaf that is rounding residue on the CPU, at most TRAIN_ROUNDING_GRAD
# of the step's largest |g|, must be residue on the card too), its loss
# TRAIN_LOSS_TOL relative and its BN buffers CNN_BN_ATOL; the later steps'
# losses CNN_LATER_LOSS_TOL and buffers CNN_LATER_BN_ATOL (Adam's eps 1e-8
# moves each rounding-noise element a full lr either way); the params after
# three steps by phase 8's rule. cuDNN's TF32 flag is ON (torch's default)
# for the whole phase: a convolution whose forward or backward ran in TF32
# (~1e-3 relative) would fail the gradient bar.
CNN_LR = 1e-4
CNN_BN_ATOL = 1e-6
CNN_LATER_LOSS_TOL = 1e-4
CNN_LATER_BN_ATOL = 5e-5
# Timed steps of 9(b) and 9(c), cut for the time budget (PERF.md §4): the
# SAM's step is ~0.5 s, launch bound.
CNN_TIMED_STEPS = {"mnv3": 8, "sam": 3}
# 9(e): phase 5's eval maps whose boxes native TN and the Python DAG must
# share, and the maps whose DP fills must be equal bit for bit.
TN_MAPS = 200
DP_MAPS = 5


def planted_batch(rng, n, res):
    """n sim-like [res, res, 3] images (`sim_like_images`); the even ones
    carry a copy planted on a diagonal at 0.9. Returns (images, class
    labels 1 planted / 0 not, soft-band labels as the refine trainer draws
    them)."""
    from vsc22_tpu_torch.train.matching import soft_band_label

    x = sim_like_images(rng, n, res, res // 2, res + 1).numpy()
    cls = np.zeros(n, np.int64)
    band = np.zeros((n, res, res), np.float32)
    for i in range(0, n, 2):
        length = int(rng.integers(res // 8, res // 4 + 1))
        q0, r0 = (int(v) for v in rng.integers(0, res // 4, 2))
        d = np.arange(length)
        x[i, q0 + d, r0 + d] = 0.9
        cls[i] = 1
        band[i] = soft_band_label((res, res), [(q0, q0 + length - 1, r0, r0 + length - 1)])
    return torch.from_numpy(x), torch.from_numpy(cls), torch.from_numpy(band)


def check_cnn_steps(device) -> None:
    """9(a): three f32 steps of MobileNetV3-Small (64^2, batch 8, dropout 0)
    and the tiny SAM (32^2, batch 2), card against CPU (see CNN_LR)."""
    from vsc22_tpu_torch.models.hrnet import sam_hrnet_tiny_test
    from vsc22_tpu_torch.models.mobilenetv3 import mobilenetv3_small
    from vsc22_tpu_torch.train import matching as tm

    gen, rng = torch.Generator().manual_seed(91), np.random.default_rng(91)
    mnv3 = mobilenetv3_small(device="cpu", dropout=0.0)
    lively_weights(mnv3, gen)
    x, cls, _ = planted_batch(rng, 8, 64)
    sam = sam_hrnet_tiny_test()
    lively_weights(sam, gen)
    xs, _, band = planted_batch(rng, 2, 32)
    for label, cpu_model, images, targets, make in (
            ("MobileNetV3-Small [8, 64, 64]", mnv3, x, cls, tm.make_classify_train_step),
            ("SAM HRNet-tiny [2, 32, 32]", sam, xs, band, tm.make_refine_train_step)):
        runs = []
        for dev in ("cpu", device):
            model = copy.deepcopy(cpu_model).to(dev)
            tx = tm.make_cnn_optimizer(CNN_LR)
            state, step = tm.create_cnn_state(model, tx), make(model, tx)
            im, tg = images.to(dev), targets.to(dev)
            seeds, losses, stats, grads = torch.Generator().manual_seed(0), [], [], None
            for _ in range(3):
                loss, g = step.gradients(im, tg, seeds)
                state = step.update(state, g)
                grads = g if grads is None else grads  # the first step's
                losses.append(float(loss))
                stats.append({k: v.detach().cpu().clone() for k, v in state.batch_stats.items()})
            runs.append(([g.cpu() for g in grads], losses, stats,
                         {k: v.cpu() for k, v in state.params.items()}))
        (g_cpu, l_cpu, s_cpu, p_cpu), (g_card, l_card, s_card, p_card) = runs
        top = max(float(g.abs().max()) for g in g_cpu)
        grad_err, residue_ok = 0.0, True
        for a, b in zip(g_cpu, g_card):
            scale = float(a.abs().max())
            if scale <= TRAIN_ROUNDING_GRAD * top:
                residue_ok &= float(b.abs().max()) <= TRAIN_ROUNDING_GRAD * top
            else:
                grad_err = max(grad_err, float((a - b).abs().max()) / scale)
        loss_err = [abs(a - b) / abs(a) for a, b in zip(l_cpu, l_card)]
        bn_err = [max(float((a[k] - b[k]).abs().max()) for k in a) for a, b in zip(s_cpu, s_card)]
        over, total, worst = 0, 0, 0.0
        for (name, want), g in zip(p_cpu.items(), g_cpu):
            err = (p_card[name] - want).abs()[g.abs() > TRAIN_ROUNDING_GRAD * top]
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
            over += int((err > TRAIN_PARAM_ATOL).sum())
            total += err.numel()
        print(f"  {label} f32, 3 steps (lr {CNN_LR:g}, eps 1e-8, TF32 flag on), card vs CPU: "
              f"first-step gradients {grad_err:.3e} of each leaf's max (tol {TRAIN_GRAD_TOL:g}; "
              f"residue leaves {'stay residue' if residue_ok else 'DO NOT stay residue'}), losses "
              f"{[round(v, 6) for v in l_card]} (rel {[f'{e:.1e}' for e in loss_err]}), BN "
              f"buffers {[f'{e:.1e}' for e in bn_err]}, params worst {worst:.3e} (tol "
              f"{TRAIN_PARAM_WORST:g}), {over} of {total} over {TRAIN_PARAM_ATOL:g}", flush=True)
        check(grad_err <= TRAIN_GRAD_TOL and residue_ok, f"{label}: gradients on the card differ")
        check(loss_err[0] <= TRAIN_LOSS_TOL and max(loss_err[1:]) <= CNN_LATER_LOSS_TOL,
              f"{label}: losses on the card differ")
        check(bn_err[0] <= CNN_BN_ATOL and max(bn_err[1:]) <= CNN_LATER_BN_ATOL,
              f"{label}: BN buffers on the card differ")
        check(worst <= TRAIN_PARAM_WORST and over <= TRAIN_PARAM_MAX_SHARE * total,
              f"{label}: params on the card differ after three steps")


def step_profile(run) -> float:
    """run() once under torch.profiler: wall, device time, the idle share
    and the largest kernels; returns the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    top = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    device_ms = sum(t[0] for t in top)
    idle = 1 - device_ms / 1e3 / wall
    print(f"    profiled step: wall {1e3 * wall:.1f} ms, device {device_ms:.1f} ms, idle "
          f"{idle:.1%} of the wall (under the profiler); {sum(t[1] for t in top)} launches",
          flush=True)
    for ms, calls, key in top[:6]:
        print(f"      {ms:8.2f} ms {ms / device_ms:6.1%} {calls:6d} calls  {key[:100]}", flush=True)
    return idle


def run_cnn_bench(label, model, images, targets, make, card: str, steps: int) -> dict:
    """9(b)/(c): the trainer's step at the JAX defaults (f32, AdamW lr 1e-4,
    wd 5e-5) on one fixed device batch: a warm-up step, `steps` timed
    steps (the loss read after them), one profiled step."""
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.train import matching as tm

    reset_parameters(model, torch.Generator().manual_seed(2023))  # as the fold trainers seed
    device = images.device
    model.to(device)
    tx = tm.make_cnn_optimizer()
    state, step = tm.create_cnn_state(model, tx), make(model, tx)
    seeds = torch.Generator().manual_seed(2023)
    t0 = time.perf_counter()
    state, first = step(state, images, targets, seeds)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, images, targets, seeds)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    losses = [float(first)] + [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = images.shape[0]
    print(f"  {label}: warm-up step {warm:.2f} s; {steps} timed steps: step "
          f"{step_ms:.2f} ms, {1e3 * n / step_ms:.1f} images/s, peak memory {peak:.3f} GiB on "
          f"{card}", flush=True)
    print(f"    losses (warm-up, then each timed step) {[round(v, 4) for v in losses]}",
          flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: the loss is not finite or did not fall: {losses}")
    idle = step_profile(lambda: step(state, images, targets, seeds))
    return {"step_ms": step_ms, "images_per_s": 1e3 * n / step_ms, "peak_gib": peak,
            "idle": idle}


def training_corpus(root: str, n_queries: int = 6, per_query: int = 2, dim: int = 64):
    """A planted corpus for the training CLI, written as the CLIs read it:
    n_queries + 2 ref and n_queries query videos of 40-79 unit frames, the
    first half of the queries carrying a lightly noised 20-frame copy of
    ref i, `per_query` candidates each (query i's own ref first), the
    matching ground truth, and 32 noise videos for the inference CLI's
    score-norm. Small, because the inference CLI refines every recalled
    pair (all n_queries x refs of them on random features). Returns the
    paths."""
    from vsc22_tpu_torch.core.storage import store_features
    from vsc22_tpu_torch.core.types import Match, VideoFeature, _write_rows

    rng = np.random.default_rng(92)

    def videos(prefix, count, start=0):
        out = []
        for i in range(count):
            f = rng.standard_normal((int(rng.integers(40, 80)), dim)).astype(np.float32)
            f /= np.linalg.norm(f, axis=1, keepdims=True)
            out.append(VideoFeature(video_id=f"{prefix}{start + i:06d}", feature=f,
                                    timestamps=np.arange(len(f), dtype=np.float32)))
        return out

    refs, queries, noise = videos("R", n_queries + 2), videos("Q", n_queries), \
        videos("R", 32, start=1000)
    gt, cands = [], []
    for i, q in enumerate(queries):
        if i < n_queries // 2:
            r = refs[i].feature
            q.feature[10:30] = r[5:25] + rng.normal(0, 0.05, (20, dim)).astype(np.float32)
            q.feature /= np.linalg.norm(q.feature, axis=1, keepdims=True)
            gt.append(Match(query_id=q.video_id, ref_id=refs[i].video_id, score=1.0,
                            query_start=10.0, query_end=30.0, ref_start=5.0, ref_end=25.0))
        others = rng.choice(np.delete(np.arange(len(refs)), i), per_query - 1, replace=False)
        cands += [(q.video_id, refs[j].video_id) for j in [i, *others]]
    paths = {k: os.path.join(root, f"{k}.npz") for k in ("queries", "refs", "noise")}
    for k, v in (("queries", queries), ("refs", refs), ("noise", noise)):
        store_features(paths[k], v)
    paths["gt"] = os.path.join(root, "gt.csv")
    Match.write_csv(gt, paths["gt"])
    paths["candidates"] = os.path.join(root, "candidates.csv")
    _write_rows(paths["candidates"], ["query_id", "ref_id", "score"],
                ([q, r, "1.0"] for q, r in cands))
    return paths, len(cands)


def run_training_cli(card: str) -> None:
    """9(d): `train/matching_cli.main` on the card with the full-width models
    (1 classify and 1 refine epoch at 160^2 and 128^2) over
    `training_corpus`, its files checked (threshold 0: every pair goes on to
    the refine phase, whatever one epoch made of the classifier); then
    `pipelines/matching_cli.main` with the four snapshots over the same
    corpus."""
    import tempfile

    from vsc22_tpu_torch.core.types import _read_rows
    from vsc22_tpu_torch.pipelines import matching_cli as infer_cli
    from vsc22_tpu_torch.train import matching_cli as train_cli

    with tempfile.TemporaryDirectory() as root:
        paths, n_cands = training_corpus(root)
        work = os.path.join(root, "run")
        t0 = time.perf_counter()
        result = train_cli.main([
            "--query_features", paths["queries"], "--ref_features", paths["refs"],
            "--candidates", paths["candidates"], "--gt", paths["gt"], "--work_dir", work,
            "--cls_epochs", "1", "--refine_epochs", "1", "--cls_threshold", "0.0"])
        train_s = time.perf_counter() - t0
        scores = _read_rows(os.path.join(work, "candidate_scores.csv"))
        with open(os.path.join(work, "summary.json")) as f:
            summary = json.load(f)
        snaps = {f"{k}_{t}": os.path.join(work, f"{k}_{t}.npz")
                 for k in ("classify", "refine") for t in ("h1", "h2")}
        with open(os.path.join(work, "val_matches.csv")) as f:
            header = f.readline().strip().split(",")
        print(f"  training CLI (MobileNetV3-Small + SAM HRNet-W18, f32, 1 + 1 epochs) on "
              f"{n_cands} candidates: {train_s:.1f} s; {len(scores)} candidate scores, summary "
              f"{summary}, snapshots {sorted(k for k, p in snaps.items() if os.path.isfile(p))}",
              flush=True)
        check(len(scores) == 2 * n_cands and all(0.0 <= float(r["prob"]) <= 1.0 for r in scores),
              "training CLI: candidate_scores.csv")
        check(header == infer_cli.COLUMNS and summary["pairs"] > 0
              and summary["classify_ap"] == result["classify_ap"],
              "training CLI: val_matches.csv or summary.json")
        check(all(os.path.isfile(p) for p in snaps.values()), "training CLI: a snapshot is missing")
        out = os.path.join(root, "matches.csv")
        t0 = time.perf_counter()
        infer_cli.main(["--query_features", paths["queries"], "--ref_features", paths["refs"],
                        "--norm_refs", paths["noise"], "--out", out,
                        "--cls_params", snaps["classify_h1"], snaps["classify_h2"],
                        "--refine_params", snaps["refine_h1"], snaps["refine_h2"]])
        rows = _read_rows(out)
        print(f"  inference CLI on the four snapshots (each loaded with no key missing or "
              f"extra): {len(rows)} match rows in {time.perf_counter() - t0:.1f} s", flush=True)
        with open(out) as f:
            check(f.readline().strip().split(",") == infer_cli.COLUMNS,
                  "inference CLI on the trained snapshots: bad matches.csv")


def check_alignment(tn_maps, tn_wall) -> None:
    """9(e): native TN against the Python DAG on `tn_maps` (phase 5's eval
    maps, at its settings), the native DP fill against numpy bit for bit on
    DP_MAPS of them, DTW, DP and HV each finding a planted copy; phase 5's
    TN wall (`tn_wall`, None when phase 5 did not run) printed beside the
    Python DAG's."""
    from vsc22_tpu_torch.align import vta

    kw = dict(tn_max_step=5, min_length=4)
    t0 = time.perf_counter()
    native = [vta.tn(m, **kw) for m in tn_maps]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = [vta.tn_reference(m, **kw) for m in tn_maps]
    ref_s = time.perf_counter() - t0
    same = sum(a == b for a, b in zip(native, ref))
    print(f"  TN on {len(tn_maps)} eval maps ({tn_maps[0].shape[0]}x{tn_maps[0].shape[1]}): "
          f"native {1e3 * native_s / len(tn_maps):.3f} ms a map, the Python DAG "
          f"{1e3 * ref_s / len(tn_maps):.3f} ms ({ref_s / native_s:.1f}x) on this host's CPU; "
          f"{same} of {len(tn_maps)} box lists identical, {sum(map(len, native))} boxes",
          flush=True)
    check(same == len(tn_maps), "native TN disagrees with the Python DAG")
    for m in tn_maps[:DP_MAPS]:
        shifted = np.asarray(m, np.float64) + 1.0
        for a, b in zip(vta._dp_matrix(shifted, 3, 1.0), vta.dp_matrix_reference(shifted, 3, 1.0)):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  "the native DP fill differs from numpy's")
    print(f"  DP fill on {DP_MAPS} maps: native = numpy bit for bit (dp, accu, back)", flush=True)
    rng = np.random.default_rng(93)
    idx = np.arange(10, 40)
    found = {}
    for name, base, kwargs in (("dtw", 0.0, {"min_sim": 0.3}), ("dp", -0.5, {}),
                               ("hv", 0.0, {})):
        sim = rng.random((50, 50)) * 0.1 + base
        sim[idx, idx] = 0.9
        boxes = getattr(vta, name)(sim, **kwargs)
        found[name] = boxes
        check(any(q0 <= 12 and r0 <= 12 and q1 >= 37 and r1 >= 37 for q0, r0, q1, r1 in boxes),
              f"{name} missed the planted copy: {boxes}")
    print(f"  planted copy at q, r 10-39: {found}", flush=True)
    if tn_wall is not None:
        print(f"  phase 5's tn_localization wall {tn_wall:.3f} s (13.6-14.2 s on an H100 with "
              "the Python DAG in 8 workers)", flush=True)


def synthetic_tn_maps(n: int) -> list:
    """Without phase 5: n maps as its eval gives TN (32x32 frame products of
    unit 512-d rows + 0.5, half of them pairs with a planted copy)."""
    queries, refs, _, _ = make_corpus(n, n, 0, 32, 512, planted=n // 2, seed=94)
    return [q.feature @ r.feature.T + 0.5 for q, r in zip(queries, refs)]


def run_matching_training(device, card: str, tn_maps, tn_wall) -> None:
    """Phase 9 (see its constants), with cuDNN's TF32 flag on throughout."""
    from vsc22_tpu_torch.models.hrnet import sam_hrnet_w18
    from vsc22_tpu_torch.models.mobilenetv3 import mobilenetv3_small
    from vsc22_tpu_torch.train import matching as tm

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        check_cnn_steps(device)
        print(f"  9(a) took {time.perf_counter() - t0:.1f} s", flush=True)
        rng = np.random.default_rng(95)
        t0 = time.perf_counter()
        x, cls, _ = planted_batch(rng, 64, 160)
        run_cnn_bench("9(b) MobileNetV3-Small [64, 160, 160] f32 dropout 0.2",
                      mobilenetv3_small(device="cpu"), x.to(device), cls.to(device),
                      tm.make_classify_train_step, card, CNN_TIMED_STEPS["mnv3"])
        x, _, band = planted_batch(rng, 8, 128)
        run_cnn_bench("9(c) SAM HRNet-W18 [8, 128, 128] f32 soft-band labels",
                      sam_hrnet_w18(device="cpu"), x.to(device), band.to(device),
                      tm.make_refine_train_step, card, CNN_TIMED_STEPS["sam"])
        torch.cuda.empty_cache()
        print(f"  9(b)-(c) took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        run_training_cli(card)
        print(f"  9(d) took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        check_alignment(tn_maps if tn_maps is not None else synthetic_tn_maps(TN_MAPS), tn_wall)
        print(f"  9(e) took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# --- phase 10: the per-video path and the offline CLIs ---------------------------
#
# The per-video `QueryPipeline` (`pipelines/query_extract.py`) at full width
# on phase 3's models, PCA and first 8 videos (kinds 0-7 of `synth_videos`:
# 6 letterboxed, 7 a 2-up stack that FSD splits into 48 + 16 frame chunks),
# with the exact host FSD (the float64 variance and the port's own Canny)
# and OpenCV's cubic resize computed on the card; then the offline flow on
# phase 3's videos 8-23 as decoded frames: `ref_extract` for each member in
# two shards, `ensemble_cli`, `query_cli`'s query function, the eval with
# planted exact copies, and a `clip_features` zip.

PER_VIDEO = 8
OFFLINE_TRAIN, OFFLINE_TEST = range(8, 16), range(16, 24)
OFFLINE_PLANTED = 4  # queries 0-3 are exact copies of test refs 16-19
CV2_CHECK_FRAMES = 6


def probe_decoders() -> list:
    """Print which decoders the host has; return the usable backends of
    `data/frames.read_frames` (empty: no decoder)."""
    import importlib.util
    import shutil

    from vsc22_tpu_torch.data import frames

    found = {name: importlib.util.find_spec(name) is not None
             for name in ("cv2", "PIL", "torchvision")}
    found["ffmpeg"] = shutil.which("ffmpeg")
    if found["cv2"]:
        import cv2

        found["cv2"] = cv2.__version__
    backends = frames.available_backends()
    print(f"  (a) decoders on this host: {found}; read_frames backends {backends or 'none'}",
          flush=True)
    return backends


def check_cv2_arithmetic(device, video: np.ndarray, card: str) -> None:
    """(b) OpenCV's resize and Canny as the port computes them: the card's
    bits equal the CPU's on the first frames of a letterboxed 360x640 video
    (FSD needs 5)."""
    from vsc22_tpu_torch.data import fsd
    from vsc22_tpu_torch.data.transforms import resize_cubic_u8, resize_normalize_frames

    frames = list(video[:CV2_CHECK_FRAMES])
    t0 = time.perf_counter()
    maps = {dev: fsd.variance_and_edges_host(frames, dev) for dev in (device, "cpu")}
    for a, b in zip(maps[device], maps["cpu"]):
        check(bool((a == b).all()), "FSD maps: the card's differ from the CPU's")
    changed, boxes = fsd.image_process_boxes(frames, maps[device])
    check(changed, f"FSD kept the letterboxed video whole: {boxes}")
    sh, eh, sw, ew = (int(v) for v in boxes[0])
    x = torch.from_numpy(video[:CV2_CHECK_FRAMES])
    cases = [(x, 384, 384), (x, 256, 256), (x, 224, 398),
             (x[:, sh:eh, sw:ew].contiguous(), 384, 384)]
    for src, oh, ow in cases:
        check(torch.equal(resize_cubic_u8(src.to(device), oh, ow).cpu(),
                          resize_cubic_u8(src, oh, ow)),
              f"resize to {oh}x{ow}: the card's bits differ from the CPU's")
    check(torch.equal(resize_normalize_frames(x.to(device), 384, "vit").cpu(),
                      resize_normalize_frames(x, 384, "vit")),
          "the resize's normalization: the card's bits differ from the CPU's")
    edges = fsd.canny_edges(x.to(device)).cpu()
    check(torch.equal(edges, fsd.canny_edges(x)), "Canny: the card's bits differ from the CPU's")
    print(f"  (b) card = CPU bit for bit on {CV2_CHECK_FRAMES} 360x640 frames: cubic resize "
          "to 384^2, 256^2, "
          f"224x398 and of the FSD crop {(sh, eh, sw, ew)} to 384^2, and its normalization; "
          f"Canny(50, 400) "
          f"({int(edges.sum())} edge pixels); the float64 variance and the edge map; "
          f"{time.perf_counter() - t0:.1f} s with the CPU side ({card})", flush=True)


@contextlib.contextmanager
def capture_chunk_operands(frames: int, vit_tokens: int, swin_windows: int):
    """The first K1 and K2 call of the ViT member's blocks on a `frames`-row
    chunk and the first B1 call on `swin_windows` windows (a SwinV2 member's
    stage 1 on such a chunk), each as (wrapper, reference, args)."""
    from vsc22_tpu_torch.models import layers, swinv2
    from vsc22_tpu_torch.ops import attn_proj, mlp, swin_block

    seen = {}
    targets = [
        (layers, "attn_proj_residual", "K1", attn_proj.attn_proj_residual_reference,
         lambda a: a[0].dim() == 3 and a[0].shape[0] == frames),
        (layers, "ln_mlp_residual", "K2", mlp.ln_mlp_residual_reference,
         lambda a: a[0].shape[0] == frames * vit_tokens),
        (swinv2, "swin_block", "B1", swin_block.swin_block_reference,
         lambda a: a[0].shape[0] == swin_windows),
    ]
    saved = [(m, n, getattr(m, n)) for m, n, *_ in targets]

    def spy(real, label, ref, want):
        def call(*args):
            if label not in seen and want(args):
                seen[label] = (real, ref, args)
            return real(*args)
        return call

    for (m, n, label, ref, want), (_, _, real) in zip(targets, saved):
        setattr(m, n, spy(real, label, ref, want))
    try:
        yield seen
    finally:
        for m, n, real in saved:
            setattr(m, n, real)


def members(models) -> list:
    """(name, model, input size, preset) of phase 3's four members."""
    return [("vit", models["vit"], models["vit"].backbone.cfg.img_size, "efficientnet")] + [
        (f"swin{i}", m, m.cfg.img_size, "vit") for i, m in enumerate(models["swins"])]


def per_video_pipeline(device, models, pca, ved_model=None, threshold: float = 0.0,
                       use_device_fsd_maps: bool = False):
    from vsc22_tpu_torch.pipelines.query_extract import (
        DescriptorExtractor,
        QueryPipeline,
        VideoEditDetector,
    )

    extractors = [DescriptorExtractor(m, size, preset, device=device)
                  for _, m, size, preset in members(models)]
    vsm = ved_model or models["vsm"]
    ved = VideoEditDetector(models["clip"], vsm, vsm.cfg.max_frames, device=device)
    return QueryPipeline(extractors, pca=pca, ved=ved, score_threshold=threshold, out_dim=512,
                         use_device_fsd_maps=use_device_fsd_maps, device=device)


def run_per_video(device, wrappers, models, pca, videos, noise, card: str) -> dict:
    """(c) The per-video pass over 8 videos and query score-norm (nk 1):
    videos/s, the launches of K1, K2, B1 and K3, and K1, K2 and B1 held to
    their plain versions on the operands of a full 48-frame chunk."""
    from vsc22_tpu_torch.data import fsd
    from vsc22_tpu_torch.pipelines.query_extract import (
        LEN_THRESHOLD,
        DescriptorExtractor,
        VideoEditDetector,
        calculate_low_var_dim,
    )
    from vsc22_tpu_torch.retrieval import score_norm

    pipe = per_video_pipeline(device, models, pca)
    names = [f"Q{i:06d}" for i in range(PER_VIDEO)]
    vit_cfg, swin_cfg = models["vit"].backbone.cfg, models["swins"][0].cfg
    res = swin_cfg.img_size // swin_cfg.patch_size  # stage 1: res^2 tokens
    swin_windows = LEN_THRESHOLD * (res // min(swin_cfg.window_size, res)) ** 2
    with capture_chunk_operands(LEN_THRESHOLD, vit_cfg.num_patches + 1, swin_windows) as ops:
        t0 = time.perf_counter()
        pipe.process_video("warm-up", list(videos[7]))  # the 2-up stack: 48 + 16 frames
        torch.cuda.synchronize()
    print(f"  (c) warm-up on the 2-up stack {time.perf_counter() - t0:.2f} s ({card})",
          flush=True)
    check(set(ops) == {"K1", "K2", "B1"}, f"no full {LEN_THRESHOLD}-frame chunk: {sorted(ops)}")
    chunks = {k: [] for k in ("vit", "clip", "swin")}
    hooks = [m.register_forward_pre_hook(lambda mod, a, k=k: chunks[k].append(int(a[0].shape[0])))
             for k, m in (("vit", models["vit"]), ("clip", models["clip"]),
                          ("swin", models["swins"][0]))]
    low_var = calculate_low_var_dim(noise)
    stages = [(VideoEditDetector, "score", "VED"), (fsd, "image_process", "FSD"),
              (DescriptorExtractor, "extract", "extract (4 members)"),
              (score_norm, "query_score_normalize", "score-norm")]
    zero_counts(wrappers)
    with call_times(stages) as split:
        t0 = time.perf_counter()
        runs = [pipe.process_video(n, list(v)) for n, v in zip(names, videos[:PER_VIDEO])]
        feats = [f for f, _ in runs]
        normed = score_norm.query_score_normalize(feats, noise, pipe.video_scores, 0.0,
                                                  low_var, beta=1.2, nk=1, device=device)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = counts(wrappers)
    for h in hooks:
        h.remove()
    for f, g in zip(feats, normed):
        check(f.feature.shape[1] == 512 and len(f.feature) > 0
              and bool(np.isfinite(f.feature).all()) and bool(np.isfinite(g.feature).all()),
              f"per-video {f.video_id}: bad features {f.feature.shape}")
    per_block = vit_cfg.depth * len(chunks["vit"]) + len(models["clip"].blocks) * len(
        chunks["clip"])
    want = dict(attn_proj_residual=per_block, ln_mlp_residual=per_block,
                swin_block=sum(swin_cfg.depths) * len(chunks["swin"]) * 3, row_max_gemm=1)
    path = {k: launches[k] for k in want}
    cut = [n for n, (_, subs) in zip(names, runs) if len(subs[0].feature) > 32]
    print(f"  (c) per-video pass: {PER_VIDEO} videos (FSD split {cut}) + query score-norm "
          f"in {elapsed:.3f} s = "
          f"{PER_VIDEO / elapsed:.3f} videos/s on {card}; chunks ViT {chunks['vit']}, CLIP "
          f"{chunks['clip']}, SwinV2 {chunks['swin']} (x3); launches {path} (expected {want}); "
          f"B6/B7/B5/B8/B9/B10 {[launches[k] for k in launches if k not in want]}", flush=True)
    print("  (c) its split (synchronised at each stage edge): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
          + f", rest (uploads, dedup, PCA) {elapsed - sum(split.values()):.3f} s ({card})",
          flush=True)
    check(path == want, "per-video pass: launch counts")
    check(all(v == 0 for k, v in launches.items() if k not in want),
          "per-video pass: a kernel off its path ran")
    check(LEN_THRESHOLD in chunks["vit"] and LEN_THRESHOLD in chunks["swin"],
          "per-video pass: no full 48-frame chunk")
    with torch.inference_mode():  # the captured operands are inference tensors
        hold_chunk_operands(ops, card)
    return dict(path, vps=PER_VIDEO / elapsed)


def hold_chunk_operands(ops, card: str) -> None:
    """K1, K2 and B1 against their plain versions on the captured operands,
    at phase 2's bf16 bar."""
    real, ref, a = ops["K1"]
    b, l, c = a[0].shape
    compare(f"attn_proj_residual ViT bf16 [{b},{l},{c}] (a 48-frame chunk of the pass, {card})",
            lambda: real(*a), lambda: ref(*a), work=work_attn_proj(b, l, c, a[4], 2),
            dtype=torch.bfloat16, reps=3)
    real, ref, a = ops["K2"]
    m, c = a[0].shape
    compare(f"ln_mlp_residual ViT bf16 [{m},{c}] (the same chunk, {card})", lambda: real(*a),
            lambda: ref(*a), work=work_mlp(m, c, a[3].shape[0], 2), dtype=torch.bfloat16, reps=3)
    real, ref, a = ops["B1"]
    w, n, c = a[0].shape
    compare(f"swin_block stage1 bf16 [{w},{n},{c}] (the same chunk, SwinV2 member 1, {card})",
            lambda: real(*a), lambda: ref(*a), block=True,
            work=work_swin_block(w, n, c, a[16], 4 * c, a[17], 2), dtype=torch.bfloat16, reps=3)


def write_mp4(path: str, frames: np.ndarray, fps: int = 8) -> None:
    import cv2

    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                          (frames.shape[2], frames.shape[1]))
    for f in frames:
        out.write(np.ascontiguousarray(f[:, :, ::-1]))
    out.release()


def run_offline_flow(device, models, videos, backends, card: str) -> None:
    """(d) The offline flow on decoded frames, then (where the host has a
    decoder) `ref_cli` and `query_cli` from mp4 files with a tiny member
    (the full-width members ran on the same frames above)."""
    import copy as copy_mod
    import tempfile

    from vsc22_tpu_torch.core.storage import load_features
    from vsc22_tpu_torch.core.types import CandidatePair, Match
    from vsc22_tpu_torch.ops.pca import PCAModel
    from vsc22_tpu_torch.pipelines import clip_features, descriptor_eval, ensemble_cli
    from vsc22_tpu_torch.pipelines import query_cli, ref_cli
    from vsc22_tpu_torch.pipelines.query_extract import SCORE_THRESHOLD, DescriptorExtractor
    from vsc22_tpu_torch.pipelines.ref_extract import extract_references, merge_shards

    sets = {"train": [(f"R1{i:05d}", videos[i]) for i in OFFLINE_TRAIN],
            "test": [(f"R2{i:05d}", videos[i]) for i in OFFLINE_TEST]}
    queries = ([(f"Q{i:05d}", videos[OFFLINE_TEST[i]]) for i in range(OFFLINE_PLANTED)]
               + [(f"Q{i:05d}", videos[i]) for i in range(OFFLINE_PLANTED, PER_VIDEO)])
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        files = {}
        for name, model, size, preset in members(models):
            ext = DescriptorExtractor(model, size, preset, device=device)
            for split, vids in sets.items():
                prefix = os.path.join(root, f"{name}_{split}_refs")
                for k in range(2):
                    extract_references(vids, ext, prefix, process_index=k, process_count=2)
                files[name, split] = merge_shards(prefix)
        refs_s = time.perf_counter() - t0
        merged = load_features(files["vit", "test"])
        check([f.video_id for f in merged] == [v for v, _ in sets["test"]]
              and all(len(f) == 32 for f in merged), "merged ref shards")
        t0 = time.perf_counter()
        fused = os.path.join(root, "fused")
        names = [m[0] for m in members(models)]
        dim = sum(m[1].out_dim for m in members(models))
        ensemble_cli.main(["--train_refs", *(files[n, "train"] for n in names),
                           "--test_refs", *(files[n, "test"] for n in names),
                           "--out_dir", fused, "--components", str(min(512, dim))])
        # (the PCA fit runs on the card: the CLI's default)
        ens_s = time.perf_counter() - t0
        pca = PCAModel.load(os.path.join(fused, "pca_model.npz"))
        check(pca.components.shape == (min(512, dim), dim), f"PCA {pca.components.shape}")

        # The VED's video-score head shifted so that the median query scores
        # 0.5: with random weights the gate would otherwise drop every video
        # or none, by chance.
        vsm = copy_mod.deepcopy(models["vsm"])
        probe = per_video_pipeline(device, models, pca, vsm)
        logits = [float(np.log(p / (1 - p))) for p in
                  (min(max(probe.ved.score(list(v)), 1e-6), 1 - 1e-6) for _, v in queries)]
        with torch.no_grad():
            vsm.output_proj.bias -= float(np.median(logits))
        pipe = per_video_pipeline(device, models, pca, vsm, SCORE_THRESHOLD)
        t0 = time.perf_counter()
        q_path = query_cli.extract_queries(queries, pipe, names, os.path.join(root, "query"),
                                           "test", os.path.join(fused, "train_refs.npz"))
        query_s = time.perf_counter() - t0
        gt = [Match(f"Q{i:05d}", f"R2{OFFLINE_TEST[i]:05d}", 1.0, 0.0, 32.0, 0.0, 32.0)
              for i in range(OFFLINE_PLANTED)]
        gt_path = os.path.join(root, "gt.csv")
        Match.write_csv(gt, gt_path)
        t0 = time.perf_counter()
        res = descriptor_eval.run(q_path, os.path.join(fused, "test_refs_sn.npz"),
                                  os.path.join(root, "eval"), ground_truth=gt_path,
                                  device=device)
        eval_s = time.perf_counter() - t0
        best = {}
        for c in CandidatePair.read_csv(res.candidate_file):
            if c.score > best.get(c.query_id, (None, -np.inf))[1]:
                best[c.query_id] = (c.ref_id, c.score)
        gated = sorted(q for q, s in pipe.video_scores.items() if s < SCORE_THRESHOLD)
        ungated = [m for m in gt if m.query_id not in gated]
        wrong = [(m.query_id, m.ref_id, best.get(m.query_id)) for m in ungated
                 if best.get(m.query_id, (None,))[0] != m.ref_id]
        print(f"  (d) ref_extract, 4 members x (8 train + 8 test videos) in 2 shards each + "
              f"merge {refs_s:.1f} s; ensemble_cli (PCA 2048 -> 512 on the card, ref "
              f"score-norm) {ens_s:.1f} s; query_cli's query function on {len(queries)} videos "
              f"{query_s:.1f} s; descriptor_eval {eval_s:.1f} s ({card})", flush=True)
        print(f"  (d) VED gated {gated or 'none'} of {len(queries)}; candidate µAP "
              f"{res.candidate_uap:.4f} over {len(gt)} planted pairs; every planted, "
              f"ungated copy ({len(ungated)} of {len(gt)}) ranks its ref first: "
              f"{'yes' if not wrong else wrong} ({card})", flush=True)
        check(len(ungated) >= 1 and not wrong, "the offline flow: a planted copy missed")

        ext = clip_features.ClipFeatureExtractor(models["clip"], chunk=32, device=device)
        zip_path = clip_features.extract_clip_features(queries[:2], ext,
                                                       os.path.join(root, "feats.zip"))
        back = clip_features.read_feats_zip(zip_path)
        for vid, frames in queries[:2]:
            want = ext.extract(list(frames)).astype(np.float16).astype(np.float32)
            check(vid in back and np.array_equal(back[vid], want)
                  and want.shape == (len(frames), models["clip"].cfg.width),
                  f"clip_features zip: {vid}")
        print(f"  (d) clip_features: feats.zip of 2 videos read back equal "
              f"({[list(v.shape) for v in back.values()]}, f16; {card})", flush=True)

        if "opencv" not in backends:
            print("  (d) no decoder on this host: decoding mp4 files is covered by the CPU "
                  "tests only (tests/test_torch_offline_cli.py)", flush=True)
            return
        t0 = time.perf_counter()
        for split, vids in (("refs", sets["test"][:4]), ("queries", queries[:4])):
            os.makedirs(os.path.join(root, split))
            for vid, frames in vids:
                write_mp4(os.path.join(root, split, f"{vid}.mp4"), frames)
        spec = "vit_tiny_test:-:64:efficientnet"  # the decode and the CLIs' plumbing
        ref_out = ref_cli.main(["--videos", os.path.join(root, "refs"), "--out",
                                os.path.join(root, "cli_refs"), "--model", spec, "--fps", "8"])
        q_out = query_cli.main(["--videos", os.path.join(root, "queries"), "--out_dir",
                                os.path.join(root, "cli_query"), "--model", f"vit:{spec}",
                                "--norm_refs", ref_out, "--fps", "8"])
        got_r, got_q = load_features(ref_out), load_features(q_out)
        check(len(got_r) == 4 and len(got_q) == 4 and all(
            np.isfinite(f.feature).all() for f in got_r + got_q), "the CLIs from mp4 files")
        print(f"  (d) from mp4 files: ref_cli {len(got_r)} videos "
              f"({sum(len(f) for f in got_r)} frames), query_cli {len(got_q)} videos, "
              f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)


def phase_10(device, card: str, wrappers, models, pca, videos, noise) -> dict:
    print(f"phase 10: the per-video query path and the offline CLIs ({card})", flush=True)
    t0 = time.perf_counter()
    backends = probe_decoders()
    check_cv2_arithmetic(device, videos[6], card)
    launches = run_per_video(device, wrappers, models, pca, videos, noise, card)
    pipe = per_video_pipeline(device, models, pca, use_device_fsd_maps=True)
    pair = [videos[6], videos[7]]  # letterboxed, 2-up
    feats = [pipe.process_video(f"Q{i:06d}", list(v))[0] for i, v in zip((6, 7), pair)]
    exact, dev = zip(*(fsd_box_lists(list(v), device) for v in pair))
    check_fsd_setting("(c) per-video pipeline, use_device_fsd_maps=True", pair, list(dev),
                      list(exact), feats, card)
    del pipe
    run_offline_flow(device, models, videos, backends, card)
    torch.cuda.empty_cache()
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return launches


def check_fsd_setting(label: str, videos, boxes: list, other: list, feats, card: str) -> None:
    """A pipeline's other FSD setting (`use_device_fsd_maps`) on the
    letterboxed and the 2-up video: every box inside its frame, every row
    finite and 512-d; whether the boxes equal the default setting's."""
    boxes, other = ([[tuple(int(c) for c in b) for b in bx] for bx in x] for x in (boxes, other))
    for v, bx in zip(videos, boxes):
        h, w = v.shape[1], v.shape[2]
        check(len(bx) >= 1 and all(0 <= sh < eh <= h and 0 <= sw < ew <= w
                                   for sh, eh, sw, ew in bx),
              f"{label}: a box outside its {h}x{w} frame: {bx}")
    for f in feats:
        check(f.feature.ndim == 2 and f.feature.shape[1] == 512 and len(f.feature) > 0
              and bool(np.isfinite(f.feature).all()),
              f"{label}: bad rows {f.feature.shape}")
    print(f"  {label}: boxes {boxes} ({'equal to' if boxes == other else 'not'} the default "
          f"setting's {other}); {[f.feature.shape for f in feats]} finite rows ({card})",
          flush=True)


def fsd_box_lists(frames, device) -> tuple:
    """The FSD boxes of one video on its exact maps and on its device maps."""
    from vsc22_tpu_torch.data import fsd

    return tuple(fsd.image_process_boxes(frames, maps_fn(frames, device))[1]
                 for maps_fn in (fsd.variance_and_edges_host, fsd.variance_and_edges_device))


# --- phase 11: the descriptor trainer's CLI -----------------------------------------------
#
# `train/descriptor_cli.main` in process on a frame store that the port builds
# from JPEGs of phase 3's first CLI_VIDEOS synthetic videos (32 frames of
# 360x640 each): queries Q000000-Q000002, refs R000003-R000005, two planted
# copies in the GT csv (so `LabeledFramePairDataset` takes each of its
# branches), `configs/vit_v68.py` (ViT-B/32@384, bf16 with f32 masters) at
# phase 8(c)'s 48 pairs with FGM and EMA: one epoch of 4 steps, then a second
# run with `--epochs 2 --resume` (4 more). The gap between its images/s and
# phase 8(c)'s fixed-batch rate is the data layer's cost.

CLI_VIDEOS = 6
CLI_PAIRS = 48
CLI_STEPS = 4  # an epoch: 192 frames / 48
CLI_PLANTED = [  # (query, ref, query frames, ref frames): ref frames copied into the query
    (0, 3, (8, 24), (0, 16)),
    (1, 4, (0, 12), (10, 22)),
]


def cli_corpus(root: str, videos=None) -> tuple:
    """The frame store and GT csv of phase 11 (paths), from `videos` (phase
    3's, left as they are) or the same videos drawn anew."""
    from vsc22_tpu_torch.data.store import FrameStore
    from vsc22_tpu_torch.pipelines.preprocess import encode_jpegs

    if videos is None:
        videos = synth_videos(CLI_VIDEOS, 32, 360, 640)
    videos = [np.array(v) for v in videos[:CLI_VIDEOS]]
    names = [f"{'Q' if i < CLI_VIDEOS // 2 else 'R'}{i:06d}" for i in range(CLI_VIDEOS)]
    rows = ["query_id,ref_id,query_start,query_end,ref_start,ref_end"]
    for q, r, (qs, qe), (rs, re) in CLI_PLANTED:
        videos[q][qs:qe] = videos[r][rs:re]
        rows.append(f"{names[q]},{names[r]},{qs},{qe},{rs},{re}")
    with ThreadPoolExecutor(8) as pool:
        jpegs = list(pool.map(encode_jpegs, videos))
    store = os.path.join(root, "frames.rec")
    FrameStore.build(store, list(zip(names, jpegs)))
    gt = os.path.join(root, "gt.csv")
    with open(gt, "w") as f:
        f.write("\n".join(rows) + "\n")
    return store, gt


@contextlib.contextmanager
def cli_spy(cli):
    """What `descriptor_cli.main` does inside: each model input's device and
    batch (a forward pre-hook on the model it builds), its StageTimers, and
    its log records."""
    import logging

    seen = dict(inputs=[], timers=[], records=[])
    build, timer_cls = cli.build_backbone, cli.StageTimer

    def spied_build(*a, **k):
        model = build(*a, **k)
        model.register_forward_pre_hook(
            lambda mod, args: seen["inputs"].append((args[0].device.type, args[0].shape[0])))
        return model

    class Timer(timer_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["timers"].append(self)

    class Records(logging.Handler):
        def emit(self, record):
            if record.name == "descriptor_train":
                seen["records"].append(record)

    handler = Records()
    logging.getLogger().addHandler(handler)
    cli.build_backbone, cli.StageTimer = spied_build, Timer
    try:
        yield seen
    finally:
        cli.build_backbone, cli.StageTimer = build, timer_cls
        logging.getLogger().removeHandler(handler)


def cli_rate(records) -> float:
    """images/s over one run's steps after its first: the logged steps
    (`--print_freq 1`, each after a sync) by their log times."""
    times = [r.created for r in records if r.msg.startswith("Epoch %d Batch")]
    return (len(times) - 1) * 2 * CLI_PAIRS / (times[-1] - times[0])


def run_descriptor_cli(device, card: str, fixed_rate: float, corpus=None) -> None:
    """Phase 11 (see its constants); `fixed_rate` is phase 8(c)'s images/s,
    `corpus` the (store, gt) of `cli_corpus` (None: built here from videos
    drawn anew)."""
    import tempfile

    from vsc22_tpu_torch.models.layers import l2_normalize
    from vsc22_tpu_torch.models.vit import vit_base_patch32_384_descriptor
    from vsc22_tpu_torch.ops import attn_proj, mlp
    from vsc22_tpu_torch.train import descriptor_cli
    from vsc22_tpu_torch.train.checkpoint import CheckpointManager, load_params_snapshot

    kernels = (attn_proj.attn_proj_residual, mlp.ln_mlp_residual)
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "vit_v68.py")
    with tempfile.TemporaryDirectory() as root:
        store, gt = corpus or timed_cli_corpus(root, None)
        work = os.path.join(root, "run")
        argv = ["--config", config, "--store", store, "--work_dir", work, "--ann_path", gt,
                "--batch_size", str(CLI_PAIRS), "--num_workers", "8", "--do_ema", "--do_fgm",
                "--lr", "1e-4", "--print_freq", "1"]
        runs = []
        zero_counts(kernels)
        for extra in (["--epochs", "1"], ["--epochs", "2", "--resume"]):
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            with cli_spy(descriptor_cli) as seen:
                state = descriptor_cli.main(argv + extra)
            torch.cuda.synchronize(device)
            runs.append(dict(seen, state_step=state.step, wall=time.perf_counter() - t0,
                             peak=torch.cuda.max_memory_allocated(device) / 2**30))
            del state
        launches = counts(kernels)
        steps = [r.args for run in runs for r in run["records"]
                 if r.msg.startswith("Epoch %d Batch")]
        inputs = [x for run in runs for x in run["inputs"]]
        ckpts = CheckpointManager(os.path.join(work, "checkpoints")).all_steps()
        for i, run in enumerate(runs):
            split = run["timers"][0].as_dict()
            print(f"  run {i + 1} (--epochs {i + 1}{' --resume' if i else ''}): step "
                  f"{run['state_step']}, wall "
                  f"{run['wall']:.1f} s, {cli_rate(run['records']):.1f} images/s over the steps "
                  f"after its first ({2 * CLI_PAIRS} images a step, FGM: 2 passes); split "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
                  + f"; peak memory {run['peak']:.2f} GiB ({card})", flush=True)
        print(f"  phase 8(c)'s fixed noise batch at {CLI_PAIRS} pairs: {fixed_rate:.1f} images/s "
              f"({card})", flush=True)
        print(f"  losses {[round(a[2], 4) for a in steps]}; checkpoints {ckpts}; launches "
              f"{launches} ({len(steps)} steps); model inputs {len(inputs)}, devices "
              f"{sorted({d for d, _ in inputs})}, batches {sorted({b for _, b in inputs})}",
              flush=True)
        check(all(np.isfinite(a[2:]).all() for a in steps), "descriptor CLI: a loss not finite")
        check([a[:2] for a in steps] == [(e, b) for e in (0, 1) for b in range(CLI_STEPS)],
              f"descriptor CLI: logged steps {[a[:2] for a in steps]}")
        check(runs[0]["state_step"] == CLI_STEPS and runs[1]["state_step"] == 2 * CLI_STEPS,
              "descriptor CLI: the step counter")
        check(ckpts == [CLI_STEPS, 2 * CLI_STEPS], f"descriptor CLI: checkpoints {ckpts}")
        check(all(n == 24 * 2 * CLI_STEPS for n in launches.values()),
              f"descriptor CLI: K1 and K2 launches {launches}, not 24 a step")
        check(len(inputs) == 2 * 2 * CLI_STEPS and all(d == "cuda" and b == 2 * CLI_PAIRS
                                                        for d, b in inputs),
              "descriptor CLI: a batch did not reach the model on the card")
        gen = torch.Generator(device=device).manual_seed(5)
        images = torch.randn((8, 384, 384, 3), generator=gen, device=device)
        model = vit_base_patch32_384_descriptor(device=device)
        for e in (0, 1):
            snap = os.path.join(work, f"epoch_{e}_ema.npz")
            check(os.path.isfile(snap), f"descriptor CLI: {snap} missing")
            load_params_snapshot(snap, model)
            with torch.inference_mode():
                rows = l2_normalize(model(images).float())
            norms = torch.linalg.vector_norm(rows, dim=1)
            check(rows.shape == (8, 512) and bool(torch.isfinite(rows).all())
                  and bool(((norms - 1).abs() < 1e-3).all()),
                  f"descriptor CLI: epoch_{e}_ema.npz gives bad rows")
        print(f"  both EMA snapshots load into a VitDescriptor: finite unit-norm 512-d rows on "
              f"{len(images)} images", flush=True)
        del model, images
    torch.cuda.empty_cache()


def timed_cli_corpus(root: str, videos) -> tuple:
    t0 = time.perf_counter()
    corpus = cli_corpus(root, videos)
    print(f"  frame store of {CLI_VIDEOS} videos x 32 frames (JPEG, 360x640) and a GT csv "
          f"of {len(CLI_PLANTED)} planted pairs: {time.perf_counter() - t0:.1f} s", flush=True)
    return corpus


def phase_11(device, card: str, fixed_rate: float, root=None, videos=None):
    """Phase 11, on a frame store built under `root` from `videos` (phase
    13 trains on it too; returned) or, with no `root`, on its own."""
    print(f"phase 11: the descriptor trainer's CLI ({card})", flush=True)
    t0 = time.perf_counter()
    corpus = None if root is None else timed_cli_corpus(root, videos)
    run_descriptor_cli(device, card, fixed_rate, corpus)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)
    return corpus


# --- phase 12: reference checkpoints in, a member exported ------------------------------
#
# Each full-width member's weights written in the layout the reference ships
# (f32, as its checkpoints are), read back through `utils/port_weights` into
# a fresh module; then the ViT member exported with `utils/export` at the
# query pass's chunk.

CHUNK = 128  # frames: the batched query pass's chunk


def _host(t) -> torch.Tensor:
    return t.detach().float().cpu()


def _weight_bias(sd: dict, name: str, mod) -> None:
    """A Linear's or LayerNorm's weight, and its bias where it has one,
    under `name.`."""
    sd[f"{name}.weight"] = mod.weight
    if getattr(mod, "bias", None) is not None:
        sd[f"{name}.bias"] = mod.bias


def timm_sscd_layout(model) -> dict:
    """A `VitDescriptor` as the reference's v68 checkpoint: timm ViT keys
    under `backbone.` and the SSCD head (`embeddings.0.conv`, a Conv1d
    k=1; `embeddings.1`), behind the DDP prefix `module.backbone.model.`."""
    vit = model.backbone
    sd = {"backbone.patch_embed.proj.weight": vit.patch_embed.weight,
          "backbone.patch_embed.proj.bias": vit.patch_embed.bias,
          "backbone.cls_token": vit.cls_token, "backbone.pos_embed": vit.pos_embed}
    for i, blk in enumerate(vit.blocks):
        for name, mod in (("norm1", blk.norm1), ("attn.qkv", blk.attn.qkv),
                          ("attn.proj", blk.attn.proj), ("norm2", blk.norm2),
                          ("mlp.fc1", blk.mlp.fc1), ("mlp.fc2", blk.mlp.fc2)):
            _weight_bias(sd, f"backbone.blocks.{i}.{name}", mod)
    _weight_bias(sd, "backbone.norm", vit.norm)
    sd["embeddings.0.conv.weight"] = model.gem.proj.weight[:, :, None]
    sd["embeddings.0.conv.bias"] = model.gem.proj.bias
    _weight_bias(sd, "embeddings.1", model.head)
    return {f"module.backbone.model.{k}": _host(v) for k, v in sd.items()}


def augreg_layout(vit) -> dict:
    """A `VisionTransformer` as timm's AugReg npz (HWIO patch kernel, q, k
    and v kernels [C, H, hd], the output kernel [H, hd, C])."""
    c, h = vit.cfg.embed_dim, vit.cfg.num_heads
    n = lambda t: _host(t).numpy()  # noqa: E731
    npz = {"embedding/kernel": n(vit.patch_embed.weight.permute(2, 3, 1, 0)),
           "embedding/bias": n(vit.patch_embed.bias), "cls": n(vit.cls_token),
           "Transformer/posembed_input/pos_embedding": n(vit.pos_embed),
           "Transformer/encoder_norm/scale": n(vit.norm.weight),
           "Transformer/encoder_norm/bias": n(vit.norm.bias)}
    for i, blk in enumerate(vit.blocks):
        b = f"Transformer/encoderblock_{i}"
        for ln, mod in (("LayerNorm_0", blk.norm1), ("LayerNorm_2", blk.norm2)):
            npz[f"{b}/{ln}/scale"], npz[f"{b}/{ln}/bias"] = n(mod.weight), n(mod.bias)
        att = f"{b}/MultiHeadDotProductAttention_1"
        qkv_k, qkv_b = n(blk.attn.qkv.weight).T, n(blk.attn.qkv.bias)
        for j, name in enumerate(("query", "key", "value")):
            npz[f"{att}/{name}/kernel"] = qkv_k[:, j * c:(j + 1) * c].reshape(c, h, c // h)
            npz[f"{att}/{name}/bias"] = qkv_b[j * c:(j + 1) * c].reshape(h, c // h)
        npz[f"{att}/out/kernel"] = n(blk.attn.proj.weight).T.reshape(h, c // h, c)
        npz[f"{att}/out/bias"] = n(blk.attn.proj.bias)
        for d, fc in (("Dense_0", blk.mlp.fc1), ("Dense_1", blk.mlp.fc2)):
            npz[f"{b}/MlpBlock_3/{d}/kernel"] = n(fc.weight).T
            npz[f"{b}/MlpBlock_3/{d}/bias"] = n(fc.bias)
    return npz


def swinv2_layout(model) -> dict:
    """A `SwinTransformerV2` in the official (Microsoft) keys, with one of
    the torch buffers that the loader does not read."""
    sd = {"patch_embed.proj.weight": model.patch_embed.weight,
          "patch_embed.proj.bias": model.patch_embed.bias}
    _weight_bias(sd, "patch_embed.norm", model.patch_norm)
    for s, blocks in enumerate(model.stages):
        for i, blk in enumerate(blocks):
            t, a = f"layers.{s}.blocks.{i}", blk.attn
            sd.update({f"{t}.attn.logit_scale": a.logit_scale, f"{t}.attn.qkv.weight": a.qkv_weight,
                       f"{t}.attn.q_bias": a.q_bias, f"{t}.attn.v_bias": a.v_bias,
                       f"{t}.attn.relative_position_index": torch.zeros(1)})
            for name, mod in (("norm1", blk.norm1), ("norm2", blk.norm2),
                              ("attn.cpb_mlp.0", a.cpb_fc1), ("attn.cpb_mlp.2", a.cpb_fc2),
                              ("attn.proj", a.proj), ("mlp.fc1", blk.mlp.fc1),
                              ("mlp.fc2", blk.mlp.fc2)):
                _weight_bias(sd, f"{t}.{name}", mod)
        if s < len(model.merges):
            _weight_bias(sd, f"layers.{s}.downsample.reduction", model.merges[s].reduction)
            _weight_bias(sd, f"layers.{s}.downsample.norm", model.merges[s].norm)
    _weight_bias(sd, "norm", model.norm)
    _weight_bias(sd, "output_proj", model.output_proj)
    return {k: _host(v) for k, v in sd.items()}


def openai_clip_layout(model) -> dict:
    """A `CLIPVisual` as a whole OpenAI CLIP checkpoint's visual tower,
    under `visual.` (q|k|v rows in `in_proj_weight`; a projection the
    loader does not read)."""
    w = model.ln_pre.weight.shape[0]
    sd = {"conv1.weight": model.conv1.weight, "class_embedding": model.class_embedding,
          "positional_embedding": model.positional_embedding, "proj": torch.zeros(w, 768)}
    _weight_bias(sd, "ln_pre", model.ln_pre)
    _weight_bias(sd, "ln_post", model.ln_post)
    for i, blk in enumerate(model.blocks):
        t = f"transformer.resblocks.{i}"
        sd[f"{t}.attn.in_proj_weight"] = blk.attn.qkv.weight
        sd[f"{t}.attn.in_proj_bias"] = blk.attn.qkv.bias
        for name, mod in (("ln_1", blk.ln_1), ("ln_2", blk.ln_2), ("attn.out_proj", blk.attn.proj),
                          ("mlp.c_fc", blk.c_fc), ("mlp.c_proj", blk.c_proj)):
            _weight_bias(sd, f"{t}.{name}", mod)
    return {f"visual.{k}": _host(v) for k, v in sd.items()}


def bert_vsm_layout(model, vocab: int = 21128, positions: int = 512) -> dict:
    """A `VideoScoreModel` as the reference's MS checkpoint over
    chinese-roberta-wwm-ext (a BERT of `vocab` words and `positions`
    positions; [CLS]/[SEP] the word rows 101/102, token type 0 zero),
    behind `module.`."""
    hid = model.cfg.hidden
    word = torch.zeros(vocab, hid)
    word[101], word[102] = _host(model.cls_emb), _host(model.sep_emb)
    pos = torch.zeros(positions, hid)
    pos[:model.pos_embed.shape[0]] = _host(model.pos_embed)
    sd = {"bert.embeddings.word_embeddings.weight": word,
          "bert.embeddings.position_embeddings.weight": pos,
          "bert.embeddings.token_type_embeddings.weight": torch.zeros(2, hid)}
    _weight_bias(sd, "frame_proj.0", model.frame_proj)
    _weight_bias(sd, "frame_proj.1", model.frame_norm)
    _weight_bias(sd, "bert.embeddings.LayerNorm", model.emb_norm)
    for i, layer in enumerate(model.layers):
        t = f"bert.encoder.layer.{i}"
        for j, name in enumerate(("query", "key", "value")):
            sd[f"{t}.attention.self.{name}.weight"] = layer.attn.qkv.weight[j * hid:(j + 1) * hid]
            sd[f"{t}.attention.self.{name}.bias"] = layer.attn.qkv.bias[j * hid:(j + 1) * hid]
        for name, mod in (("attention.output.dense", layer.attn.proj),
                          ("attention.output.LayerNorm", layer.ln_attn),
                          ("intermediate.dense", layer.fc1), ("output.dense", layer.fc2),
                          ("output.LayerNorm", layer.ln_mlp)):
            _weight_bias(sd, f"{t}.{name}", mod)
    _weight_bias(sd, "output_proj", model.output_proj)
    return {f"module.{k}": _host(v) for k, v in sd.items()}


def same_weights(name: str, member, fresh) -> int:
    """Every parameter and buffer of `fresh` bit for bit `member`'s; the
    count of tensors compared."""
    want, got = member.state_dict(), fresh.state_dict()
    check(want.keys() == got.keys(), f"{name}: the fresh module's tensors differ in name")
    off = [k for k in want if want[k].dtype != got[k].dtype or not torch.equal(want[k], got[k])]
    check(not off, f"{name}: {len(off)} tensors read back differ, e.g. {off[:3]}")
    return len(want)


def round_trip(device, wrappers, models, root: str) -> None:
    """12(a): each member's weights through its reference layout, a file,
    and `utils/port_weights` into a fresh module: the same bits, and the
    same outputs on one full chunk (the ViT's and SwinV2's through K1, K2
    and B1, each launched as the depths say)."""
    from vsc22_tpu_torch.models import clip, swinv2, vit, vsm
    from vsc22_tpu_torch.utils import port_weights as pw

    gen = torch.Generator(device).manual_seed(12)
    dt = torch.bfloat16
    vit_m, swin_m = models["vit"], models["swins"][0]
    chunk = {s: torch.randn((CHUNK, s, s, 3), generator=gen, device=device).to(dt)
             for s in (vit_m.backbone.cfg.img_size, swin_m.cfg.img_size,
                       models["clip"].cfg.img_size)}
    feats = torch.randn((2, models["vsm"].cfg.max_frames, models["vsm"].cfg.feat_dim),
                        generator=gen, device=device).to(dt)
    cases = [  # name, member, its reference layout, the loader, a fresh module, input, launches
        ("ViT-B/32@384 (timm + SSCD)", vit_m, timm_sscd_layout, pw.port_vit_torch_state_dict,
         lambda: vit.vit_base_patch32_384_descriptor(dt, device),
         chunk[vit_m.backbone.cfg.img_size], dict(attn_proj_residual=12, ln_mlp_residual=12)),
        ("ViT-B/32@384 backbone (AugReg npz)", vit_m.backbone, augreg_layout,
         pw.port_vit_augreg_npz, lambda: vit.VisionTransformer(vit.VIT_BASE_PATCH32_384, dt, device),
         chunk[vit_m.backbone.cfg.img_size], dict(attn_proj_residual=12, ln_mlp_residual=12)),
        ("SwinV2-Base@256 (Microsoft)", swin_m, swinv2_layout, pw.port_swinv2_torch_state_dict,
         lambda: swinv2.swinv2_base_256_descriptor(dt, device), chunk[swin_m.cfg.img_size],
         dict(swin_block=24)),
        ("CLIP ViT-L/14 (OpenAI, visual.)", models["clip"], openai_clip_layout,
         pw.port_clip_torch_state_dict, lambda: clip.clip_vit_l14(dt, device),
         chunk[models["clip"].cfg.img_size], dict(attn_proj_residual=24, ln_mlp_residual=24)),
        ("VSM base (BERT, module.)", models["vsm"], bert_vsm_layout, pw.port_vsm_torch_state_dict,
         lambda: vsm.vsm_base(dt, device), feats, {}),
    ]
    for name, member, layout, port, fresh_of, x, want in cases:
        t0 = time.perf_counter()
        ref = layout(member)
        path = os.path.join(root, "ref.npz" if layout is augreg_layout else "ref.pt")
        if layout is augreg_layout:
            np.savez(path, **ref)
            ref = np.load(path)
        else:
            torch.save(ref, path)
            ref = torch.load(path, map_location="cpu", weights_only=True)
        size = os.path.getsize(path)
        fresh = port(ref, fresh_of())
        del ref
        os.remove(path)
        loaded = time.perf_counter() - t0
        n = same_weights(name, member, fresh)
        with torch.no_grad():
            want_out = member(x)
            zero_counts(wrappers)
            got_out = fresh(x)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts(wrappers).items() if v}
        check(launched == want, f"{name}: launches {launched}, expected {want}")
        check(torch.equal(got_out, want_out), f"{name}: outputs differ after the round trip")
        print(f"  (a) {name}: {n} tensors bit for bit, written, read back and ported in "
              f"{loaded:.2f} s ({size / 2**20:.0f} MiB file); outputs on {tuple(x.shape)} "
              f"bit for bit; launches {launched or 'none (no kernel)'}", flush=True)
        del fresh, want_out, got_out
    torch.cuda.empty_cache()


def export_member(device, wrappers, vit_m, card: str, root: str) -> None:
    """12(b): the ViT member exported at the query pass's chunk in bf16
    and reloaded: 12 K1 and 12 K2 nodes in the program, as many launches
    by the wrappers' counters, the eager member's output bit for bit, and
    another batch refused; export and load seconds, eager and exported ms
    per chunk."""
    import collections

    from vsc22_tpu_torch.utils.export import export_model, load_exported

    size = vit_m.backbone.cfg.img_size
    shape = (CHUNK, size, size, 3)
    t0 = time.perf_counter()
    params_path, path = export_model(os.path.join(root, "vit_b32"), vit_m, shape, torch.bfloat16)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    call = load_exported(path)
    load_s = time.perf_counter() - t0
    nodes = collections.Counter(str(n.target) for n in call.program.graph.nodes
                                if n.op == "call_function" and str(n.target).startswith("vsc22."))
    depth = vit_m.backbone.cfg.depth
    want = {"vsc22.attn_proj_residual.default": depth, "vsc22.ln_mlp_residual.default": depth}
    check(dict(nodes) == want, f"exported program's kernel nodes {dict(nodes)}, expected {want}")
    gen = torch.Generator(device).manual_seed(13)
    x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    with torch.no_grad():
        eager = vit_m(x)
    zero_counts(wrappers)
    got = call(x)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts(wrappers).items() if v}
    check(launched == dict(attn_proj_residual=depth, ln_mlp_residual=depth),
          f"the exported member's launches {launched}")
    check(torch.equal(got, eager), "the exported member's output differs from the eager one")
    try:
        call(x[:CHUNK // 2])
        check(False, "the exported member took another batch size")
    except ValueError:
        pass
    def eager_fwd(images):
        with torch.no_grad():
            return vit_m(images)

    ms = [cuda_ms(lambda f=f: f(x)) for f in (eager_fwd, call, call, eager_fwd)]  # in turns
    print(f"  (b) ViT-B/32@384 exported at {shape} bf16: program + params npz written in "
          f"{export_s:.2f} s ({os.path.getsize(path) / 2**20:.0f} + "
          f"{os.path.getsize(params_path) / 2**20:.0f} MiB), loaded in {load_s:.2f} s; "
          f"kernel nodes {dict(nodes)}; launches {launched}; output bit for bit; another "
          f"batch refused", flush=True)
    print(f"  (b) ms per {CHUNK}-frame chunk, in turns: eager {ms[0]:.3f}, exported {ms[1]:.3f}, "
          f"exported {ms[2]:.3f}, eager {ms[3]:.3f} on {card}", flush=True)


def phase_12(device, card: str, wrappers, models) -> None:
    import tempfile

    print(f"phase 12: reference checkpoints and the exported member ({card})", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        round_trip(device, wrappers, models, root)
        export_member(device, wrappers, models["vit"], card, root)
    torch.cuda.empty_cache()
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)


# --- phase 13: the legacy zoo --------------------------------------------------------
#
# The JAX registry's legacy members at their published widths with seeded
# weights: a forward of each, every K1, K2 and B7 call of it held to its
# plain version; `query_cli` with three of them; the descriptor CLI on
# Swin-T v1; two BYOL steps on MAE-B/16.

ZOO_IMAGES = 32  # a forward's batch of images
ZOO_CLI_PAIRS = 96  # the descriptor CLI's batch: 2 steps over phase 11's 192 frames
ZOO_BYOL_PAIRS = 16
ZOO_QUERY_VIDEOS = 2
ZOO_MEMBERS = (("swin1", "swin_v1_tiny_224", 224, 256), ("eff", "efficientnet_v2_s", 256, 256),
               ("mae", "mae_base_patch16_224", 224, 512))


@contextlib.contextmanager
def capture_calls(targets):
    """Every call of module.name for (module, name, label) in `targets`
    while the block runs, as (label, args); each call goes on as made."""
    seen = []

    def spy(real, label):
        def call(*args):
            seen.append((label, args))
            return real(*args)
        return call

    saved = [(m, n, getattr(m, n)) for m, n, _ in targets]
    for (m, n, label), (_, _, real) in zip(targets, saved):
        setattr(m, n, spy(real, label))
    try:
        yield seen
    finally:
        for m, n, real in saved:
            setattr(m, n, real)


def seeded(make, device, seed: int):
    from vsc22_tpu_torch.models.layers import reset_parameters

    model = make(device=device)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()


def zoo_cases(device):
    """(name, build the model, draw its inputs, call it, output shape,
    the K1, K2 and B7 launches its depth gives) of phase 13(a)."""
    from vsc22_tpu_torch.models import deconv, efficientnet, mae, swin_v1, text_encoder, vsm

    gen = torch.Generator(device=device).manual_seed(13)
    n = ZOO_IMAGES
    images = lambda size: (torch.randn((n, size, size, 3), generator=gen, device=device),)

    def text_inputs():
        ids = torch.randint(0, 21128, (16, 128), generator=gen, device=device)
        mask = torch.ones((16, 128), device=device)
        mask[8:, 96:] = 0.0  # half the batch padded past token 96
        return ids, mask

    def clips():
        feats = torch.randn((8, 256, 1024), generator=gen, device=device)
        feats[4:, 200:] = 0.0  # padding frames
        return (feats,)

    return [
        ("Swin-T v1@224 f32", lambda: seeded(swin_v1.swin_v1_tiny_224, device, 1),
         lambda: images(224), (n, 256), dict(fused_mlp=12)),
        ("EfficientNetV2-S@256 bf16", lambda: seeded(efficientnet.efficientnet_v2_s, device, 2),
         lambda: images(256), (n, 256), {}),
        ("MAE ViT-B/16@224 bf16", lambda: seeded(mae.mae_base_patch16_224, device, 3),
         lambda: images(224), (n, 512), dict(attn_proj_residual=12, ln_mlp_residual=12)),
        ("RoBERTa-base [16, 128] ids + mask bf16",
         lambda: seeded(text_encoder.roberta_base, device, 4), text_inputs, (16, 128, 768), {}),
        ("DeConv dim 2048 [4, 8, 8] f32", lambda: seeded(deconv.deconv_model, device, 5),
         lambda: (torch.randn((4, 8, 8, 2048), generator=gen, device=device),),
         (4, 256, 256, 3), {}),
        ("vsm_embed (MD) [8, 256, 1024] bf16", lambda: seeded(vsm.vsm_embed, device, 6), clips,
         (8, 256), {}),
    ]


def hold_zoo_calls(calls, card: str) -> dict:
    """Each captured K1, K2 and B7 call against its plain version under
    phase 2's bars (bf16: 2^-7 + 2 ulps and <= 2% differing; B7 f32: F32_TOL
    on 3xTF32); the first call of each shape timed (kernel, plain, its
    products as cuBLAS calls) with its routes named. Returns {kernel: the
    timed cases}."""
    from vsc22_tpu_torch.ops import attn_proj, mlp

    timed, out = set(), {}
    for label, args in calls:
        x = args[0]
        shape = (label, tuple(x.shape))
        if label == "fused_mlp":
            if shape not in timed:
                res = check_fused_mlp(args, f"Swin-T v1 (zoo, {card})")
            else:
                ok, err, share, _ = agreement(mlp.fused_mlp(*args), mlp.fused_mlp_reference(*args),
                                              F32_TOL)
                check(ok, f"fused_mlp {tuple(x.shape)}: kernel disagrees ({err}, {share})")
        elif label == "attn_proj_residual":
            qkv, pw, pb, h = args[1:]
            b, l, c = x.shape
            r, words = k1_routes(x, pw, h)
            check(r == dict(core="mma", proj="mma"), f"K1 MAE: routes {r}")
            if shape not in timed:
                rows = torch.randn((b * l, c), device=x.device).to(x.dtype)
                res = compare(f"attn_proj_residual MAE bf16 [{b},{l},{c}] h={h} ({words}, {card})",
                              lambda: attn_proj.attn_proj_residual(*args),
                              lambda: attn_proj.attn_proj_residual_reference(*args),
                              work=work_attn_proj(b, l, c, h, x.element_size()), dtype=x.dtype,
                              products_fn=lambda: torch.mm(rows, pw.t()), reps=5)
                res["routes"] = r
            else:
                ok, err, share, _ = agreement(attn_proj.attn_proj_residual(*args),
                                              attn_proj.attn_proj_residual_reference(*args), None)
                check(ok, f"attn_proj_residual {tuple(x.shape)}: kernel disagrees ({err}, {share})")
        else:
            w1, w2 = args[3], args[5]
            m, c = x.shape
            r, words = k2_routes(x, w1, w2)
            check(r == dict(ln="rows", fc1="mma", fc2="mma"), f"K2 MAE: routes {r}")
            if shape not in timed:
                hid = torch.randn((m, w1.shape[0]), device=x.device).to(x.dtype)
                res = compare(f"ln_mlp_residual MAE bf16 [{m},{c}] hidden={w1.shape[0]} ({words}, "
                              f"{card})", lambda: mlp.ln_mlp_residual(*args),
                              lambda: mlp.ln_mlp_residual_reference(*args),
                              work=work_mlp(m, c, w1.shape[0], x.element_size()), dtype=x.dtype,
                              products_fn=lambda: (torch.mm(x, w1.t()), torch.mm(hid, w2.t())),
                              reps=5)
                res["routes"] = r
            else:
                ok, err, share, _ = agreement(mlp.ln_mlp_residual(*args),
                                              mlp.ln_mlp_residual_reference(*args), None)
                check(ok, f"ln_mlp_residual {tuple(x.shape)}: kernel disagrees ({err}, {share})")
        if shape not in timed:
            timed.add(shape)
            out.setdefault(label, []).append(dict(res, case=f"{tuple(x.shape)} {dname(x.dtype)}"))
    return out


def run_zoo_forwards(device, wrappers, card: str) -> tuple:
    """13(a): each member's forward on its batch, its launches against its
    depth, its output's shape and finiteness, its ms; then every K1, K2 and
    B7 call held. Returns (the timed cases by kernel, launches by kernel)."""
    from vsc22_tpu_torch.models import layers

    targets = [(layers, "attn_proj_residual", "attn_proj_residual"),
               (layers, "ln_mlp_residual", "ln_mlp_residual"), (layers, "fused_mlp", "fused_mlp")]
    cases, total = {}, {}
    for name, build, draw, shape, want in zoo_cases(device):
        model, args = build(), draw()
        zero_counts(wrappers)
        with capture_calls(targets) as calls, torch.inference_mode():
            y = model(*args)
            torch.cuda.synchronize()
        launches = {k: v for k, v in counts(wrappers).items() if v}
        check(tuple(y.shape) == shape and bool(torch.isfinite(y.float()).all()),
              f"{name}: output {tuple(y.shape)}, finite {bool(torch.isfinite(y.float()).all())}")
        check(launches == want, f"{name}: launches {launches}, its depth gives {want}")
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(*args), reps=3)
        print(f"  (a) {name}: output {list(y.shape)} finite; forward {ms:.3f} ms (CUDA events, "
              f"median of 3); launches {launches or 'none of the kernels'} ({card})", flush=True)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        with torch.inference_mode():
            for k, v in hold_zoo_calls(calls, card).items():
                cases.setdefault(k, []).extend(v)
        del model, args, y, calls
        torch.cuda.empty_cache()
    return cases, total


def run_zoo_query_cli(device, wrappers, videos, card: str) -> dict:
    """13(b): `query_cli` with the three legacy descriptor members (seeded
    `-` weights, efficientnet preset) over 2 of phase 10's videos, from mp4
    files where the host decodes them (else its query function on the
    decoded frames); the output files read back."""
    import tempfile

    from vsc22_tpu_torch.core.storage import load_features, store_features
    from vsc22_tpu_torch.core.types import VideoFeature
    from vsc22_tpu_torch.data import frames
    from vsc22_tpu_torch.pipelines import query_cli
    from vsc22_tpu_torch.pipelines.query_extract import QueryPipeline

    specs = [f"{n}:{key}:-:{size}:efficientnet" for n, key, size, _ in ZOO_MEMBERS]
    dim = sum(d for *_, d in ZOO_MEMBERS)
    with tempfile.TemporaryDirectory() as root:
        rng = np.random.default_rng(13)
        noise = os.path.join(root, "noise.npz")
        store_features(noise, [VideoFeature(f"R{i:06d}", np.arange(8.0), rng.standard_normal(
            (8, dim)).astype(np.float32)) for i in range(16)])
        out_dir = os.path.join(root, "query")
        queries = [(f"Q{i:06d}", np.asarray(videos[i])) for i in range(ZOO_QUERY_VIDEOS)]
        zero_counts(wrappers)
        t0 = time.perf_counter()
        if "opencv" in frames.available_backends():
            os.makedirs(os.path.join(root, "videos"))
            for vid, v in queries:
                write_mp4(os.path.join(root, "videos", f"{vid}.mp4"), v)
            argv = ["--videos", os.path.join(root, "videos"), "--out_dir", out_dir,
                    "--norm_refs", noise, "--fps", "8"]
            for spec in specs:
                argv += ["--model", spec]
            fused = query_cli.main(argv)
            how = "query_cli.main from mp4 files"
        else:
            names, exts = zip(*(query_cli.build_extractor(sp, device) for sp in specs))
            pipe = QueryPipeline(list(exts), device=device)
            fused = query_cli.extract_queries(queries, pipe, list(names), out_dir, "test", noise)
            how = "query_cli's build_extractor + extract_queries on decoded frames (no decoder)"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in counts(wrappers).items() if v}
        got = load_features(fused)
        check(len(got) == ZOO_QUERY_VIDEOS and all(f.feature.shape[1] == dim and np.isfinite(
            f.feature).all() for f in got), "zoo query_cli: fused features")
        rows = {}
        for n, _, _, d in ZOO_MEMBERS:
            sub = load_features(os.path.join(out_dir, n, "test_query.npz"))
            check(len(sub) == ZOO_QUERY_VIDEOS and all(
                f.feature.shape[1] == d and len(f.feature) > 0 and np.isfinite(f.feature).all()
                for f in sub), f"zoo query_cli: member {n}'s features")
            rows[n] = sum(len(f.feature) for f in sub)
    k1, b7 = launches.get("attn_proj_residual", 0), launches.get("fused_mlp", 0)
    check(k1 > 0 and k1 % 12 == 0 and launches.get("ln_mlp_residual") == k1 and b7 > 0
          and b7 % 12 == 0, f"zoo query_cli: launches {launches}")
    print(f"  (b) {how}: {ZOO_QUERY_VIDEOS} videos x 3 members ({', '.join(specs)}) in "
          f"{wall:.1f} s, read back: fused {dim}-d, member rows {rows}; launches {launches} "
          f"({card})", flush=True)
    return launches


def run_zoo_descriptor_cli(device, card: str, corpus) -> dict:
    """13(c): the descriptor CLI for 2 steps on `swin_v1_tiny_224` (f32, B7
    forward and recompute VJP) from phase 11's frame store, a config at
    img_width 224; its EMA snapshot loaded into a fresh member."""
    import tempfile

    from vsc22_tpu_torch.models.layers import l2_normalize
    from vsc22_tpu_torch.models.swin_v1 import swin_v1_tiny_224
    from vsc22_tpu_torch.ops import mlp
    from vsc22_tpu_torch.train import descriptor_cli
    from vsc22_tpu_torch.train.checkpoint import load_params_snapshot

    store, gt = corpus
    with tempfile.TemporaryDirectory() as root:
        config = os.path.join(root, "swin_v1.py")
        with open(config, "w") as f:
            f.write('img_width = 224\npreprocess = "efficientnet"\n'
                    'model = dict(type="swin_v1_tiny_224")\n'
                    'data = dict(probs=(0.8, 0.2), crop=0.5)\n')
        work = os.path.join(root, "run")
        argv = ["--config", config, "--store", store, "--work_dir", work, "--ann_path", gt,
                "--batch_size", str(ZOO_CLI_PAIRS), "--num_workers", "8", "--epochs", "1",
                "--lr", "1e-4", "--print_freq", "1"]
        zero_counts((mlp.fused_mlp,))
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with cli_spy(descriptor_cli) as seen:
            state = descriptor_cli.main(argv)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        b7 = mlp.fused_mlp.launches
        steps = [r.args for r in seen["records"] if r.msg.startswith("Epoch %d Batch")]
        check(state.step == 2 and [a[:2] for a in steps] == [(0, 0), (0, 1)]
              and all(np.isfinite(a[2:]).all() for a in steps),
              f"zoo descriptor CLI: step {state.step}, logged {steps}")
        check(b7 == 12 * 2, f"zoo descriptor CLI: B7 launches {b7}, not 12 a step")
        check(all(d == "cuda" and b == 2 * ZOO_CLI_PAIRS for d, b in seen["inputs"]),
              f"zoo descriptor CLI: model inputs {seen['inputs']}")
        model = swin_v1_tiny_224(device=device)
        load_params_snapshot(os.path.join(work, "epoch_0_ema.npz"), model)
        gen = torch.Generator(device=device).manual_seed(14)
        with torch.inference_mode():
            rows = l2_normalize(model(torch.randn((4, 224, 224, 3), generator=gen,
                                                  device=device)).float())
        check(rows.shape == (4, 256) and bool(torch.isfinite(rows).all()),
              "zoo descriptor CLI: its snapshot gives bad rows")
        split = seen["timers"][0].as_dict()
    print(f"  (c) descriptor CLI, swin_v1_tiny_224 (f32) x {ZOO_CLI_PAIRS} pairs, 2 steps: losses "
          f"{[round(a[2], 4) for a in steps]}, B7 {b7} launches (12 a forward), wall {wall:.1f} s, "
          "split " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
          + f", peak memory {peak:.2f} GiB; its EMA snapshot loads ({card})", flush=True)
    del model, state
    torch.cuda.empty_cache()
    return dict(fused_mlp=b7)


def run_zoo_byol(device, card: str) -> dict:
    """13(d): two BYOL steps (`ByolConfig()`: hidden 4096, projection 256,
    EMA 0.99) on MAE-B/16@224 bf16 x 16 pairs, K1 and K2 with their VJPs;
    the target moves by exactly (1 - 0.99) of its gap to the new online
    weights (f32, to rounding)."""
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.models.mae import mae_base_patch16_224
    from vsc22_tpu_torch.ops import attn_proj, mlp
    from vsc22_tpu_torch.train import byol
    from vsc22_tpu_torch.train.contrastive import AdamW

    kernels = (attn_proj.attn_proj_residual, mlp.ln_mlp_residual)
    cfg = byol.ByolConfig()
    backbone = seeded(mae_base_patch16_224, device, 21)
    heads = byol.ByolHeads(backbone.out_dim, cfg, device)
    reset_parameters(heads, torch.Generator().manual_seed(22))
    tx = AdamW(lambda count: cfg.learning_rate, eps=1e-8)
    online, target, state = byol.init_byol(backbone, heads, tx)
    step = byol.make_byol_step(online, target, tx, cfg)
    gen = torch.Generator(device=device).manual_seed(23)
    size = backbone.backbone.cfg.img_size
    a, b = (torch.randn((ZOO_BYOL_PAIRS, size, size, 3), generator=gen, device=device)
            for _ in range(2))
    zero_counts(kernels)
    torch.cuda.reset_peak_memory_stats(device)
    losses, ms, worst = [], [], 0.0
    for _ in range(2):
        old = {k: v.clone() for k, v in state.target.items()}
        t0 = time.perf_counter()
        state, loss = step(state, a, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        for k, new in state.target.items():
            want = old[k] + (1.0 - cfg.ema_decay) * (state.online[k] - old[k])
            scale = old[k].abs() + state.online[k].abs()
            worst = max(worst, float(((new - want).abs() - 2e-7 * scale).max()))
    launches = counts(kernels)
    moved = sum(int((state.online[k] != state.target[k]).sum()) for k in state.target)
    check(all(np.isfinite(losses)), f"BYOL: losses {losses}")
    check(worst <= 1e-9, f"BYOL: the target left (1 - decay) of its gap by {worst}")
    check(moved > 0, "BYOL: the online weights never moved")
    check(all(n == 2 * 4 * 12 for n in launches.values()),
          f"BYOL: launches {launches}, not 12 a forward x 4 forwards a step")
    print(f"  (d) BYOL on MAE-B/16@224 bf16 (f32 masters) x {ZOO_BYOL_PAIRS} pairs, hidden "
          f"{cfg.hidden_size}, projection {cfg.projection_size}: losses "
          f"{[round(x, 4) for x in losses]}, step ms {[round(x, 1) for x in ms]} (host clock, "
          f"synchronised; the first includes warm-up), target = target + 0.01 (online - target) "
          f"to f32 rounding; launches {launches} (2 online + 2 target forwards a step); peak "
          f"memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB ({card})", flush=True)
    del online, target, state
    torch.cuda.empty_cache()
    return launches


def phase_13(device, card: str, wrappers, videos, corpus) -> tuple:
    """The legacy zoo; returns (13(a)'s timed K1, K2 and B7 cases by
    kernel, the phase's launches by kernel)."""
    print(f"phase 13: the legacy zoo ({card})", flush=True)
    t0 = time.perf_counter()
    cases, total = run_zoo_forwards(device, wrappers, card)
    for part in (run_zoo_query_cli(device, wrappers, videos, card),
                 run_zoo_descriptor_cli(device, card, corpus), run_zoo_byol(device, card)):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    print(f"  phase 13 launches {total}; took {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    return cases, total


# --- phase 14: the sharded paths (`vsc22_tpu_torch/parallel/`) on the card ---------

# The card host has one H100, and NCCL puts no two ranks of one communicator
# on one device: (a) is a world of one under NCCL at full width, (b) two gloo
# ranks sharing the card at a cut depth, so that the sharded code exchanges
# data between ranks while the hand kernels run. No multi-GPU time exists.
PAR_QUERY_VIDEOS = 8  # 14(a): 256 query rows of phase 5's corpus
PAR_ROW_K = 128
PAR_GLOBAL_K = 30_720  # 1200 hits a query video x 8, as the eval's budget scales
PAR_CHUNK = 128  # frames: one full extractor chunk
PAR_B_PAIRS = 4  # 14(b): the global batch, 2 pairs a rank
PAR_B_DEPTH = 2  # 14(b): ViT-B/32's widths at depth 2, f32
PAR_B_REFS = 65_536  # 14(b): 32,768 rows a shard, so B5's rule holds on each
PAR_B_FRAMES = 16  # 14(b): the extractor's frames, chunk 8


def par_grad_error(got, want) -> float:
    """The largest |got - want| per leaf over TRAIN_GRAD_TOL of that leaf's
    max |want| (leaves of rounding residue, under TRAIN_ROUNDING_GRAD of the
    largest |g|, measured against that floor): <= 1 passes."""
    top = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) / (TRAIN_GRAD_TOL * max(float(w.abs().max()),
                                                                   TRAIN_ROUNDING_GRAD * top))
               for g, w in zip(got, want))


def parallel_world_of_one(device, card: str, corpus) -> dict:
    """14(a): the NCCL path in a world of one, in this process, at full
    width: the sharded ViT-B/32 step's gradients against the unsharded
    step's on phase 8's model and batch (`torch_perf_train.setup`'s seeds),
    then one sharded step; the sharded row_topk and global_topk over phase
    5's corpus (f16, B5 on the shard) against the one-device searcher; the
    sharded extractor over one 128-frame chunk. Returns the launches."""
    import torch.distributed as dist
    from scripts.torch_perf_train import setup
    from vsc22_tpu_torch.ops.attn_proj import attn_proj_residual
    from vsc22_tpu_torch.ops.mlp import ln_mlp_residual
    from vsc22_tpu_torch.ops.topk import extract_topk
    from vsc22_tpu_torch.parallel.distributed import initialize
    from vsc22_tpu_torch.parallel.mesh import create_mesh
    from vsc22_tpu_torch.pipelines.query_extract import DescriptorExtractor
    from vsc22_tpu_torch.retrieval.search import SimilaritySearcher
    from vsc22_tpu_torch.train import contrastive as tc

    path = (attn_proj_residual, ln_mlp_residual, extract_topk)
    initialize(backend="nccl", world_size=1, rank=0, store=dist.HashStore(), device=device)
    try:
        mesh = create_mesh()
        launches = {}
        t0 = time.perf_counter()
        bench = setup("vit", 48, fgm=True, lr=1e-4, warmup_ratio=0.0)
        tx = tc.make_optimizer(bench.cfg)
        sharded = tc.make_train_step(bench.model, tx, bench.cfg, mesh=mesh)
        want_m, want = bench.step_fn.gradients(bench.batch, torch.Generator().manual_seed(5))
        zero_counts(path)
        got_m, got = sharded.gradients(bench.batch, torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
        launches["step"] = counts(path)
        diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"  14(a) sharded ViT-B/32 step, world of one (NCCL), 48 pairs, FGM: loss "
              f"{float(got_m['loss']):.6f} (unsharded {float(want_m['loss']):.6f}); gradients "
              f"max |sharded - unsharded| {diff:.3e} (bit for bit: {diff == 0.0}); "
              f"launches {launches['step']}", flush=True)
        check(diff == 0.0 and float(got_m["loss"]) == float(want_m["loss"]),
              "14(a): a world of one changed the step's arithmetic")
        check(launches["step"]["attn_proj_residual"] == 24
              and launches["step"]["ln_mlp_residual"] == 24, "14(a): K1/K2 launches a step")
        del want, got
        state, _ = tc.create_train_state(bench.model, bench.cfg, mesh=mesh)
        state, metrics = sharded(state, bench.batch, torch.Generator().manual_seed(6))
        check(state.step == 1 and bool(np.isfinite(float(metrics["loss"]))),
              "14(a): the sharded step's update")
        print(f"  14(a) step part {time.perf_counter() - t0:.1f} s", flush=True)

        t0 = time.perf_counter()
        queries, refs = corpus[0], corpus[1]
        r = np.concatenate([v.feature for v in refs]).astype(np.float16)  # shipped as f16
        q = np.concatenate([v.feature for v in queries[:PAR_QUERY_VIDEOS]])
        one = SimilaritySearcher(r, device=device, transfer_dtype=np.float16)
        shard = SimilaritySearcher(r, device=device, transfer_dtype=np.float16, mesh=mesh)
        zero_counts(path)
        got_rows = shard.row_topk(q, PAR_ROW_K)
        got_glob = shard.global_topk(q, PAR_GLOBAL_K)
        torch.cuda.synchronize()
        launches["search"] = counts(path)
        want_rows, want_glob = one.row_topk(q, PAR_ROW_K), one.global_topk(q, PAR_GLOBAL_K)
        same = (all(np.array_equal(a, b) for a, b in zip(got_rows, want_rows))
                and all(np.array_equal(a, b) for a, b in zip(got_glob, want_glob)))
        print(f"  14(a) sharded search over phase 5's corpus ({len(r)} refs x {r.shape[1]}, "
              f"f16): {len(q)} rows, row top-{PAR_ROW_K} and global top-{PAR_GLOBAL_K} equal "
              f"to the one-device searcher's: {same}; launches {launches['search']}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(same, "14(a): the sharded search differs from the one-device searcher")
        check(launches["search"]["extract_topk"] >= 1, "14(a): B5 never served the shard")
        del one, shard, r

        t0 = time.perf_counter()
        frames = list(synth_videos(1, PAR_CHUNK, 360, 640, seed=3)[0])
        ext = DescriptorExtractor(bench.model, 384, "vit", chunk=PAR_CHUNK, device=device)
        ext_sh = DescriptorExtractor(bench.model, 384, "vit", chunk=PAR_CHUNK, device=device,
                                     mesh=mesh)
        zero_counts(path)
        got_f = ext_sh.extract(frames)
        torch.cuda.synchronize()
        launches["extractor"] = counts(path)
        same = np.array_equal(got_f, ext.extract(frames))
        print(f"  14(a) sharded ViT-B/32 extractor, one {PAR_CHUNK}-frame bf16 chunk: "
              f"{got_f.shape}, equal to the unsharded extractor's: {same}; launches "
              f"{launches['extractor']}; {time.perf_counter() - t0:.1f} s", flush=True)
        check(same and launches["extractor"]["attn_proj_residual"] == 12,
              "14(a): the sharded extractor")
        del bench, state, sharded
        torch.cuda.empty_cache()
        return launches
    finally:
        dist.destroy_process_group()


def _parallel_rank(index: int, count: int, store_path: str) -> dict:
    """14(b), one rank of a gloo world sharing the card: the sharded step,
    search and extractor against this rank's one-rank results."""
    import dataclasses

    import torch.distributed as dist
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.models.vit import VIT_BASE_PATCH32_384, VitDescriptor
    from vsc22_tpu_torch.ops.attn_proj import attn_proj_residual
    from vsc22_tpu_torch.ops.mlp import ln_mlp_residual
    from vsc22_tpu_torch.ops.topk import extract_topk
    from vsc22_tpu_torch.parallel.distributed import initialize
    from vsc22_tpu_torch.parallel.mesh import batch_sharding, create_mesh
    from vsc22_tpu_torch.pipelines.query_extract import DescriptorExtractor
    from vsc22_tpu_torch.retrieval.search import SimilaritySearcher
    from vsc22_tpu_torch.train import contrastive as tc

    t0 = time.perf_counter()
    os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(backend="gloo", world_size=count, rank=index,
               store=torch.distributed.FileStore(store_path, count), device="cuda")
    path = (attn_proj_residual, ln_mlp_residual, extract_topk)
    out = {"launches": {}}
    try:
        device = torch.device("cuda", 0)
        mesh = create_mesh((count, 1))
        local = batch_sharding(mesh)
        cfg_m = dataclasses.replace(VIT_BASE_PATCH32_384, depth=PAR_B_DEPTH)
        model = VitDescriptor(cfg_m, dtype=torch.float32, device=device)
        reset_parameters(model, torch.Generator().manual_seed(21))
        gen = torch.Generator().manual_seed(22)
        batch = {k: torch.randn((PAR_B_PAIRS, 384, 384, 3), generator=gen).to(device)
                 for k in ("img_a", "img_b")}
        cfg = tc.ContrastiveConfig(learning_rate=1e-4, warmup_ratio=0.0, total_steps=10,
                                   fgm_epsilon=0.1)
        tx = tc.make_optimizer(cfg)
        _, want = tc.make_train_step(model, tx, cfg).gradients(batch, torch.Generator().manual_seed(5))
        zero_counts(path)
        step = tc.make_train_step(model, tx, cfg, mesh=mesh)
        _, got = step.gradients({k: local(v) for k, v in batch.items()},
                                torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
        out["launches"]["step"] = counts(path)
        out["grad_error"] = par_grad_error(got, want)

        rng = np.random.default_rng(23)
        refs = rng.standard_normal((PAR_B_REFS, 512), dtype=np.float32)
        refs /= np.linalg.norm(refs, axis=1, keepdims=True)
        q = refs[rng.integers(0, PAR_B_REFS, 256)] + rng.normal(0, 0.05, (256, 512)).astype(
            np.float32)
        one = SimilaritySearcher(refs, device=device, transfer_dtype=np.float16)
        zero_counts(path)
        shard = SimilaritySearcher(refs, device=device, transfer_dtype=np.float16, mesh=mesh)
        got_s, got_i = shard.row_topk(q, 10)
        torch.cuda.synchronize()
        out["launches"]["search"] = counts(path)
        want_s, want_i = one.row_topk(q, 10)
        out["search_equal"] = bool(np.array_equal(got_i, want_i)
                                   and np.abs(got_s - want_s).max() <= TOPK_TOL)

        frames = list(synth_videos(1, PAR_B_FRAMES, 360, 640, seed=4)[0])
        zero_counts(path)
        got_f = DescriptorExtractor(model, 384, "vit", chunk=8, device=device,
                                    mesh=mesh).extract(frames)
        torch.cuda.synchronize()
        out["launches"]["extractor"] = counts(path)
        want_f = DescriptorExtractor(model, 384, "vit", chunk=8, device=device).extract(frames)
        out["extractor_error"] = float(np.abs(got_f - want_f).max())
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        dist.destroy_process_group()


def parallel_gloo_pair(card: str) -> dict:
    """14(b): two gloo ranks spawned once, sharing the card; each rank's
    sharded results held to its one-rank results, K1, K2 and B5 launched
    on the card in both."""
    import tempfile

    from vsc22_tpu_torch.parallel.launcher import launch_local

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = launch_local(_parallel_rank, 2, args=(os.path.join(tmp, "store"),), timeout=300.0)
    for i, r in enumerate(got):
        print(f"  14(b) rank {i} of 2 (gloo, one card): ViT-B/32 widths at depth {PAR_B_DEPTH}, "
              f"f32, {PAR_B_PAIRS} pairs, FGM: gradient error {r['grad_error']:.3f} of the bar; "
              f"search {PAR_B_REFS} x 512 f16 equal: {r['search_equal']}; extractor max err "
              f"{r['extractor_error']:.2e}; launches {r['launches']}; {r['seconds']:.1f} s in "
              "the rank", flush=True)
        check(r["grad_error"] <= 1.0, f"14(b) rank {i}: sharded gradients")
        check(r["search_equal"], f"14(b) rank {i}: sharded search")
        check(r["extractor_error"] <= 1e-4, f"14(b) rank {i}: sharded extractor")
        for part, kernels in (("step", ("attn_proj_residual", "ln_mlp_residual")),
                              ("search", ("extract_topk",)),
                              ("extractor", ("attn_proj_residual", "ln_mlp_residual"))):
            check(all(r["launches"][part][k] > 0 for k in kernels),
                  f"14(b) rank {i}: {part} did not launch {kernels}")
    print(f"  14(b) took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return got[0]["launches"]


def phase_14(device, card: str, corpus) -> dict:
    """(b)'s ranks start (their interpreters and CUDA contexts take most
    of its time) while (a) runs in this process; returns (a)'s launches."""
    print(f"phase 14: the sharded paths ({card})", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        pair = pool.submit(parallel_gloo_pair, card)
        launches = parallel_world_of_one(device, card, corpus)
        pair.result()
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


LIBRARIES = ("attn_proj", "ln_mlp", "row_max", "window_attn", "swin_block", "extract_topk",
             "attn", "vit_block")
# name -> (source, the TPU kernel it replaces, the phase-2 case reported)
KERNELS = {
    "attn_proj_residual": ("vsc22_tpu_torch/csrc/attn_proj.cu",
                           "vsc22_tpu/ops/pallas_attn_proj.py:144", ("clip", "bf16")),
    "ln_mlp_residual": ("vsc22_tpu_torch/csrc/ln_mlp.cu",
                        "vsc22_tpu/ops/pallas_mlp.py:147", ("clip", "bf16")),
    "row_max_gemm": ("vsc22_tpu_torch/csrc/row_max.cu",
                     "vsc22_tpu/ops/pallas_sim.py:57", ("score_norm", "f32")),
    "swin_block": ("vsc22_tpu_torch/csrc/swin_block.cu",
                   "vsc22_tpu/ops/pallas_swin_block.py:387", ("stage3", "bf16")),
    "window_attention": ("vsc22_tpu_torch/csrc/window_attn.cu",
                         "vsc22_tpu/ops/pallas_window_attn.py:71", ("stage4", "f32")),
    "fused_mlp": ("vsc22_tpu_torch/csrc/ln_mlp.cu",
                  "vsc22_tpu/ops/pallas_mlp.py:70", ("stage4", "f32")),
    "extract_topk": ("vsc22_tpu_torch/csrc/extract_topk.cu",
                     "vsc22_tpu/ops/pallas_topk.py:83", ("D512", "f16")),
    "packed_attention": ("vsc22_tpu_torch/csrc/attn.cu",
                         "vsc22_tpu/ops/pallas_attn.py:82", ("clip", "bf16")),
    "ln_attn_proj_residual": ("vsc22_tpu_torch/csrc/attn_proj.cu",
                              "vsc22_tpu/ops/pallas_attn_proj.py:302", ("clip", "bf16")),
    "vit_block": ("vsc22_tpu_torch/csrc/vit_block.cu",
                  "vsc22_tpu/ops/pallas_vit_block.py:176", ("clip", "bf16")),
}


def timed_host_build() -> float:
    """Build (or load) the host library of the alignment methods; seconds."""
    from vsc22_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.host_library("vta_kernels")
    return time.perf_counter() - t0


def phase_9(device, card: str, tn_maps, tn_wall) -> None:
    print(f"phase 9: the matching trainers and the alignment methods ({card})", flush=True)
    t0 = time.perf_counter()
    run_matching_training(device, card, tn_maps, tn_wall)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)


def phase_took(n: int, t0: float) -> float:
    now = time.perf_counter()
    print(f"  phase {n} took {now - t0:.1f} s", flush=True)
    return now


def main(argv=None) -> int:
    """With `--training-only`, phases 1, 8, 9 and 11 alone (the train
    steps' checks and measurements, the trainer's CLI); with `--zoo-only`,
    phases 1 and 13 (on videos and a frame store drawn for it); with
    `--parallel-only`, phases 1 and 14 (on a corpus drawn as phase 5's);
    none prints the result lines."""
    args = sys.argv[1:] if argv is None else argv
    training_only = "--training-only" in args
    zoo_only = "--zoo-only" in args
    parallel_only = "--parallel-only" in args
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops.attn import packed_attention
    from vsc22_tpu_torch.ops.attn_proj import attn_proj_residual, ln_attn_proj_residual
    from vsc22_tpu_torch.ops.mlp import fused_mlp, ln_mlp_residual
    from vsc22_tpu_torch.ops.sim import row_max_gemm
    from vsc22_tpu_torch.ops.swin_block import swin_block
    from vsc22_tpu_torch.ops.topk import extract_topk
    from vsc22_tpu_torch.ops.vit_block import vit_block
    from vsc22_tpu_torch.ops.window_attn import window_attention
    from vsc22_tpu_torch.pipelines.batch_query import BatchedQueryPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    wrappers = (attn_proj_residual, ln_mlp_residual, row_max_gemm, swin_block,
                window_attention, fused_mlp, extract_topk, packed_attention,
                ln_attn_proj_residual, vit_block)
    t_start = time.perf_counter()

    print("phase 1: card and build", flush=True)
    print(card, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES) + 2) as pool:
        host = (None if training_only or zoo_only or parallel_only
                else pool.submit(prepare_host, device))
        host_lib = pool.submit(timed_host_build)
        list(pool.map(build.library, LIBRARIES))
        built = time.perf_counter() - t0
        host_lib_s = host_lib.result()
        host = None if host is None else host.result()
    for name in LIBRARIES:
        print(build.build_log(name), file=sys.stderr)
    print(f"  built {', '.join(LIBRARIES)} in {built:.1f} s; the host library vta_kernels "
          f"(g++, alignment) in {host_lib_s:.1f} s", flush=True)
    if host is not None:
        waited = time.perf_counter() - t0 - built
        print(f"  meanwhile on the host: the full-width slice's set-up {host['slice_s']:.1f} s, "
              f"the eval corpus {host['corpus_s']:.1f} s; waited {waited:.1f} s for them after "
              "the build", flush=True)
    if zoo_only:
        import tempfile

        with tempfile.TemporaryDirectory() as cli_root:
            videos = synth_videos(CLI_VIDEOS, 32, 360, 640)
            phase_13(device, card, wrappers, videos, timed_cli_corpus(cli_root, videos))
        print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if parallel_only:
        sizes = EVAL_SIZES
        phase_14(device, card, make_corpus(PAR_QUERY_VIDEOS, sizes["refs"], 0, sizes["frames"],
                                           sizes["dim"], 0))
        print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if training_only:
        print(f"phase 8: training on the card ({card})", flush=True)
        t0 = time.perf_counter()
        vit_res = run_training(device, card)
        print(f"  phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
        phase_9(device, card, None, None)
        phase_11(device, card, vit_res["train_images_per_sec"])
        print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0

    print(f"phase 2: kernels vs plain on the card ({card})", flush=True)
    t_phase = time.perf_counter()
    kres = check_kernels(device)
    kres.update(check_swin_kernels(device))
    kres.update(check_topk_kernel(device))
    kres.update(check_row_max_kernel(device))
    kres.update(check_block_kernels(device))
    t_phase = phase_took(2, t_phase)

    print(f"phase 3: the slice ({card})", flush=True)
    t0 = time.perf_counter()
    check_small_slice(device, wrappers)
    print(f"  (the small slice took {time.perf_counter() - t0:.1f} s)", flush=True)

    pipe, noise, models, videos, dev_videos = host.pop("slice")
    names = [f"Q{i:06d}" for i in range(len(videos))]
    print(f"  full-width set-up (weights, PCA fit, videos) {host['slice_s']:.1f} s, made during "
          "phase 1", flush=True)
    t0 = time.perf_counter()
    row_max_calls = capture_row_max_operands(
        lambda: run_slice(pipe, noise, names, videos, device, dev_videos))
    torch.cuda.synchronize()
    print(f"  warm-up pass {time.perf_counter() - t0:.2f} s", flush=True)
    check(len(row_max_calls) == 1, f"score-norm called K3 {len(row_max_calls)} times, not once")

    vit_chunks, clip_chunks = record_chunks(models["vit"]), record_chunks(models["clip"])
    swin_chunks = record_chunks(models["swins"][0])
    zero_counts(wrappers)
    t0 = time.perf_counter()
    feats, normed = run_slice(pipe, noise, names, videos, device, dev_videos)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counts(wrappers)

    for f in feats:
        check(f.feature.ndim == 2 and f.feature.shape[1] == 512 and len(f.feature) > 0,
              f"{f.video_id}: feature shape {f.feature.shape}")
        check(bool(np.isfinite(f.feature).all()), f"{f.video_id}: non-finite features")
    for f in normed:
        check(f.feature.shape[1] == 512 and bool(np.isfinite(f.feature).all()),
              f"{f.video_id}: bad score-normalized rows")
    per_pass = 12 * len(vit_chunks) + 24 * len(clip_chunks)
    swin_pass = 24 * len(swin_chunks) * 3
    print(f"  launches {launches}; ViT chunks {vit_chunks}, CLIP chunks {clip_chunks}, "
          f"SwinV2 chunks {swin_chunks} (x3 members) -> K1/K2 expected {per_pass} each, "
          f"B1 {swin_pass}, B6/B7 0 (bf16: every block fused), K3 >= 1", flush=True)
    check(128 in vit_chunks and 128 in clip_chunks and 128 in swin_chunks,
          "no full 128-frame chunk: phase 2 checked the kernels at a shape the pass never "
          "gave them")
    check(launches["attn_proj_residual"] == per_pass, "K1 launch count")
    check(launches["ln_mlp_residual"] == per_pass, "K2 launch count")
    check(launches["row_max_gemm"] >= 1, "K3 launch count")
    check(launches["swin_block"] == swin_pass, "B1 launch count")
    check(launches["window_attention"] == 0 and launches["fused_mlp"] == 0,
          "a bf16 SwinV2-Base block left the fused path")
    frames = sum(len(f.feature) for f in feats)
    print(f"  warm pass: {len(videos)} videos in {elapsed:.3f} s = "
          f"{len(videos) / elapsed:.3f} videos/s ({frames} kept frames) on {card}", flush=True)
    with k1_k2_routes() as calls:
        split = stage_split(pipe, lambda: run_slice(pipe, noise, names, videos, device,
                                                    dev_videos))
    print("  stage split (a third pass, synchronised at each stage edge): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()), flush=True)
    by_width = {(k, c): sum(1 for n, w, _ in calls if (n, w) == (k, c))
                for k, c, _ in calls}
    off_mma = [(k, c, r) for k, c, r in calls if any(v == "ffma" for v in r.values())]
    print(f"  K1/K2 calls of that pass by width (1024 CLIP, 768 ViT-B/32): {by_width}; "
          f"off the tensor-core loop: {len(off_mma)}", flush=True)
    check(sum(by_width.values()) == 2 * per_pass and not off_mma,
          f"a K1 or K2 call of the bf16 query pass left the tensor-core loop: {off_mma[:3]}")
    t0 = time.perf_counter()
    families = profile_pass(lambda: run_slice(pipe, noise, names, videos, device, dev_videos))
    print(f"  (profiling that pass and processing its trace took {time.perf_counter() - t0:.1f} s)",
          flush=True)
    want_mma = 3 * per_pass + 3 * swin_pass
    print(f"  profiled launches: gemm_mma_kernel {families['gemm_mma_kernel'][1]} (K1 + 2 K2 + "
          f"3 B1 = {want_mma}), ln_rows_kernel {families['ln_rows_kernel'][1]} (K2 {per_pass}), "
          f"gemm_bias_act_kernel {families['gemm_bias_act_kernel'][1]} (0)", flush=True)
    check(families["gemm_bias_act_kernel"][1] == 0,
          "the bf16 query pass ran the FFMA GEMM tile (gemm_bias_act_kernel)")
    check(families["gemm_mma_kernel"][1] == want_mma
          and families["ln_rows_kernel"][1] == per_pass,
          "the bf16 query pass's tensor-core and LN-rows launches")

    # The matching track's stage 1: the same members without the VED gate.
    stage1 = BatchedQueryPipeline(pipe.extractors, pca=pipe.pca, ved=None, use_fsd=True,
                                  out_dim=512, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stage1_feats = stage1.process_many(names, videos, batch=24, device_videos=dev_videos)
    torch.cuda.synchronize()
    stage1_vps = len(videos) / (time.perf_counter() - t0)
    check(all(f.feature.shape[1] == 512 and bool(np.isfinite(f.feature).all())
              for f in stage1_feats), "matching stage 1: bad features")
    print(f"  matching_stage1 (the same extractors and PCA, ved=None, one warm pass): "
          f"{stage1_vps:.3f} videos/s on {card}", flush=True)
    exact = BatchedQueryPipeline(pipe.extractors, pca=pipe.pca, ved=None, use_fsd=True,
                                 use_device_fsd_maps=False, out_dim=512, device=device)
    pair, dev_pair = videos[6:8], dev_videos[6:8]  # letterboxed, 2-up
    check_fsd_setting("batched pipeline, use_device_fsd_maps=False", pair,
                      exact._fsd_boxes(pair, dev_pair, [1.0, 1.0]),
                      stage1._fsd_boxes(pair, dev_pair, [1.0, 1.0]),
                      exact.process_batch(names[6:8], pair, device_videos=dev_pair), card)
    del stage1, stage1_feats, exact

    # K3 on the very operands score-norm gave it in the warm-up pass.
    q, r = row_max_calls[0]
    kres[("row_max_gemm", "score_norm", "f32")] = check_row_max(
        "score_norm f32 (the pass's own operands)", q, r)
    ved = pipe.ved  # phase 6 runs the VED gate again, on each CLIP block path
    pca = pipe.pca  # phase 10 runs the per-video path on the same models and PCA
    del pipe, row_max_calls, q, r
    torch.cuda.empty_cache()
    t_phase = phase_took(3, t_phase)

    print(f"phase 4: the SwinV2 block paths ({card})", flush=True)
    path_launches = check_swin_paths(device, wrappers)
    launches["window_attention"] = path_launches["window_attention"]
    launches["fused_mlp"] = path_launches["fused_mlp"]
    t_phase = phase_took(4, t_phase)

    print(f"phase 5: the descriptor-track eval path ({card})", flush=True)
    eval_launches, corpus, (tn_maps, tn_wall) = run_eval(device, wrappers, card,
                                                         host.pop("corpus"), host["corpus_s"])
    launches["extract_topk"] = eval_launches["extract_topk"]
    phase_took(5, t_phase)

    print(f"phase 6: the CLIP block variants ({card})", flush=True)
    t0 = time.perf_counter()
    launches.update(check_clip_paths(device, wrappers, ved, dev_videos, card))
    print(f"  phase 6 took {time.perf_counter() - t0:.1f} s", flush=True)
    del ved, dev_videos

    print(f"phase 7: the matching track ({card})", flush=True)
    t0 = time.perf_counter()
    launches["extract_topk"] += run_matching(device, wrappers, card, corpus, stage1_vps)
    eval_corpus = corpus  # phase 14 searches it again
    torch.cuda.empty_cache()
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"phase 8: training on the card ({card})", flush=True)
    t0 = time.perf_counter()
    vit_res = run_training(device, card)
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    phase_9(device, card, tn_maps, tn_wall)
    per_video = phase_10(device, card, wrappers, models, pca, videos, noise)
    phase_12(device, card, wrappers, models)
    del models, pca, noise
    import tempfile

    with tempfile.TemporaryDirectory() as cli_root:
        corpus = phase_11(device, card, vit_res["train_images_per_sec"], cli_root, videos)
        zoo_cases_by_kernel, zoo_launches = phase_13(device, card, wrappers, videos, corpus)
    del videos
    par_launches = phase_14(device, card, eval_corpus)
    del eval_corpus

    kernels = []
    check(all(launches[name] > 0 for name in KERNELS), f"a kernel never ran: {launches}")
    for name, (src, replaces, (tag, dn)) in KERNELS.items():
        r = kres[(name, tag, dn)]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], case=f"{tag} {dn}",
            launches_per_video=per_video.get(name, 0),
            zoo_launches=zoo_launches.get(name, 0),
            parallel_launches={part: c.get(name, 0) for part, c in par_launches.items()},
            **{k: r[k] for k in ("products_cublas_ms", "ln_rows_ms", "routes", "loop")
               if k in r},
        ))
        if name in zoo_cases_by_kernel:
            kernels[-1]["zoo_cases"] = [
                {k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "products_cublas_ms", "routes") if k in c}
                for c in zoo_cases_by_kernel[name]]
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
