"""The descriptor trainer learns: a convergence run of the PyTorch port.

The twin of `scripts/learning_demo.py`. On a procedurally drawn image corpus
(the same numpy seeds and drawing code), the port's `descriptor_cli` trains
the tiny SwinV2 at 64^2 (32-d output, window 8) with EMA and FGM, in two
segments: `--epochs_a` epochs, then a `--resume` to `--epochs_b`. The
retrieval µAP of hard-augmented held-out queries (overlays, stacks, crops,
mixup: `data/augment.build_hard_pipelines`) against the held-out images is
measured before training (the CLI's own seeded init), after it, and for
the EMA weights, and written to `--out_md` beside the loss trace and the
card's name and power limit.

    python scripts/torch_learning_demo.py                  # on the card
    python scripts/torch_learning_demo.py --device cpu --n_train 24 --n_val 8 \
        --epochs_a 1 --epochs_b 2 --batch_size 8 --out_md /tmp/demo.md   # a CPU smoke

On the card it asserts that training raised the µAP by at least
`--min_gain`. Run as a script, the last line of its output is one JSON
object with the numbers. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The demo's model: the tiny SwinV2 with the JAX demo's registry overrides.
MODEL_OVERRIDES = ["model.type=swinv2_tiny_test", "model.output_dim=32", "model.img_size=64",
                   "model.window_size=8", "img_width=64"]
WIDTH = 64  # 64^2 keeps the hard augmentations' structure visible
SEED = 1234  # descriptor_cli's default --seed: the init it trains from


def make_image(rng: np.random.Generator, size: int = 128) -> np.ndarray:
    """A structured, diverse procedural image (gradient + shapes + texture)."""
    import cv2

    c0 = rng.integers(0, 256, 3).astype(np.float32)
    c1 = rng.integers(0, 256, 3).astype(np.float32)
    ramp = np.linspace(0, 1, size, dtype=np.float32)
    axis = rng.integers(0, 2)
    grad = ramp[:, None] if axis == 0 else ramp[None, :]
    img = (c0 * (1 - grad[..., None]) + c1 * grad[..., None]).astype(np.uint8)
    img = np.ascontiguousarray(np.broadcast_to(img, (size, size, 3)))
    for _ in range(int(rng.integers(3, 8))):
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        kind = rng.integers(0, 3)
        if kind == 0:
            cv2.circle(img, tuple(int(v) for v in rng.integers(10, size - 10, 2)),
                       int(rng.integers(6, size // 3)), color, -1)
        elif kind == 1:
            p0 = rng.integers(0, size - 20, 2)
            p1 = p0 + rng.integers(10, size // 2, 2)
            cv2.rectangle(img, tuple(int(v) for v in p0), tuple(int(v) for v in p1), color, -1)
        else:
            cv2.line(img, tuple(int(v) for v in rng.integers(0, size, 2)),
                     tuple(int(v) for v in rng.integers(0, size, 2)), color,
                     int(rng.integers(2, 6)))
    noise = rng.normal(0, 8, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def encode_jpg(img: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 92])
    assert ok
    return buf.tobytes()


def build_corpus(work_dir: str, n_train: int, n_val: int, seed: int = 0):
    """(frame store path of the training images, the held-out images)."""
    from vsc22_tpu_torch.data.store import FrameStore

    rng = np.random.default_rng(seed)
    imgs = [make_image(rng) for _ in range(n_train + n_val)]
    store_path = os.path.join(work_dir, "train_frames.rec")
    FrameStore.build(store_path, [(f"T{i:06d}", [encode_jpg(imgs[i])]) for i in range(n_train)])
    return store_path, imgs[n_train:]


def hard_queries(val_imgs, seed: int = 42):
    """(hard-augmented queries of every other held-out image, their
    sources' indices), drawn as the JAX demo draws them."""
    from vsc22_tpu_torch.data.augment import build_hard_pipelines

    rng = np.random.default_rng(seed)
    pipelines = build_hard_pipelines(WIDTH, 0.8, 0.1,
                                     lambda r: val_imgs[int(r.integers(len(val_imgs)))])
    gt_idx = list(range(0, len(val_imgs), 2))
    return [pipelines[int(rng.integers(len(pipelines)))](val_imgs[g], rng) for g in gt_idx], gt_idx


@torch.inference_mode()
def descriptors(model, images, device, batch: int = 32) -> np.ndarray:
    from vsc22_tpu_torch.data.datasets import _resize_norm_host

    x = np.stack([_resize_norm_host(im, WIDTH, "vit") for im in images])
    f = np.concatenate([model(torch.from_numpy(x[s:s + batch]).to(device)).float().cpu().numpy()
                        for s in range(0, len(x), batch)])
    return f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)


def retrieval_uap(q_feats, r_feats, gt_idx) -> float:
    """µAP of ranked (query, ref) cosine candidates; GT = source image."""
    from vsc22_tpu_torch.core.metrics import average_precision
    from vsc22_tpu_torch.core.types import CandidatePair

    sims = q_feats @ r_feats.T
    k = min(20, sims.shape[1])
    top = np.argsort(-sims, axis=1)[:, :k]
    preds = [CandidatePair(query_id=f"Q{q:05d}", ref_id=f"R{r:05d}", score=float(sims[q, r]))
             for q in range(sims.shape[0]) for r in top[q]]
    gt = [CandidatePair(query_id=f"Q{q:05d}", ref_id=f"R{g:05d}", score=1.0)
          for q, g in enumerate(gt_idx)]
    return average_precision(gt, preds).ap


def card_line(device) -> str:
    if device.type != "cuda":
        return "the CPU (no card)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[device.index or 0] if out else torch.cuda.get_device_name(device)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(device)


def model_at(weights, device):
    """The demo's model with `weights` (masters by parameter name; None: the
    CLI's seeded init)."""
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.models.swinv2 import swinv2_tiny_test_descriptor
    from vsc22_tpu_torch.train.contrastive import load_masters

    model = swinv2_tiny_test_descriptor(device=device, output_dim=32, img_size=WIDTH,
                                        window_size=8)
    reset_parameters(model, torch.Generator().manual_seed(SEED))
    if weights is not None:
        load_masters(model, weights)
    return model.eval()


def read_losses(log_path: str):
    """(epoch, batch, loss) of every logged step, and the step the resumed
    run started from, from the CLI's log."""
    losses, resumed = [], None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Epoch (\d+) Batch (\d+) Loss ([\d.]+)", line)
            if m:
                losses.append((int(m.group(1)), int(m.group(2)), float(m.group(3))))
            m = re.search(r"resumed from step (\d+)", line)
            if m:
                resumed = int(m.group(1))
    return losses, resumed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work_dir", default=None, help="default: a temporary directory")
    ap.add_argument("--n_train", type=int, default=1200)
    ap.add_argument("--n_val", type=int, default=300)
    ap.add_argument("--epochs_a", type=int, default=16, help="first run segment")
    ap.add_argument("--epochs_b", type=int, default=48, help="resumed total epochs")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--lr", default="4e-4")
    ap.add_argument("--print_freq", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--min_gain", type=float, default=0.076,
                    help="on the card: the least µAP gain of training over the init")
    ap.add_argument("--out_md", default=os.path.join(ROOT, "docs", "torch_learning_demo.md"))
    return ap.parse_args(argv)


def run(args, work_dir: str) -> dict:
    from vsc22_tpu_torch.core.device import resolve
    from vsc22_tpu_torch.train import descriptor_cli

    device = resolve(args.device)
    t0 = time.perf_counter()
    store_path, val_imgs = build_corpus(work_dir, args.n_train, args.n_val)
    queries, gt_idx = hard_queries(val_imgs)
    corpus_s = time.perf_counter() - t0
    print(f"corpus: {args.n_train} train / {args.n_val} val images, {len(queries)} hard "
          f"queries ({corpus_s:.1f} s)", flush=True)

    def uap(model):
        return retrieval_uap(descriptors(model, queries, device),
                             descriptors(model, val_imgs, device), gt_idx)

    uap_untrained = uap(model_at(None, device))
    print(f"untrained µAP: {uap_untrained:.4f}", flush=True)
    cli = ["--config", os.path.join(ROOT, "configs", "tiny_smoke.py"), "--store", store_path,
           "--work_dir", work_dir, "--batch_size", str(args.batch_size), "--num_workers",
           str(args.num_workers), "--lr", str(args.lr), "--entropy_weight", "10", "--do_ema",
           "--do_fgm", "--print_freq", str(args.print_freq), "--seed", str(SEED),
           "--device", args.device] + MODEL_OVERRIDES
    t0 = time.perf_counter()
    first = descriptor_cli.main(cli + ["--epochs", str(args.epochs_a)])
    saved_step = first.step
    del first
    state = descriptor_cli.main(cli + ["--epochs", str(args.epochs_b), "--resume"])
    train_s = time.perf_counter() - t0
    uap_trained = uap(model_at(state.params, device))
    uap_ema = uap(model_at(state.ema_params, device)) if state.ema_params is not None else None
    losses, resumed = read_losses(os.path.join(work_dir, "log.txt"))
    print(f"trained µAP: {uap_trained:.4f}  ema µAP: {uap_ema}", flush=True)
    return dict(device=card_line(device), n_train=args.n_train, n_val=args.n_val,
                epochs_a=args.epochs_a, epochs_b=args.epochs_b, saved_step=saved_step,
                resumed_from=resumed, final_step=state.step, uap_untrained=uap_untrained,
                uap_trained=uap_trained, uap_ema=uap_ema, losses=losses, corpus_s=corpus_s,
                train_s=train_s, images_per_s=2 * args.batch_size * state.step / train_s)


def write_table(res: dict, path: str) -> None:
    losses = res["losses"]
    steps = res["final_step"]
    with open(path, "w") as f:
        f.write("# Learning demonstration of the PyTorch port (synthetic corpus, real trainer)\n\n")
        f.write(f"Generated by `scripts/torch_learning_demo.py` on {res['device']}: the\n"
                "port's `descriptor_cli` (EMA + FGM, entropy weight 10, lr 4e-4) trains the\n"
                "tiny SwinV2 at 64^2 (32-d, window 8) on "
                f"{res['n_train']} procedural images, {res['epochs_a']}\n"
                f"epochs, then resumes from step {res['resumed_from']} to epoch "
                f"{res['epochs_b']} (step {steps}).\n"
                "Queries are hard-pipeline augmentations of "
                f"{len(range(0, res['n_val'], 2))} of the {res['n_val']} held-out images;\n"
                "the refs are all held-out images. `scripts/learning_demo.py` is the JAX\n"
                "twin (`docs/learning_demo.md`).\n\n")
        f.write("| model | retrieval µAP (canonical) |\n|---|---|\n")
        f.write(f"| untrained (the CLI's seeded init) | {res['uap_untrained']:.4f} |\n")
        f.write(f"| trained | {res['uap_trained']:.4f} |\n")
        if res["uap_ema"] is not None:
            f.write(f"| trained (EMA, decay 0.999) | {res['uap_ema']:.4f} |\n")
        f.write(f"\nTraining took {res['train_s']:.1f} s for {steps} steps "
                f"({res['images_per_s']:.1f} images/s, both views counted, data\n"
                "loading included); drawing the corpus took "
                f"{res['corpus_s']:.1f} s.\n")
        if res["uap_ema"] is not None:
            f.write(f"\nThe EMA average still weighs the init by 0.999^{steps} = "
                    f"{0.999 ** steps:.2f}, so its µAP lags the\ntrained weights at this run "
                    "length.\n")
        f.write("\n## Loss trace (per logged step)\n\n```\n")
        if losses:
            f.write(f"first logged loss: {losses[0][2]:.3f}   last: {losses[-1][2]:.3f}\n")
        for e, b, loss in losses:
            f.write(f"epoch {e:3d} batch {b:3d}  loss {loss:.3f}\n")
        f.write("```\n")


def main(argv=None) -> dict:
    args = parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        work_dir = args.work_dir or tmp
        os.makedirs(work_dir, exist_ok=True)
        res = run(args, work_dir)
    if args.out_md:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_md)), exist_ok=True)
        write_table(res, args.out_md)
        print(f"wrote {args.out_md}", flush=True)
    if res["resumed_from"] != res["saved_step"]:
        raise SystemExit(f"the resumed run started from step {res['resumed_from']}, not the "
                         f"saved step {res['saved_step']}")
    gain = res["uap_trained"] - res["uap_untrained"]
    if args.device != "cpu" and gain < args.min_gain:
        raise SystemExit(f"training raised the µAP by {gain:.4f}, less than {args.min_gain}")
    return res


if __name__ == "__main__":
    print(json.dumps({k: v for k, v in main().items() if k != "losses"}), flush=True)
