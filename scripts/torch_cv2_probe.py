"""CPU probe of the port's own OpenCV arithmetic against OpenCV.

    python scripts/torch_cv2_probe.py [--shapes 60]

1. resize: `transforms.resize_cubic_u8` against `cv2.resize(...,
   INTER_CUBIC)` on seeded random uint8 frames of `--shapes` random
   (in, out) shapes, 8 to 399 pixels a side: the values that differ from
   OpenCV's generic route (IPP off), and from its IPP route (IPP on, the
   default) at 360x640 -> 384^2.
2. canny: `fsd.canny_edges` against `cv2.Canny(frame, 50, 400)` on the 20
   edge frames of each kind of `chip_smoke.synth_videos` at 360x640 (plain,
   letterboxed, a 2-up stack): the pixels that differ, and the hysteresis
   rounds each video needed.

One JSON line per probe. Needs OpenCV; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def resize(n_shapes: int) -> dict:
    import cv2

    from vsc22_tpu_torch.data.transforms import resize_cubic_u8

    rng = np.random.default_rng(1)
    saved = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        differ = total = 0
        for _ in range(n_shapes):
            h, w, oh, ow = (int(v) for v in rng.integers(8, 400, 4))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
            got = resize_cubic_u8(torch.from_numpy(img), oh, ow).numpy()
            differ += int((got != want).sum())
            total += want.size
        cv2.ipp.setUseIPP(True)
        img = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
        want = cv2.resize(img, (384, 384), interpolation=cv2.INTER_CUBIC).astype(int)
    finally:
        cv2.ipp.setUseIPP(saved)
    got = resize_cubic_u8(torch.from_numpy(img), 384, 384).numpy().astype(int)
    return dict(probe="resize", cv2=cv2.__version__, shapes=n_shapes, values=total,
                differ_ipp_off=differ, share_differ_ipp_on_360x640_to_384=float(
                    (got != want).mean()), max_level_ipp_on=int(np.abs(got - want).max()))


def canny() -> dict:
    import cv2

    import chip_smoke
    from vsc22_tpu_torch.data import fsd

    rounds = []
    real = fsd._run_flood
    calls = [0]

    def counting(s, w, dim):
        calls[0] += 1
        return real(s, w, dim)

    fsd._run_flood = counting
    differ = total = 0
    try:
        videos = chip_smoke.synth_videos(8, 20, 360, 640)
        for i in (0, 6, 7):
            calls[0] = 0
            got = fsd.canny_edges(torch.from_numpy(videos[i])).numpy()
            rounds.append(calls[0] // 2)
            want = np.stack([cv2.Canny(f, 50, 400) > 0 for f in videos[i]])
            differ += int((got != want).sum())
            total += want.size
    finally:
        fsd._run_flood = real
    return dict(probe="canny", cv2=cv2.__version__, pixels=total, differ=differ,
                rounds_plain_letterbox_stack=rounds)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shapes", type=int, default=60)
    args = parser.parse_args(argv)
    print(json.dumps(resize(args.shapes)), flush=True)
    print(json.dumps(canny()), flush=True)


if __name__ == "__main__":
    main()
