"""A CPU probe of the port's parameter gap to JAX at entropy weight 1.0.

    JAX_PLATFORMS=cpu python scripts/torch_entropy_gap_probe.py [--weight 1.0]

For the tiny ViT on its kernel path ("vit") and its plain dropout path
("vit_plain"), three FGM + EMA steps of `make_train_step` run in both
packages from the same params (`tests/test_torch_train.three_fgm_ema_steps`),
first in float32, then in float64 on both sides (every float32 cast of
both packages lifted: `tests/test_torch_train_faults.float64_everywhere`).
For each run it prints the largest gradient difference relative to each
leaf's largest |JAX| element, the loss gap of the last step, and the
param element farthest from JAX's after the third step among those the
test holds (first-step |g| above ROUNDING_GRAD of the largest); for the
float32 run's worst element also both packages' first-step gradients in
float32 and in float64, relative to the step's largest |g|.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def worst_kept(r, rounding: float):
    """(|port - JAX|, key, index) of the param element farthest from JAX's
    among those whose first-step JAX gradient is above `rounding` of the
    largest, and that largest |g|."""
    got, want = r["params"]
    jgrads = r["grads"][1]
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    best = (0.0, None, None)
    for k in want:
        err = np.where(np.abs(jgrads[k]) > rounding * top, np.abs(got[k] - want[k]), 0.0)
        i = np.unravel_index(int(np.argmax(err)), err.shape)
        if err[i] > best[0]:
            best = (float(err[i]), k, i)
    return best, top


def grad_gap(r) -> float:
    got, want = r["grads"]
    return max(float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-30)
               for k in want)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weight", type=float, default=1.0, help="the entropy loss's weight")
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_torch_train as base
    from test_torch_train_faults import float64_everywhere

    for kind in ("vit", "vit_plain"):
        r32 = base.three_fgm_ema_steps(kind, args.weight)
        with float64_everywhere():
            r64 = base.three_fgm_ema_steps(kind, args.weight, np.float64)
        for name, r in (("float32", r32), ("float64", r64)):
            (err, k, i), top = worst_kept(r, base.ROUNDING_GRAD)
            loss, jloss = r["losses"][-1]
            print(f"{kind} {name} weight {args.weight}: gradients within {grad_gap(r):.3e} of "
                  f"each leaf's largest; last loss gap {abs(loss - jloss):.3e}; worst held "
                  f"param element {k}{list(map(int, i))}: {err:.3e} (PARAM_WORST "
                  f"{base.PARAM_WORST:g}: {'over' if err > base.PARAM_WORST else 'within'})",
                  flush=True)
        (_, k, i), top32 = worst_kept(r32, base.ROUNDING_GRAD)
        _, top64 = worst_kept(r64, base.ROUNDING_GRAD)
        g32 = [float(g[k][i]) / top32 for g in r32["grads"]]
        g64 = [float(g[k][i]) / top64 for g in r64["grads"]]
        print(f"  {k}{list(map(int, i))} first-step gradient / largest |g|: float32 port "
              f"{g32[0]:.4e}, JAX {g32[1]:.4e}; float64 port {g64[0]:.4e}, JAX {g64[1]:.4e}",
              flush=True)


if __name__ == "__main__":
    main()
