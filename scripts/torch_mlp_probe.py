"""B7 (`fused_mlp`) alone on the card: ptxas's register and spill lines of
every GEMM instance in `csrc/ln_mlp.cu`; B7 at ragged shapes that cross
its route rule (K off 8 and off 4, an operand off 16 bytes), each against
its plain version; then B7 at the SwinV2-Base stage 1 and stage 4 shapes
of a 128-frame chunk in f32 and bf16, as `chip_smoke.py` phase 2 checks
it (the loop of each product, kernel, plain, products-as-`torch.mm` and
bound times, max error and differing share).

    python scripts/torch_mlp_probe.py [--root DIR] [--ceiling]

`--ceiling` builds `scripts/tc_ceiling.cu` with nvcc into the package's
build directory and runs it first: the tensor cores' own rates for
mma.sync (tf32, bf16) and for wgmma tf32 as B7's loop issues it.
`--root` runs another checkout, such as an earlier commit unpacked with
`git archive`, so that two versions are compared in one call on one card
(run them in turns: old, new, new, old). A checkout without
`fused_mlp_routes` is timed on the same operands with its own bound.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def operands(chip_smoke, gen, rows, c, f, dt, device) -> tuple:
    """B7's x, w1, b1, w2, b2 as `chip_smoke.fused_mlp_args` makes them
    (kept here too, for checkouts that predate it)."""
    r = lambda shape, std: chip_smoke.randn(gen, shape, std, dt, device)
    return r((rows, c), 1.0), r((f, c), c**-0.5), r((f,), 0.05), r((c, f), f**-0.5), r((c,), 0.05)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--ceiling", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops import mlp

    if not torch.cuda.is_available():
        print("torch_mlp_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"root {root}; {chip_smoke.card_line()}", flush=True)
    if args.ceiling:
        exe = build.BUILD_DIR / "tc_ceiling"
        build.BUILD_DIR.mkdir(exist_ok=True)
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tc_ceiling.cu")
        subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-o", str(exe), src], check=True)
        subprocess.run([str(exe)], check=True)
    t0 = time.perf_counter()
    build.library("ln_mlp")
    print(f"built ln_mlp in {time.perf_counter() - t0:.1f} s", flush=True)
    entry = ""
    for line in build.build_log("ln_mlp").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "gemm" in entry and ("registers" in line or "spill" in line):
            print(f"  {entry.split('EEv')[0]}: {line.split(':', 1)[-1].strip()}", flush=True)

    routes = getattr(mlp, "fused_mlp_routes", None)
    gen = torch.Generator().manual_seed(11)
    print("ragged shapes (f32 tol 1e-5 + 1e-5 |plain|; bf16 chip_smoke's bar):", flush=True)
    for rows, c, hidden, offset in ((37, 48, 80, 0), (130, 200, 70, 0), (33, 36, 132, 0),
                                    (1, 32, 128, 0), (300, 20, 52, 0), (129, 128, 512, 1)):
        for dt in (torch.float32, torch.bfloat16):
            x, w1, b1, w2, b2 = operands(chip_smoke, gen, rows, c, hidden, dt, device)
            if offset:  # x one element into its buffer: off 16 bytes
                buf = torch.empty(rows * c + offset, dtype=dt, device=device)
                buf[offset:].copy_(x.flatten())
                x = buf[offset:].view(rows, c)
            got = mlp.fused_mlp(x, w1, b1, w2, b2)
            want = mlp.fused_mlp_reference(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            ok, err, share, words = chip_smoke.agreement(got, want, (1e-5, 1e-5))
            r = routes(x, w1, w2) if routes else "n/a"
            print(f"  [{rows},{c}]x{hidden} {chip_smoke.dname(dt)} offset {offset} routes {r}: "
                  f"max_abs_err {err:.3e} ({words}) {'ok' if ok else 'FAIL'}", flush=True)

    for stage in (1, 4):
        res, _, c, _ = chip_smoke.SWIN_STAGES[stage]
        rows, f = 128 * res * res, 4 * c
        for dt in (torch.float32, torch.bfloat16):
            a = operands(chip_smoke, gen, rows, c, f, dt, device)
            if hasattr(chip_smoke, "check_fused_mlp"):
                r = chip_smoke.check_fused_mlp(a, f"stage{stage}")
            else:
                x, w1, _, w2, _ = a
                hid = torch.randn((rows, f), device=device).to(dt)
                r = chip_smoke.compare(
                    f"fused_mlp stage{stage} {chip_smoke.dname(dt)} [{rows},{c}] hidden={f}",
                    lambda: mlp.fused_mlp(*a), lambda: mlp.fused_mlp_reference(*a),
                    work=chip_smoke.work_mlp(rows, c, f, x.element_size(), ln=False), dtype=dt,
                    products_fn=lambda: (torch.mm(x, w1.t()), torch.mm(hid, w2.t())),
                )
                del hid
            print(f"    launches so far {mlp.fused_mlp.launches}; kernel {r['ms']:.3f} ms",
                  flush=True)
            del a
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
