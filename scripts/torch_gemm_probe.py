"""Phase 2's K1 and K2 checks alone, on the card: K1 and K2 at a 128-frame
chunk of ViT-B/32 and CLIP ViT-L/14, f32 and bf16, each against its plain
version, with the loop of each product, its differing share, kernel,
plain, cuBLAS-products and bound times, and K2's LN-rows kernel alone
(`chip_smoke.check_kernels`).

    python scripts/torch_gemm_probe.py [--root DIR] [--steps] [--digests]

`--root` runs the checks of another checkout, such as an earlier commit
unpacked with `git archive`, so that two versions are compared in one call
on one card (run them in turns: old, new, new, old). The script builds the
libraries it needs and prints ptxas's register and spill lines of the
tensor-core GEMM and the LN-rows kernel.

`--steps` looks inside K1 and K2 in bf16 at both shapes instead: it runs
each on buffers of its own and holds each intermediate against the plain
arithmetic of that step applied to the kernel's own input of the step (so
that each product's share is its own, not carried from the steps before):
K2's LN rows, its hidden (fc1 + activation) and its output (fc2 +
residual); K1's attention output (the core) and its output (the
projection + residual); then each whole against its plain version.

`--digests` prints the sha256 of B1's bf16 output at stages 3 and 4 on the
operands of `b1_digest_args` (tests/test_torch_cuda.py pins them), so that
two checkouts can be compared bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--digests", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from vsc22_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_gemm_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"root {root}; {chip_smoke.card_line()}", flush=True)
    t0 = time.perf_counter()
    libs = ("ln_mlp", "attn_proj", "swin_block") if args.digests else ("ln_mlp", "attn_proj")
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(build.library, libs))
    print(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        entry = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif ("mma" in entry or "ln_rows" in entry) and ("registers" in line or "spill" in line):
                print(f"  {name}: {entry[:60]}: {line.split(':', 1)[-1].strip()}", flush=True)
    if args.digests:
        for stage, items in ((3, 16), (4, 64)):
            out = b1_digest(stage, items, device)
            print(f"B1 bf16 stage {stage} ({items} items): sha256 {out}", flush=True)
        return 0
    if args.steps:
        for tag in ("vit", "clip"):
            k2_steps(tag, device)
            k1_steps(tag, device)
        return 0
    t0 = time.perf_counter()
    try:
        chip_smoke.check_kernels(device)
    except chip_smoke.Failed as e:
        print(f"torch_gemm_probe: FAILED: {e}", flush=True)
        return 1
    print(f"checks took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def digest(t) -> str:
    """sha256 of a tensor's bytes, as tests/test_torch_cuda.py takes it."""
    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def b1_digest_args(stage: int, items: int, device):
    """B1's bf16 operands at `items` items of a SwinV2-Base stage,
    unshifted, from a CPU generator seeded 40 + stage (the operands of
    `torch_swin_probe.b1_args`)."""
    import torch

    from scripts.torch_swin_probe import b1_args

    return b1_args(stage, items, torch.Generator().manual_seed(40 + stage), device)


def b1_digest(stage: int, items: int, device) -> str:
    import torch

    from vsc22_tpu_torch.ops.swin_block import swin_block

    out = swin_block(*b1_digest_args(stage, items, device))
    torch.cuda.synchronize()
    return digest(out)


def share(a, b) -> str:
    return f"{float((a != b).float().mean()):.4%}"


def k2_steps(tag: str, device) -> None:
    """K2 in bf16 at a 128-frame chunk of `tag`, step by step."""
    import torch

    import chip_smoke
    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops import mlp

    s = chip_smoke.BLOCK_SHAPES[tag]
    m, c, hd = s["b"] * s["l"], s["c"], s["hidden"]
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    r = lambda shape, std, dtype=dt: chip_smoke.randn(gen, shape, std, dtype, device)
    x = r((m, c), 1.0)
    ln_s, ln_b = 1 + r((c,), 0.1, torch.float32), r((c,), 0.1, torch.float32)
    w1, b1 = r((hd, c), c**-0.5), r((hd,), 0.1, torch.float32)
    w2, b2 = r((c, hd), hd**-0.5), r((c,), 0.1, torch.float32)
    ln, out = torch.empty_like(x), torch.empty_like(x)
    hidden = torch.empty((m, hd), dtype=dt, device=device)
    act = {"gelu": 1, "quick_gelu": 2}[s["act"]]
    build.call("ln_mlp", "vsc22_ln_mlp_residual", mlp._ARGTYPES,
               x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
               w2.data_ptr(), b2.data_ptr(), ln.data_ptr(), hidden.data_ptr(), out.data_ptr(),
               m, c, hd, act, s["eps"], 1, build.stream_ptr(device))
    torch.cuda.synchronize()
    print(f"K2 {tag} bf16 [{m},{c}] hidden={hd} {s['act']} ({mlp.routes(x, w1, w2)}):",
          flush=True)
    ln_ref = mlp.ln_rows(x.float(), ln_s, ln_b, s["eps"]).to(dt)
    print(f"  LN rows differ {share(ln, ln_ref)}", flush=True)
    h_ref = mlp._activate(ln.float() @ w1.float().t() + b1, s["act"]).to(dt)
    print(f"  hidden (plain fc1 + act on the kernel's LN rows) differs {share(hidden, h_ref)}",
          flush=True)
    o_ref = (x.float() + hidden.float() @ w2.float().t() + b2).to(dt)
    print(f"  out (plain fc2 + residual on the kernel's hidden) differs {share(out, o_ref)}",
          flush=True)
    whole = mlp.ln_mlp_residual_reference(x, ln_s, ln_b, w1, b1, w2, b2, s["act"], s["eps"])
    print(f"  out against the whole plain K2 differs {share(out, whole)}", flush=True)


def k1_steps(tag: str, device) -> None:
    """K1 in bf16 at a 128-frame chunk of `tag`, step by step."""
    import torch

    import chip_smoke
    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops import attn_proj

    s = chip_smoke.BLOCK_SHAPES[tag]
    b, l, c, h = s["b"], s["l"], s["c"], s["h"]
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(1)
    r = lambda shape, std, dtype=dt: chip_smoke.randn(gen, shape, std, dtype, device)
    x, qkv = r((b, l, c), 0.05), r((b, l, 3 * c), 1.5)
    pw, pb = r((c, c), c**-0.5), r((c,), 0.1, torch.float32)
    attn, out = torch.empty_like(x), torch.empty_like(x)
    build.call("attn_proj", "vsc22_attn_proj_residual", attn_proj._ARGTYPES,
               x.data_ptr(), qkv.data_ptr(), pw.data_ptr(), pb.data_ptr(), attn.data_ptr(),
               out.data_ptr(), b, l, c, h, 1, build.stream_ptr(device))
    torch.cuda.synchronize()
    print(f"K1 {tag} bf16 [{b},{l},{c}] h={h} ({attn_proj.routes(x, pw, h)}):", flush=True)
    # The plain core: K1's reference with a zero residual, no projection.
    eye, zero = torch.eye(c, dtype=dt, device=device), torch.zeros(c, device=device)
    a_ref = attn_proj.attn_proj_residual_reference(torch.zeros_like(x), qkv, eye, zero, h)
    print(f"  attn (plain core) differs {share(attn, a_ref)}", flush=True)
    o_ref = (x.float() + attn.float() @ pw.float().t() + pb).to(dt)
    print(f"  out (plain projection + residual on the kernel's attn) differs "
          f"{share(out, o_ref)}", flush=True)
    whole = attn_proj.attn_proj_residual_reference(x, qkv, pw, pb, h)
    print(f"  out against the whole plain K1 differs {share(out, whole)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
