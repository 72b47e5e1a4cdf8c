"""Phase 2's SwinV2 kernel checks alone, on the card: B1 at every
SwinV2-Base stage shape of a 128-frame chunk (f32 and bf16, shifted and
unshifted), B6 and B7 at stages 1 and 4, each against its plain version,
with its differing share, kernel, plain, library and bound times
(`chip_smoke.check_swin_kernels`).

    python scripts/torch_swin_probe.py [--root DIR] [--steps | --orders | --sizes]

`--root` runs the checks of another checkout, such as an earlier commit
unpacked with `git archive`, so that two versions are compared in one call
on one card (run them in turns: old, new, new, old). The script builds the
three libraries it needs and prints ptxas's register and spill lines of
the tensor-core kernels.

`--steps` looks inside B1 in bf16 instead, at each stage shape: it runs
the kernel on buffers of its own and holds each intermediate against the
plain arithmetic of that step applied to the kernel's own input of the
step (so that each step's share is its own, not carried from the steps
before): the QKV and fc2 sums against float64 (the kernel's and the plain
float32 sums' largest and mean signed errors, in units of 2^-24 of the sum
of the terms' magnitudes), and the shares of attn, x1, hidden and out that
differ.

`--orders` checks the summation order of the plain attention core's f32
products on the card (torch's einsum, i.e. cuBLAS): at three window
shapes, it holds q̂ k̂^T and P V against FMA chains over k in order, and P V
against 16-term partial sums (exact, in float64) added in order, as an
mma core forms them; it prints the share of equal f32 and bf16 results.

`--sizes` runs B1 in bf16 at stages 3 and 4 on 2, 8, 32 and 128 items
(two seeds each) and prints the share of its outputs that differ from the
plain version's, and of rows with any: cuBLAS picks its order of
summation by shape, so the share depends on the number of windows.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--orders", action="store_true")
    ap.add_argument("--sizes", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from vsc22_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_swin_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"root {root}; {chip_smoke.card_line()}", flush=True)
    t0 = time.perf_counter()
    libs = ("window_attn", "swin_block", "ln_mlp")
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(build.library, libs))
    print(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        entry = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "mma" in entry and ("registers" in line or "spill" in line):
                print(f"  {name}: {entry[:60]}: {line.split(':', 1)[-1].strip()}", flush=True)
    if args.steps:
        for stage in (1, 2, 3, 4):
            b1_steps(stage, torch.device("cuda", 0))
        return 0
    if args.orders:
        orders(torch.device("cuda", 0))
        return 0
    if args.sizes:
        sizes(torch.device("cuda", 0))
        return 0
    t0 = time.perf_counter()
    try:
        chip_smoke.check_swin_kernels(torch.device("cuda", 0))
    except chip_smoke.Failed as e:
        print(f"torch_swin_probe: FAILED: {e}", flush=True)
        return 1
    print(f"checks took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def b1_args(stage: int, items: int, gen, device):
    """Phase 2's B1 operands at `items` 128-frame-chunk items of a stage,
    unshifted (the inputs of `chip_smoke.check_swin_kernels`)."""
    import numpy as np
    import torch

    import chip_smoke

    res, window, c, h = chip_smoke.SWIN_STAGES[stage]
    n, f = window * window, 4 * c
    w = items * (res // window) ** 2
    dt = torch.bfloat16
    r = lambda shape, std, dtype=dt: chip_smoke.randn(gen, shape, std, dtype, device)
    qkv_b = r((3 * c,), 0.05, torch.float32)
    qkv_b[c : 2 * c] = 0.0
    return (r((w, n, c), 1.0), r((3 * c, c), c**-0.5), qkv_b, r((c, c), c**-0.5),
            r((c,), 0.05, torch.float32), 1 + r((c,), 0.1, torch.float32),
            r((c,), 0.1, torch.float32), r((f, c), c**-0.5), r((f,), 0.05, torch.float32),
            r((c, f), f**-0.5), r((c,), 0.05, torch.float32), 1 + r((c,), 0.1, torch.float32),
            r((c,), 0.1, torch.float32),
            *chip_smoke.window_tables(gen, h, n, np.zeros((1, n, n), np.float32), device), h, 1)


def sizes(device) -> None:
    import torch

    from vsc22_tpu_torch.ops import swin_block as sb

    for stage in (3, 4):
        for items in (2, 8, 32, 128):
            for seed in (1, 2):
                args = b1_args(stage, items, torch.Generator().manual_seed(seed), device)
                got, want = sb.swin_block(*args), sb.swin_block_reference(*args)
                c = got.shape[-1]
                rows = (got != want).reshape(-1, c).any(1).float().mean()
                print(f"stage {stage}, {items} items, seed {seed}: "
                      f"{float((got != want).float().mean()):.4%} differ, rows with any "
                      f"{float(rows):.1%}", flush=True)


def orders(device) -> None:
    import torch

    gen = torch.Generator().manual_seed(0)
    bf = lambda t: t.to(torch.bfloat16).float().to(device)
    for w, h, n, hd in ((16, 16, 256, 32), (128, 32, 64, 32), (64, 4, 256, 32)):
        p = bf(torch.softmax(torch.randn((w, h, n, n), generator=gen) * 3, -1))
        v = bf(torch.randn((w, h, n, hd), generator=gen))
        pv = torch.einsum("whnm,whmd->whnd", p, v)
        chain = torch.zeros_like(pv)
        for j in range(n):  # p v is exact in f32, so each step rounds once, as an FMA
            chain = chain + p[..., j : j + 1] * v[..., j : j + 1, :]
        parts = torch.zeros_like(pv)
        for c0 in range(0, n, 16):
            parts = parts + torch.einsum("whnm,whmd->whnd", p[..., c0 : c0 + 16].double(),
                                         v[..., c0 : c0 + 16, :].double()).float()
        q = bf(torch.nn.functional.normalize(torch.randn((w, h, n, hd), generator=gen), dim=-1))
        k = bf(torch.nn.functional.normalize(torch.randn((w, h, n, hd), generator=gen), dim=-1))
        qk = torch.einsum("whnd,whmd->whnm", q, k)
        qk_chain = torch.zeros_like(qk)
        for d in range(hd):
            qk_chain = qk_chain + q[..., :, d : d + 1] * k[..., :, d].unsqueeze(-2)
        eq = lambda a, b: f"{float((a == b).float().mean()):.4%}"
        print(f"[{w},{h},{n},{hd}]: q̂k̂ einsum = chain {eq(qk, qk_chain)}; P V einsum = chain "
              f"{eq(pv, chain)} (bf16 {eq(pv.bfloat16(), chain.bfloat16())}); 16-term partials = "
              f"einsum {eq(parts, pv)} (bf16 {eq(parts.bfloat16(), pv.bfloat16())})", flush=True)


def sum_errors(got, x, w, b) -> str:
    """The f32 sums `got` and the plain f32 ones against float64: largest
    and mean signed error in units of 2^-24 sum_k |x_k w_k| (the scale of
    one f32 rounding of the sum's largest partial sums)."""
    import torch

    exact = x.double() @ w.double().t() + b.double()
    plain = (x.float() @ w.float().t() + b).double()
    unit = (x.double().abs() @ w.double().abs().t() + b.double().abs()) * 2.0**-24
    words = []
    for name, y in (("kernel", got.double()), ("plain f32", plain)):
        e = (y - exact) / unit
        words.append(f"{name} max {float(e.abs().max()):.1f} mean {float(e.mean()):+.3f}")
    return ", ".join(words)


def b1_steps(stage: int, device) -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops import swin_block as sb

    res, window, c, h = chip_smoke.SWIN_STAGES[stage]
    n, f = window * window, 4 * c
    w = 128 * (res // window) ** 2
    dt = torch.bfloat16
    args = b1_args(stage, 128, torch.Generator().manual_seed(1), device)[:16]
    x, qkv_w, _, proj_w, proj_b, ln1_s, ln1_b, fc1_w, fc1_b, fc2_w, fc2_b, ln2_s, ln2_b = args[:13]
    rpb, scale, mask = args[13:]
    m = w * n
    qkv = torch.empty((m, 3 * c), dtype=torch.float32, device=device)
    attn, x1, out = (torch.empty_like(x) for _ in range(3))
    y = torch.empty((m, c), dtype=torch.float32, device=device)
    hidden = torch.empty((m, f), dtype=dt, device=device)
    build.call("swin_block", "vsc22_swin_block", sb._ARGTYPES,
               *(t.data_ptr() for t in args), qkv.data_ptr(), attn.data_ptr(), y.data_ptr(),
               x1.data_ptr(), hidden.data_ptr(), out.data_ptr(), w, n, c, h, f, 1, 1,
               build.stream_ptr(device))
    torch.cuda.synchronize()
    share = lambda a, b: f"{float((a != b).float().mean()):.4%}"
    x2 = x.reshape(m, c)
    print(f"stage {stage} [{w},{n},{c}] h={h}:", flush=True)
    print(f"  qkv sums: {sum_errors(qkv, x2, qkv_w, qkv_b)}", flush=True)
    def core(qkv_in):  # the plain attention core
        q, k, v = qkv_in.reshape(w, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q = q * torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-12)
        k = k * torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-12)
        logits = torch.einsum("whnd,whmd->whnm", q.to(dt).float(), k.to(dt).float())
        logits = logits * scale.reshape(1, -1, 1, 1) + rpb[None] + mask[0]
        probs = torch.softmax(logits, dim=-1).to(dt).float()
        out = torch.einsum("whnm,whmd->whnd", probs, v.to(dt).float())
        return out.permute(0, 2, 1, 3).reshape(w, n, c).to(dt)

    print(f"  attn (plain core on the kernel's qkv) differs {share(attn, core(qkv))}", flush=True)
    plain_qkv = x2.float() @ qkv_w.float().t() + qkv_b
    print(f"  attn (plain qkv and core) differs {share(attn, core(plain_qkv))}", flush=True)
    a2 = attn.reshape(m, c)
    proj = a2.float() @ proj_w.float().t() + proj_b
    x1_ref = (x2.float() + sb._layernorm_f32(proj, ln1_s, ln1_b)).to(dt)
    print(f"  x1 (plain proj + LN1 on the kernel's attn) differs "
          f"{share(x1.reshape(m, c), x1_ref)}", flush=True)
    x1_2 = x1.reshape(m, c)
    hid_ref = F.gelu(x1_2.float() @ fc1_w.float().t() + fc1_b).to(dt)
    print(f"  hidden (plain fc1 + GELU on the kernel's x1) differs {share(hidden, hid_ref)}",
          flush=True)
    print(f"  fc2 sums: {sum_errors(y, hidden, fc2_w, fc2_b)}", flush=True)
    mlp = hidden.float() @ fc2_w.float().t() + fc2_b
    out_ref = (x1_2.float() + sb._layernorm_f32(mlp, ln2_s, ln2_b)).to(dt)
    print(f"  out (plain fc2 + LN2 on the kernel's hidden) differs "
          f"{share(out.reshape(m, c), out_ref)}", flush=True)
    whole = sb.swin_block_reference(*args, h, 1)
    print(f"  out against the whole plain block differs {share(out, whole)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
