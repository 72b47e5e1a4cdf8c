"""Phase 2's K1, K2, B8, B9 and B10 checks alone, on the card: each at a
128-frame chunk of ViT-B/32 and CLIP ViT-L/14, f32 and bf16, against its
plain version, with the loop of each product, its differing share,
kernel, plain, cuBLAS-products and bound times, and K2's LN-rows kernel
alone (`chip_smoke.check_kernels` and `check_block_kernels`).

    python scripts/torch_gemm_probe.py [--root DIR] [--steps | --digests]

`--root` runs the checks of another checkout, such as an earlier commit
unpacked with `git archive`, so that two versions are compared in one call
on one card (run them in turns: old, new, new, old). The script builds the
libraries it needs and prints ptxas's register and spill lines of every
instance of the tensor-core GEMM, B7's 3xTF32 tile, the 128x128 FFMA tile
and the LN-rows kernel.

`--steps` looks inside K1, K2, B9 and B10 in bf16 at both shapes instead:
it runs each on buffers of its own and holds each intermediate against the
plain arithmetic of that step applied to the kernel's own input of the
step (so that each product's share is its own, not carried from the steps
before): K2's LN rows, hidden (fc1 + activation) and output (fc2 +
residual); K1's attention output (the core) and output (the projection +
residual); B9's and B10's LN rows, qkv (q scaled in B10), core, x1 or
output, and B10's LN2 rows, hidden and output; then each whole against its
plain version. For B9 and B10 it also prints what each step's differences
carry to the output: the plain stages run on from the kernel's
intermediate, against the whole plain version.

`--digests` prints the sha256 of B1's bf16 output at stages 3 and 4 on the
operands of `b1_digest_args`, and of B9's and B10's outputs on those of
`block_digest_args` (tests/test_torch_cuda.py pins them), so that two
checkouts can be compared bit for bit.
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
    libs = ("ln_mlp", "attn_proj", "vit_block", "swin_block", "attn")
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(build.library, libs))
    print(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        entry = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif (any(k in entry for k in ("gemm_mma_kernel", "gemm128", "gemm_tf32x3", "ln_rows"))
                  and ("registers" in line or "spill" in line)):
                # the mangled name up to the end of its template arguments
                print(f"  {name}: {entry.split('EEv')[0]}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
    if args.digests:
        for stage, items in ((3, 16), (4, 64)):
            out = b1_digest(stage, items, device)
            print(f"B1 bf16 stage {stage} ({items} items): sha256 {out}", flush=True)
        for dt in ("float32", "bfloat16"):
            for name, out in block_digests(dt, device).items():
                print(f"{name} {dt} CLIP [16,257,1024]: sha256 {out}", flush=True)
        return 0
    if args.steps:
        for tag in ("vit", "clip"):
            k2_steps(tag, device)
            k1_steps(tag, device)
            b9_steps(tag, device)
            b10_steps(tag, device)
        return 0
    t0 = time.perf_counter()
    try:
        chip_smoke.check_kernels(device)
        chip_smoke.check_block_kernels(device)
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


def block_digest_args(dtype, device):
    """B10's operands at 16 frames of CLIP ViT-L/14 (`chip_smoke.block_params`
    from a CPU generator seeded 2025); B9 takes the first eight of them."""
    import torch

    import chip_smoke

    gen = torch.Generator().manual_seed(2025)
    x = chip_smoke.randn(gen, (16, 257, 1024), 1.0, dtype, device)
    return (x, *chip_smoke.block_params(gen, 1024, 4096, dtype, device).values())


def block_digests(dtype: str, device) -> dict:
    """sha256 of B9's and B10's outputs on `block_digest_args`."""
    import torch

    from vsc22_tpu_torch.ops.attn_proj import ln_attn_proj_residual
    from vsc22_tpu_torch.ops.vit_block import vit_block

    args = block_digest_args(getattr(torch, dtype), device)
    b9 = ln_attn_proj_residual(*args[:7], 16, 1e-5)
    b10 = vit_block(*args, 16, "quick_gelu", 1e-5)
    torch.cuda.synchronize()
    return {"B9": digest(b9), "B10": digest(b10)}


def residual(x, a, w, b):
    """The plain product-with-residual step on the kernel's own input a:
    x + (a W^T + b) in f32, rounded to x's dtype, in the kernels' order
    (the bias joins the product before the residual)."""
    return (x.float() + (a.float() @ w.float().t() + b)).to(x.dtype)


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
    o_ref = residual(x, hidden, w2, b2)
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
    o_ref = residual(x, attn, pw, pb)
    print(f"  out (plain projection + residual on the kernel's attn) differs "
          f"{share(out, o_ref)}", flush=True)
    whole = attn_proj.attn_proj_residual_reference(x, qkv, pw, pb, h)
    print(f"  out against the whole plain K1 differs {share(out, whole)}", flush=True)


def block_step_args(tag: str, seed: int, device):
    """bf16 operands of a pre-LN block at a 128-frame chunk of `tag`, as
    phase 2 draws them (`chip_smoke.block_params`)."""
    import torch

    import chip_smoke

    s = chip_smoke.BLOCK_SHAPES[tag]
    gen = torch.Generator().manual_seed(seed)
    x = chip_smoke.randn(gen, (s["b"], s["l"], s["c"]), 1.0, torch.bfloat16, device)
    return s, x, chip_smoke.block_params(gen, s["c"], s["hidden"], torch.bfloat16, device)


def plain_core(qkv, h, scale=None):
    """The plain attention core alone: K1's plain version with a zero
    residual and an identity projection."""
    import torch

    from vsc22_tpu_torch.ops import attn_proj

    b, l, c3 = qkv.shape
    c = c3 // 3
    eye = torch.eye(c, dtype=qkv.dtype, device=qkv.device)
    zero = torch.zeros(c, device=qkv.device)
    return attn_proj.attn_proj_residual_reference(
        torch.zeros((b, l, c), dtype=qkv.dtype, device=qkv.device), qkv, eye, zero, h, scale)


def b9_steps(tag: str, device) -> None:
    """B9 in bf16 at a 128-frame chunk of `tag`, step by step."""
    import torch

    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops import attn_proj, mlp

    s, x, p = block_step_args(tag, 2, device)
    h, eps, dt = s["h"], s["eps"], torch.bfloat16
    ln, attn, out = (torch.empty_like(x) for _ in range(3))
    qkv = torch.empty(x.shape[:2] + (3 * s["c"],), dtype=dt, device=device)
    half = [p[k] for k in ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b")]
    build.call("attn_proj", "vsc22_ln_attn_proj_residual", attn_proj._LN_ARGTYPES,
               x.data_ptr(), *(t.data_ptr() for t in half), ln.data_ptr(), qkv.data_ptr(),
               attn.data_ptr(), out.data_ptr(), *x.shape, h, eps, 1, build.stream_ptr(device))
    torch.cuda.synchronize()
    routes = attn_proj.routes(x, p["proj_w"], h, half_block=True)
    print(f"B9 {tag} bf16 {list(x.shape)} h={h} ({routes}):", flush=True)
    ln_s, ln_b, qkv_w, qkv_b, pw, pb = half
    print(f"  LN1 rows differ {share(ln, mlp.ln_rows(x.float(), ln_s, ln_b, eps).to(dt))}",
          flush=True)
    print(f"  qkv (plain QKV on the kernel's LN rows) differs "
          f"{share(qkv, attn_proj.qkv_reference(ln, qkv_w, qkv_b))}", flush=True)
    print(f"  attn (plain core on the kernel's qkv) differs {share(attn, plain_core(qkv, h))}",
          flush=True)
    o_ref = residual(x, attn, pw, pb)
    print(f"  out (plain projection + residual on the kernel's attn) differs "
          f"{share(out, o_ref)}", flush=True)
    whole = attn_proj.ln_attn_proj_residual_reference(x, *half, h, eps)
    carried = attn_proj.attn_proj_residual_reference(x, qkv, pw, pb, h)
    print(f"  carried to the output: from qkv {share(carried, whole)}", flush=True)
    print(f"  out against the whole plain B9 differs {share(out, whole)}", flush=True)


def b10_steps(tag: str, device) -> None:
    """B10 in bf16 at a 128-frame chunk of `tag`, step by step."""
    import torch

    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops import attn_proj, mlp, vit_block

    s, x, p = block_step_args(tag, 3, device)
    h, eps, act, dt = s["h"], s["eps"], s["act"], torch.bfloat16
    ln, attn, x1, out = (torch.empty_like(x) for _ in range(4))
    qkv = torch.empty(x.shape[:2] + (3 * s["c"],), dtype=dt, device=device)
    hidden = torch.empty(x.shape[:2] + (s["hidden"],), dtype=dt, device=device)
    build.call("vit_block", "vsc22_vit_block", vit_block._ARGTYPES,
               x.data_ptr(), *(t.data_ptr() for t in p.values()), ln.data_ptr(),
               qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(), hidden.data_ptr(),
               out.data_ptr(), *x.shape, h, s["hidden"], mlp._ACT_CODES[act], eps, 1,
               build.stream_ptr(device))
    torch.cuda.synchronize()
    routes = vit_block.routes(x, p["fc1_w"], p["fc2_w"], h)
    print(f"B10 {tag} bf16 {list(x.shape)} h={h} F={s['hidden']} {act} ({routes}):", flush=True)
    # LN1 is the LN-rows kernel on x: the same kernel alone (the scratch
    # holds LN2 after the call).
    ln1 = mlp.layernorm_rows(x.reshape(-1, s["c"]), p["ln1_s"], p["ln1_b"], eps).reshape(x.shape)
    print(f"  LN1 rows differ "
          f"{share(ln1, mlp.ln_rows(x.float(), p['ln1_s'], p['ln1_b'], eps).to(dt))}",
          flush=True)
    q_scale = (s["c"] // h) ** -0.5
    print(f"  qkv, q scaled (plain QKV on LN1 rows) differs "
          f"{share(qkv, attn_proj.qkv_reference(ln1, p['qkv_w'], p['qkv_b'], q_scale))}",
          flush=True)
    print(f"  attn (plain core, scale 1, on the kernel's qkv) differs "
          f"{share(attn, plain_core(qkv, h, 1.0))}", flush=True)
    x1_ref = residual(x, attn, p["proj_w"], p["proj_b"])
    print(f"  x1 (plain projection + residual on the kernel's attn) differs "
          f"{share(x1, x1_ref)}", flush=True)
    print(f"  LN2 rows differ "
          f"{share(ln, mlp.ln_rows(x1.float(), p['ln2_s'], p['ln2_b'], eps).to(dt))}",
          flush=True)
    h_ref = mlp._activate(ln.float() @ p["fc1_w"].float().t() + p["fc1_b"], act).to(dt)
    print(f"  hidden (plain fc1 + act on the kernel's LN2 rows) differs {share(hidden, h_ref)}",
          flush=True)
    o_ref = residual(x1, hidden, p["fc2_w"], p["fc2_b"])
    print(f"  out (plain fc2 + residual on the kernel's hidden) differs {share(out, o_ref)}",
          flush=True)
    whole = vit_block.vit_block_reference(x, *p.values(), h, act, eps, fold_scale=True)
    k2 = lambda y: mlp.ln_mlp_residual_reference(y, p["ln2_s"], p["ln2_b"], p["fc1_w"],
                                                 p["fc1_b"], p["fc2_w"], p["fc2_b"], act, eps)
    from_qkv = k2(attn_proj.attn_proj_residual_reference(x, qkv, p["proj_w"], p["proj_b"], h,
                                                         1.0))
    from_attn = k2(x1_ref)
    print(f"  carried to the output: from qkv {share(from_qkv, whole)}, from attn "
          f"{share(from_attn, whole)}, from x1 {share(k2(x1), whole)}, from hidden "
          f"{share(o_ref, whole)}", flush=True)
    print(f"  out against the whole plain B10 differs {share(out, whole)}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
