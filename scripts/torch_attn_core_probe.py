"""The PyTorch port's attention core on one NVIDIA GPU, quickly.

    python scripts/torch_attn_core_probe.py

Builds the three libraries that hold the core (attn, attn_proj,
vit_block) and prints nvcc's register and spill report for them; then B8
(`packed_attention`) in bfloat16 at a 128-frame chunk of CLIP ViT-L/14
([128, 257, 16, 64]) and of ViT-B/32 ([128, 145, 12, 64]) against its
plain version and beside `F.scaled_dot_product_attention`, as
`chip_smoke.py` phase 2 holds it; and K1 (`attn_proj_residual`) in float32
and bfloat16 on the inputs of the card tests' digest check, with its
digest, the pinned one, its agreement with the plain version and its time.
Needs CUDA; a shorter loop than `chip_smoke.py` while the core changes.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import test_torch_cuda as card_tests
    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops import attn, attn_proj

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(chip_smoke.card_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    libs = ("attn", "attn_proj", "vit_block")
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(build.library, libs))
    print(f"built {', '.join(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in build.build_log("attn").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(line.strip()[:160])
    gen = torch.Generator().manual_seed(4)
    for tag, (b, l, h, hd) in {"clip": (128, 257, 16, 64), "vit": (128, 145, 12, 64)}.items():
        q = chip_smoke.randn(gen, (b, l, h, hd), 1.5 * hd**-0.5, torch.bfloat16, dev)
        k, v = (chip_smoke.randn(gen, (b, l, h, hd), 1.5, torch.bfloat16, dev) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        chip_smoke.compare(
            f"packed_attention {tag} bf16 [{b},{l},{h},{hd}]",
            lambda: attn.packed_attention(q, k, v),
            lambda: attn.packed_attention_reference(q, k, v),
            work=chip_smoke.work_attn(b, l, h, hd, 2), dtype=torch.bfloat16,
            library_fn=lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0))
    for dt in (torch.float32, torch.bfloat16):
        args = card_tests.k1_clip_inputs(dt, dev)
        out = attn_proj.attn_proj_residual(*args)
        want = attn_proj.attn_proj_residual_reference(*args)
        torch.cuda.synchronize()
        ok, err, share, words = chip_smoke.agreement(out, want, chip_smoke.F32_TOL)
        got = card_tests.digest(out)
        ms = chip_smoke.cuda_ms(lambda: attn_proj.attn_proj_residual(*args))
        print(f"attn_proj_residual clip {chip_smoke.dname(dt)}: digest {got} "
              f"({'as pinned' if got == card_tests.K1_DIGESTS[dt] else 'NOT as pinned'}); "
              f"max_abs_err {err:.3e} ({words}) {'ok' if ok else 'FAIL'}; {ms:.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
