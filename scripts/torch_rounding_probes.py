"""Two CPU probes of where bfloat16 roundings fall in the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/torch_rounding_probes.py

1. dense: a flax `nn.Dense(dtype=bfloat16)` against the port's `Linear`
   with the same weights and a nonzero bias, N(0, 0.5^2): the share of
   bf16 outputs that differ, and the same share against a plain emulation
   of flax's two roundings (the product rounded to bf16, then the bias
   added in bf16).
2. b10_order: how far order noise inside the attention carries through a
   whole pre-LN block (kernel B10) at CLIP ViT-L/14 width: the plain
   `vit_block_reference` arithmetic with the attention's two products
   summed in float32, against the same with them summed in float64, on
   4 frames of 257 tokens; the share of attention outputs and of block
   outputs that differ.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dense(seed: int = 0) -> dict:
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from vsc22_tpu_torch.models.layers import Linear
    from vsc22_tpu_torch.utils import jax_params

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    mod = nn.Dense(48, dtype=jnp.bfloat16)
    kernel = np.asarray(mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]["kernel"])
    bias = (rng.standard_normal(48) * 0.5).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    out = mod.apply({"params": {"kernel": kernel, "bias": bias}}, xb)
    want = torch.from_numpy(np.array(out.astype(jnp.float32))).to(torch.bfloat16)
    lin = Linear(32, 48, torch.bfloat16)
    with torch.no_grad():
        jax_params._dense(lin, kernel, bias)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        once = lin(xt)
        product = (xt.float() @ lin.weight.float().t()).to(torch.bfloat16)
        twice = (product.float() + lin.bias.to(torch.bfloat16).float()).to(torch.bfloat16)
    return {"Linear (one rounding) differs": float((once != want).float().mean()),
            "two roundings differ": float((twice != want).float().mean())}


def _block(x, p, heads, act, eps, acc):
    """`vit_block_reference` (fold_scale) with the attention products in `acc`."""
    from vsc22_tpu_torch.ops.mlp import _activate, ln_rows

    b, l, c = x.shape
    hd = c // heads
    dt = x.dtype
    ln1 = ln_rows(x.float(), p["ln1_s"], p["ln1_b"], eps).to(dt)
    qkv = (ln1.float() @ p["qkv_w"].float().t() + p["qkv_b"]).reshape(b, l, 3, heads, hd)
    q = (qkv[:, :, 0] * hd**-0.5).to(dt)
    k, v = qkv[:, :, 1].to(dt), qkv[:, :, 2].to(dt)
    logits = torch.einsum("blhd,bmhd->bhlm", q.to(acc), k.to(acc)).float()
    probs = torch.softmax(logits, dim=-1).to(dt)
    attn = torch.einsum("bhlm,bmhd->blhd", probs.to(acc), v.to(acc)).float()
    attn = attn.reshape(b, l, c).to(dt)
    x1 = (x.float() + attn.float() @ p["proj_w"].float().t() + p["proj_b"]).to(dt)
    ln2 = ln_rows(x1.float(), p["ln2_s"], p["ln2_b"], eps).to(dt)
    hidden = _activate(ln2.float() @ p["fc1_w"].float().t() + p["fc1_b"], act).to(dt)
    return (x1.float() + hidden.float() @ p["fc2_w"].float().t() + p["fc2_b"]).to(dt), attn


def b10_order(frames: int = 4) -> dict:
    import chip_smoke

    s = chip_smoke.BLOCK_SHAPES["clip"]
    gen = torch.Generator().manual_seed(4)
    x = chip_smoke.randn(gen, (frames, s["l"], s["c"]), 1.0, torch.bfloat16, "cpu")
    p = chip_smoke.block_params(gen, s["c"], s["hidden"], torch.bfloat16, "cpu")
    args = (x, p, s["h"], s["act"], s["eps"])
    out32, attn32 = _block(*args, torch.float32)
    out64, attn64 = _block(*args, torch.float64)
    return {"attention outputs differ": float((attn32 != attn64).float().mean()),
            "block outputs differ": float((out32 != out64).float().mean())}


if __name__ == "__main__":
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    for name, fn in (("dense", dense), ("b10_order", b10_order)):
        print(name, {k: f"{v:.4%}" for k, v in fn().items()}, flush=True)
