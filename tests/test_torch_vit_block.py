"""Port kernel B10 (a whole pre-LN ViT/CLIP block): its plain version against
the JAX Pallas kernel in interpret mode and the XLA twin
`vit_block_reference`, with both activations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc22_tpu.ops.pallas_vit_block import vit_block_fused, vit_block_reference
from vsc22_tpu_torch.ops import vit_block as pvb

# f32 on both sides, sums in another order (the JAX kernel test's bar).
ATOL, RTOL = 5e-5, 1e-4

NAMES = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2_s", "ln2_b",
         "fc1_w", "fc1_b", "fc2_w", "fc2_b")
DENSE = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def make_block(b, l, c, seed=0):
    """The inputs of tests/test_vit_block_fused.py (JAX layouts, Dense
    kernels [in, out]), with LN scales off one."""
    f = 4 * c
    rng = np.random.default_rng(seed)
    a = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    x = (rng.standard_normal((b, l, c)) * 0.5).astype(np.float32)
    args = dict(ln1_s=1 + a(c), ln1_b=a(c), qkv_w=a(c, 3 * c), qkv_b=a(3 * c),
                proj_w=a(c, c), proj_b=a(c), ln2_s=1 + a(c), ln2_b=a(c),
                fc1_w=a(c, f), fc1_b=a(f), fc2_w=a(f, c), fc2_b=a(c))
    return x, args


def port_args(x, args, dtype=torch.float32):
    """The port's layouts: Linear weights [out, in] in `dtype`, the rest f32."""
    out = [torch.from_numpy(x).to(dtype)]
    for k in NAMES:
        v = args[k]
        out.append(torch.from_numpy(np.ascontiguousarray(v.T)).to(dtype) if k in DENSE
                   else torch.from_numpy(v))
    return out


# The shapes of tests/test_vit_block_fused.py: aligned tokens at hd 32,
# CLIP's padded 257 tokens at hd 64, 100 tokens at hd 64.
@pytest.mark.parametrize("b,l,c,heads,act", [(2, 128, 128, 4, "gelu"),
                                             (1, 257, 128, 2, "quick_gelu"),
                                             (1, 100, 256, 4, "quick_gelu")])
def test_matches_pallas_interpret(b, l, c, heads, act):
    x, args = make_block(b, l, c)
    want = np.asarray(vit_block_fused(jnp.asarray(x), *(jnp.asarray(args[k]) for k in NAMES),
                                      num_heads=heads, activation=act, interpret=True))
    got = pvb.vit_block(*port_args(x, args), heads, act)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@pytest.mark.parametrize("b,l,c,heads,eps", [(2, 50, 64, 2, 1e-6), (3, 17, 32, 2, 1e-5),
                                             (1, 145, 96, 6, 1e-6)])
def test_matches_xla_twin(b, l, c, heads, eps, act):
    x, args = make_block(b, l, c, seed=1)
    want = np.asarray(vit_block_reference(jnp.asarray(x), *(jnp.asarray(args[k]) for k in NAMES),
                                          heads, act, eps))
    got = pvb.vit_block(*port_args(x, args), heads, act, eps)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_bf16_rounds_where_jax_rounds(act):
    """bf16: every rounding point of the XLA twin, x1 inside the block
    among them, so an x1 that rounds the other way moves the output by one
    ulp of |x1|: atol is one bf16 ulp at the largest output, as for B1, and
    at most 2% of the elements may differ at all."""
    x, args = make_block(2, 145, 128, seed=2)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jargs = [bf(args[k]) if k in DENSE else jnp.asarray(args[k]) for k in NAMES]
    want = np.asarray(vit_block_reference(bf(x), *jargs, 2, act, 1e-5)).astype(np.float32)
    got = pvb.vit_block(*port_args(x, args, torch.bfloat16), 2, act, 1e-5)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp_max = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=ulp_max, rtol=2.0**-7)
    assert (got != want).mean() <= 0.02


def test_cpu_runs_plain_version_and_other_devices_raise():
    x, args = make_block(1, 9, 32, seed=3)
    before = pvb.vit_block.launches
    got = pvb.vit_block(*port_args(x, args), 2, "quick_gelu", 1e-5)
    assert torch.equal(got, pvb.vit_block_reference(*port_args(x, args), 2, "quick_gelu", 1e-5))
    assert pvb.vit_block.launches == before
    with pytest.raises(ValueError):
        pvb.vit_block(*(t.to("meta") for t in port_args(x, args)), 2)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_folded_scale_matches_pallas_interpret_in_bf16(act):
    """At hd 32 the scale is no power of two, so where q is rounded
    matters in bf16: the plain version with `fold_scale` (the rounding the
    CUDA kernel copies) against the JAX kernel in interpret mode, which
    keeps q scaled in f32 and rounds it at the logits product. atol as
    above; the share limit is 10%: here 2-5.5% of the outputs differ (XLA
    sums the four products and the LN statistics in its own order, and a
    flip in a shared k or v row reaches its whole frame), while the
    unfolded rounding differs in ~35%."""
    x, args = make_block(2, 128, 128, seed=4)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jargs = [bf(args[k]) if k in DENSE else jnp.asarray(args[k]) for k in NAMES]
    want = np.asarray(vit_block_fused(bf(x), *jargs, num_heads=4, activation=act,
                                      interpret=True)).astype(np.float32)
    got = pvb.vit_block_reference(*port_args(x, args, torch.bfloat16), 4, act,
                                  fold_scale=True).float().numpy()
    ulp_max = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=ulp_max, rtol=2.0**-7)
    assert (got != want).mean() <= 0.10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,heads,act", [(128, 4, "gelu"), (128, 2, "quick_gelu"),
                                         (96, 3, "quick_gelu")])
def test_composed_stages_equal_the_folded_reference(dtype, c, heads, act):
    """The plain path as the kernel composes it (LN1 rows, QKV with q's
    scale folded in, K1 at logits scale 1, K2 on x1) equals the plain
    version with the kernel's rounding of q bit for bit, at hd 32 (c 128,
    4 heads; c 96, 3 heads) and hd 64; and matches the JAX kernel in
    interpret mode within this file's bars (f32: ATOL, RTOL; bf16: those of
    `test_folded_scale_matches_pallas_interpret_in_bf16`)."""
    x, args = make_block(2, 128, c, seed=6)
    tdt = getattr(torch, dtype)
    pargs = port_args(x, args, tdt)
    got = pvb.vit_block_composed(*pargs, heads, act, 1e-6)
    assert torch.equal(got, pvb.vit_block_reference(*pargs, heads, act, 1e-6, fold_scale=True))
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if dtype == "bfloat16" else jnp.asarray
    jargs = [cast(args[k]) if k in DENSE else jnp.asarray(args[k]) for k in NAMES]
    want = np.asarray(vit_block_fused(cast(x), *jargs, num_heads=heads, activation=act,
                                      interpret=True)).astype(np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        ulp_max = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, atol=ulp_max, rtol=2.0**-7)
        assert (got != want).mean() <= 0.10
