"""Biased flax Dense layers in bfloat16: the port's `Linear` (`layers.dense`)
against the JAX modules.

A flax `nn.Dense(dtype=bfloat16)` rounds twice: `dot` gives the product in
bf16, then the bias, cast to bf16, is added in bf16. Every JAX `init` and
the port's `reset_parameters` give zero biases, under which one rounding
and two agree, so these tests draw nonzero ones, N(0, 0.5^2). The sites:
`MultiHeadAttention` (qkv, proj; with and without a mask bias), the VSM's
post-LN block (fc1, fc2 beside the attention) and its `frame_proj`, the
ViT member's GeM head (`proj`), SwinV2's module-path window attention
(qkv, proj) and the patch embedding (a flax `nn.Conv` with a bias, which
adds it the same way).

Both sides run in bfloat16 on the CPU, with the JAX weights carried across
by `utils.jax_params`. bf16 outputs are held to the kernels' bf16 bar
(`chip_smoke.agreement`: <= 2^-7 + 2 bf16 ulps per element, <= 2% of the
elements differing at all); the f32 outputs of pooling heads, computed
from bf16 tokens, to f32 order noise.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vsc22_tpu.models import layers as jlayers
from vsc22_tpu.models import swinv2 as jsw
from vsc22_tpu.models import vit as jvit
from vsc22_tpu.models import vsm as jvsm
from vsc22_tpu_torch.models import layers, swinv2, vit, vsm
from vsc22_tpu_torch.utils import jax_params

BIAS_STD = 0.5


def with_biases(variables, seed: int) -> dict:
    """A numpy copy of a JAX variable tree whose every Dense or Conv bias
    (`bias`, `q_bias`, `v_bias`, `*_bias` of an MLP; not a LayerNorm's) is
    drawn from N(0, BIAS_STD^2)."""
    tree = copy.deepcopy(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)))
    rng = np.random.default_rng(seed)

    def walk(node):
        is_ln = "scale" in node and "bias" in node
        for key, sub in node.items():
            if isinstance(sub, dict):
                walk(sub)
            elif key.endswith("bias") and not is_ln:
                node[key] = (rng.standard_normal(sub.shape) * BIAS_STD).astype(np.float32)

    walk(tree["params"])
    return tree


def as_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (bf16 through f32)."""
    arr = jnp.asarray(a)
    t = torch.from_numpy(np.array(arr.astype(jnp.float32)))
    return t.to(torch.bfloat16) if arr.dtype == jnp.bfloat16 else t


def assert_bf16_bar(got, want):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    ok, err, share, words = chip_smoke.agreement(got, want, None)
    assert ok, (err, words)


def test_dense_rounds_the_product_then_the_bias():
    gen = torch.Generator().manual_seed(0)
    lin = layers.Linear(24, 40, torch.bfloat16)
    layers.reset_parameters(lin, gen)
    with torch.no_grad():
        lin.bias.copy_(torch.randn(40, generator=gen) * BIAS_STD)
        x = torch.randn((2, 5, 24), generator=gen).to(torch.bfloat16)
        product = (x.float() @ lin.weight.float().t()).to(torch.bfloat16)
        want = (product.float() + lin.bias.to(torch.bfloat16).float()).to(torch.bfloat16)
        assert torch.equal(lin(x), want)
        f32 = layers.Linear(24, 40)
        layers.reset_parameters(f32, gen)
        f32.bias.copy_(torch.randn(40, generator=gen))
        xf = x.float()
        assert torch.equal(f32(xf), torch.nn.functional.linear(xf, f32.weight, f32.bias))


@pytest.mark.parametrize("masked", [False, True], ids=["no_bias", "mask_bias"])
def test_multi_head_attention_bf16_dense_biases_match_jax(masked):
    jm = jlayers.MultiHeadAttention(num_heads=2, dtype=jnp.bfloat16)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 11, 32)).astype(np.float32)
    bias = None
    if masked:
        keep = rng.random((3, 11)) > 0.3
        keep[:, 0] = True
        bias = ((1.0 - keep)[:, None, None, :] * -10000.0).astype(np.float32)
    variables = with_biases(jm.init(jax.random.PRNGKey(5), jnp.asarray(x)), seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = as_torch(jm.apply(variables, xb, True, None if bias is None else jnp.asarray(bias)))
    mod = jax_params.load_multi_head_attention(
        layers.MultiHeadAttention(32, 2, torch.bfloat16), variables)
    assert mod.proj.bias.abs().max() > 0.5
    with torch.no_grad():
        got = mod(as_torch(xb), None if bias is None else torch.from_numpy(bias))
    assert_bf16_bar(got, want)


def test_vsm_post_ln_block_bf16_dense_biases_match_jax():
    jm = jvsm.PostLNBlock(heads=2, dtype=jnp.bfloat16)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 10, 32)).astype(np.float32)
    keep = rng.random((3, 10)) > 0.3
    keep[:, :2] = True
    bias = ((1.0 - keep)[:, None, None, :] * -10000.0).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    variables = with_biases(jm.init(jax.random.PRNGKey(6), xb, jnp.asarray(bias)), seed=6)
    want = as_torch(jm.apply(variables, xb, jnp.asarray(bias)))
    block = vsm.PostLNBlock(32, 2, torch.bfloat16)
    t = variables["params"]
    with torch.no_grad():
        jax_params._attention(block.attn, t["attn"])
        jax_params._ln(block.ln_attn, t["ln_attn"])
        jax_params._dense_tree(block.fc1, t["fc1"])
        jax_params._dense_tree(block.fc2, t["fc2"])
        jax_params._ln(block.ln_mlp, t["ln_mlp"])
        assert block.fc2.bias.abs().max() > 0.5
        got = block(as_torch(xb), torch.from_numpy(bias))
    assert_bf16_bar(got, want)


def test_vsm_bf16_dense_biases_match_jax():
    """The whole tiny VSM (frame_proj and both post-LN blocks biased): its
    f32 logits, from an f32 head over bf16 states, within f32 order noise."""
    jm = jvsm.vsm_tiny_test(jnp.bfloat16)
    variables = with_biases(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 16))), seed=3)
    feats = np.random.default_rng(3).standard_normal((4, 8, 16)).astype(np.float32)
    feats[0, 5:] = 0.0
    want = np.asarray(jm.apply(variables, jnp.asarray(feats)))
    model = jax_params.load_video_score_model(vsm.vsm_tiny_test(torch.bfloat16), variables)
    assert model.frame_proj.bias.abs().max() > 0.5
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gem_head_bf16_dense_bias_matches_jax():
    """GeM's 1x1 `proj` in bf16, then the f32 pool of its bf16 tokens."""
    jm = jlayers.GeMPool(proj_dim=48, dtype=jnp.bfloat16)
    x = np.random.default_rng(7).standard_normal((3, 9, 32)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    variables = with_biases(jm.init(jax.random.PRNGKey(7), xb), seed=7)
    # Positive tokens, so the clamp at 1e-6 keeps most of them.
    variables["params"]["proj"]["bias"] = np.abs(variables["params"]["proj"]["bias"]) + 1.0
    want = np.asarray(jm.apply(variables, xb))
    mod = layers.GeMPool(32, 48, dtype=torch.bfloat16)
    with torch.no_grad():
        jax_params._dense_tree(mod.proj, variables["params"]["proj"])
        got = mod(as_torch(xb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_vit_descriptor_bf16_biases_match_jax():
    """The tiny ViT member in bf16 with every bias drawn (patch conv,
    blocks, GeM proj, head): f32 descriptors within f32 order noise of a
    pool over equal bf16 tokens."""
    jm = jvit.vit_tiny_test_descriptor(jnp.bfloat16)
    variables = with_biases(jm.init(jax.random.PRNGKey(8), jnp.zeros((1, 64, 64, 3))), seed=8)
    x = np.random.default_rng(8).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = jax_params.load_vit_descriptor(vit.vit_tiny_test_descriptor(torch.bfloat16),
                                           variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_swinv2_module_path_attention_bf16_biases_match_jax(shifted):
    dim, window, heads, res = 32, 4, 2, 8
    mask = jsw._shift_attn_mask(res, res, window, window // 2) if shifted else None
    nw = 1 if mask is None else mask.shape[0]
    jm = jsw.WindowAttention(dim, (window, window), heads, dtype=jnp.bfloat16, fused=False)
    x = np.random.default_rng(9).standard_normal((2 * nw, window * window, dim))
    xb = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    variables = with_biases(jm.init(jax.random.PRNGKey(9), xb, mask), seed=9)
    want = as_torch(jm.apply(variables, xb, mask))
    mod = swinv2.WindowAttention(dim, window, heads, dtype=torch.bfloat16)
    t = variables["params"]
    with torch.no_grad():
        jax_params._copy(mod.logit_scale, t["logit_scale"])
        jax_params._copy(mod.qkv_weight, np.asarray(t["qkv_kernel"]).T)
        jax_params._copy(mod.q_bias, t["q_bias"])
        jax_params._copy(mod.v_bias, t["v_bias"])
        jax_params._dense_tree(mod.cpb_fc1, t["cpb_fc1"])
        jax_params._dense_tree(mod.cpb_fc2, t["cpb_fc2"])
        jax_params._dense_tree(mod.proj, t["proj"])
        torch_mask = torch.from_numpy(
            mask if mask is not None else np.zeros((1, window**2, window**2), np.float32))
        got = mod(as_torch(xb), torch_mask, nw)
    assert_bf16_bar(got, want)


@pytest.mark.parametrize("patch", [4, 16])
def test_patch_embed_bf16_conv_bias_matches_jax(patch):
    """A flax `nn.Conv(dtype=bf16)` with a bias, stride = kernel (the ViT
    and SwinV2 patch embeddings)."""
    import flax.linen as nn

    jm = nn.Conv(24, (patch, patch), strides=(patch, patch), padding="VALID",
                 dtype=jnp.bfloat16)
    x = np.random.default_rng(patch).standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = with_biases(jm.init(jax.random.PRNGKey(patch), jnp.asarray(x)), seed=patch)
    want = as_torch(jm.apply(variables, jnp.asarray(x)))
    want = want.reshape(2, -1, 24)
    mod = layers.PatchEmbed(patch, 24, torch.bfloat16)
    with torch.no_grad():
        jax_params._conv(mod, variables["params"])
        got = mod(torch.from_numpy(x))
    assert_bf16_bar(got, want)
