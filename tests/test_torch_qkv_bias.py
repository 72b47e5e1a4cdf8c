"""The QKV bias of the ViT block and of CLIP's default block in bfloat16.

The JAX blocks add the f32 `qkv_b` to the f32 product and round once
(`vsc22_tpu/models/layers.py:207-209`, `vsc22_tpu/models/clip.py:122-124`).
Every JAX `init` and the port's `reset_parameters` give zero biases, so
these tests draw nonzero ones, N(0, 0.5^2): a port that rounds the bias to
bf16 before the add moves 40-70% of the outputs here.

Both sides run in bfloat16 on the CPU, with the JAX weights carried across
by `utils.jax_params`, and are held to the kernels' bf16 bar
(`chip_smoke.agreement`: <= 2^-7 + 2 bf16 ulps per element, <= 2% of the
elements differing at all).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vsc22_tpu.models import clip as jclip
from vsc22_tpu.models import layers as jlayers
from vsc22_tpu_torch.models import clip, layers
from vsc22_tpu_torch.utils import jax_params

BIAS_STD = 0.5


def with_qkv_biases(variables, seed: int) -> dict:
    """A copy of a JAX variable tree (numpy) whose every `qkv` Dense bias
    is drawn from N(0, BIAS_STD^2)."""
    tree = copy.deepcopy(jax.tree_util.tree_map(np.asarray, jax.device_get(variables)))
    rng = np.random.default_rng(seed)

    def walk(node):
        for key, sub in node.items():
            if not isinstance(sub, dict):
                continue
            if key == "qkv":
                sub["bias"] = (rng.standard_normal(sub["bias"].shape) * BIAS_STD).astype(
                    np.float32)
            else:
                walk(sub)

    walk(tree["params"])
    return tree


def as_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


def assert_bf16_bar(got, want):
    ok, err, share, words = chip_smoke.agreement(got, want, None)
    assert ok, (err, words)


def test_vit_block_bf16_qkv_bias_matches_jax():
    jm = jlayers.TransformerBlock(num_heads=2, dtype=jnp.bfloat16)
    x = np.random.default_rng(3).standard_normal((3, 17, 32)).astype(np.float32)
    variables = with_qkv_biases(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)), seed=1)
    want = as_bf16(jm.apply(variables, jnp.asarray(x)))
    block = layers.TransformerBlock(32, 2, dtype=torch.bfloat16)
    t = variables["params"]
    with torch.no_grad():
        jax_params._ln(block.norm1, t["norm1"])
        jax_params._attention(block.attn, t["attn"])
        jax_params._ln(block.norm2, t["norm2"])
        jax_params._dense(block.mlp.fc1, t["mlp"]["fc1_kernel"], t["mlp"]["fc1_bias"])
        jax_params._dense(block.mlp.fc2, t["mlp"]["fc2_kernel"], t["mlp"]["fc2_bias"])
        assert block.attn.qkv.bias.abs().max() > 1.0
        got = block(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 17, 32)
    assert_bf16_bar(got, want)


def test_clip_tower_bf16_qkv_bias_matches_jax():
    jm = jclip.clip_tiny_test(jnp.bfloat16)
    variables = with_qkv_biases(
        jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3))), seed=0)
    x = np.random.default_rng(2).standard_normal((4, 32, 32, 3)).astype(np.float32)
    want = as_bf16(jm.apply(variables, jnp.asarray(x)))
    model = jax_params.load_clip_visual(clip.clip_tiny_test(torch.bfloat16), variables)
    assert model.blocks[0].attn.qkv.bias.abs().max() > 1.0
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (4, 17, 32)
    assert_bf16_bar(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_f32_bias_rounds_once(dtype):
    """bf16: the f32 bias meets the f32 product before the one rounding;
    f32: the plain Linear."""
    gen = torch.Generator().manual_seed(0)
    lin = layers.Linear(24, 40, dtype)
    layers.reset_parameters(lin, gen)
    with torch.no_grad():
        lin.bias.copy_(torch.randn(40, generator=gen) * BIAS_STD)
    x = torch.randn((2, 5, 24), generator=gen).to(dtype)
    got = layers.linear_f32_bias(x, lin)
    assert got.dtype == dtype and got.shape == (2, 5, 40)
    if dtype == torch.bfloat16:
        want = (x.float() @ lin.weight.float().t() + lin.bias).to(dtype)
        assert torch.equal(got, want)
        assert not torch.equal(got, lin(x))  # Linear rounds the bias first
    else:
        assert torch.equal(got, lin(x))
