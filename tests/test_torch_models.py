"""Port models against the JAX models at the tiny configs: JAX-initialised
weights carried across by `utils.jax_params`, same numpy inputs, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc22_tpu.models import clip as jclip
from vsc22_tpu.models import vit as jvit
from vsc22_tpu.models import vsm as jvsm
from vsc22_tpu_torch.models import clip, vit, vsm
from vsc22_tpu_torch.models.layers import gem_pool, l2_normalize, reset_parameters
from vsc22_tpu_torch.utils import jax_params

# f32 on both sides; sums in another order through a few layers.
ATOL = 1e-4


def images(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def test_vit_descriptor_matches_jax():
    jm = jvit.vit_tiny_test_descriptor()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    x = images(3, 64)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = jax_params.load_vit_descriptor(vit.vit_tiny_test_descriptor(), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_vit_backbone_tokens_match_jax():
    jm = jvit.VisionTransformer(jvit.VIT_TINY_TEST)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    x = images(2, 64, seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = vit.VitDescriptor(vit.VIT_TINY_TEST, head_dim=64, out_dim=16)
    jax_params.load_vit_descriptor(
        model,
        {"params": {"backbone": variables["params"],
                    "gem": {"proj": {"kernel": np.zeros((32, 64)), "bias": np.zeros(64)}},
                    "head": {"kernel": np.zeros((64, 16)), "bias": np.zeros(16)}}},
    )
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 17, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_clip_visual_matches_jax():
    jm = jclip.clip_tiny_test()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3))))
    x = images(4, 32, seed=2)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = jax_params.load_clip_visual(clip.clip_tiny_test(), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 17, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("flags,op", [({"use_half_block": True}, "ln_attn_proj_residual"),
                                      ({"use_block_kernel": True}, "vit_block")],
                         ids=["half_block", "block_kernel"])
def test_clip_block_variants_match_jax(flags, op, monkeypatch):
    """The tiny CLIP tower on B9 + K2 or on B10 against the JAX tower on its
    default blocks (the same function; on the CPU the JAX dispatchers run
    their XLA twins), with the same weights, at this file's f32 bar."""
    jm = jclip.clip_tiny_test()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3))))
    x = images(3, 32, seed=5)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = jax_params.load_clip_visual(clip.clip_tiny_test(), variables)
    for block in model.blocks:
        for k, v in flags.items():
            setattr(block, k, v)
    calls = []
    real = getattr(clip, op)
    monkeypatch.setattr(clip, op, lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert len(calls) == len(model.blocks)  # every block took the variant
    assert got.shape == want.shape == (3, 17, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_clip_block_flags_default_off():
    block = clip.clip_tiny_test().blocks[0]
    assert block.use_block_kernel is False and block.use_half_block is False


def test_video_score_model_matches_jax():
    jm = jvsm.vsm_tiny_test()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 16))))
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((3, 8, 16)).astype(np.float32)
    feats[0, 5:] = 0.0  # padded frames are masked out
    feats[2, 2:] = 0.0
    want = np.asarray(jm.apply(variables, jnp.asarray(feats)))
    model = jax_params.load_video_score_model(vsm.vsm_tiny_test(), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_gem_pool_and_l2_match_jax():
    from vsc22_tpu.models.layers import gem_pool as jgem
    from vsc22_tpu.models.layers import l2_normalize as jl2

    x = np.random.default_rng(4).standard_normal((2, 9, 5)).astype(np.float32)
    np.testing.assert_allclose(
        gem_pool(torch.from_numpy(x)).numpy(), np.asarray(jgem(jnp.asarray(x))), rtol=1e-6
    )
    np.testing.assert_allclose(
        l2_normalize(torch.from_numpy(x)).numpy(), np.asarray(jl2(jnp.asarray(x))), rtol=1e-6
    )


def test_loader_rejects_wrong_shapes():
    jm = jvit.vit_tiny_test_descriptor()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    wrong = vit.VitDescriptor(vit.VIT_TINY_TEST, head_dim=32, out_dim=16)
    with pytest.raises(ValueError):
        jax_params.load_vit_descriptor(wrong, variables)


def test_seeded_init_is_reproducible_and_keeps_precision_split():
    a = vit.vit_tiny_test_descriptor(dtype=torch.bfloat16)
    b = vit.vit_tiny_test_descriptor(dtype=torch.bfloat16)
    reset_parameters(a, torch.Generator().manual_seed(7))
    reset_parameters(b, torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    block = a.backbone.blocks[0]
    assert block.attn.qkv.weight.dtype == torch.bfloat16
    assert block.attn.qkv.bias.dtype == torch.float32
    assert block.norm1.weight.dtype == torch.float32
    assert a.head.weight.dtype == torch.float32  # the head stays f32 (vit.py:113)
    assert torch.equal(block.norm1.weight, torch.ones(32))
