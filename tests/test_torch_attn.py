"""Port kernel B8 (packed attention) and `MultiHeadAttention` against the JAX
package on the CPU: B8's plain version against the JAX Pallas kernel in
interpret mode and the XLA oracle, and the module with JAX-initialised
weights carried across, with and without an attention bias and a qkv bias."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc22_tpu.models.layers import MultiHeadAttention as JaxMultiHeadAttention
from vsc22_tpu.ops.pallas_attn import _attention_xla, packed_attention as jax_packed
from vsc22_tpu_torch.models.layers import MultiHeadAttention
from vsc22_tpu_torch.ops.attn import attention, packed_attention, packed_attention_reference
from vsc22_tpu_torch.utils import jax_params

# f32 on both sides, sums in another order (the JAX kernel tests' bar).
ATOL, RTOL = 2e-5, 1e-4

# The shapes of tests/test_pallas_attn.py: aligned tokens with 4-head
# packing, CLIP's padded 257 tokens, ViT-B/32@384's 145 tokens x 12 heads,
# an odd head count.
SHAPES = [(2, 128, 4, 32), (1, 257, 4, 64), (2, 145, 12, 16), (1, 64, 3, 32)]


def make_qkv(b, l, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, l, h, hd)) * 0.3).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,l,h,hd", SHAPES)
def test_matches_pallas_interpret(b, l, h, hd):
    q, k, v = make_qkv(b, l, h, hd)
    want = np.asarray(jax_packed(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    got = packed_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,l,h,hd", SHAPES + [(3, 17, 2, 16)])
def test_matches_xla_oracle(b, l, h, hd):
    q, k, v = make_qkv(b, l, h, hd, seed=1)
    want = np.asarray(_attention_xla(*(jnp.asarray(a) for a in (q, k, v))))
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_bf16_rounds_where_jax_rounds():
    """Probabilities and output rounded to bf16 as in the XLA oracle: the
    outputs differ by at most one bf16 ulp (summation order)."""
    q, k, v = make_qkv(2, 145, 4, 64, seed=2)
    want = np.asarray(_attention_xla(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))))
    got = packed_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=2.0**-8, rtol=2.0**-7)


def test_cpu_runs_plain_version_and_other_devices_raise():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 9, 2, 16, seed=3))
    before = packed_attention.launches
    assert torch.equal(packed_attention(q, k, v), packed_attention_reference(q, k, v))
    assert packed_attention.launches == before
    with pytest.raises(ValueError):
        packed_attention(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("qkv_bias", [True, False], ids=["qkv_bias", "no_qkv_bias"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_attn_bias", "attn_bias"])
def test_multi_head_attention_matches_jax(qkv_bias, with_bias):
    """Without an attention bias the port takes B8 (q scaled before the
    product), the JAX module on the CPU its einsum path (logits scaled
    after it): the same function, f32 rounding apart."""
    b, l, c, h = 3, 19, 32, 4
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    bias = None
    if with_bias:
        mask = (rng.random((b, l)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        bias = ((1.0 - mask)[:, None, None, :] * -10000.0).astype(np.float32)
    jm = JaxMultiHeadAttention(num_heads=h, qkv_bias=qkv_bias)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    assert ("bias" in variables["params"]["qkv"]) == qkv_bias
    jb = None if bias is None else jnp.asarray(bias)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), attn_bias=jb))
    model = jax_params.load_multi_head_attention(
        MultiHeadAttention(c, h, qkv_bias=qkv_bias), variables)
    assert (model.qkv.bias is None) == (not qkv_bias)
    before = packed_attention.launches
    with torch.no_grad():
        got = model(torch.from_numpy(x), None if bias is None else torch.from_numpy(bias))
    assert packed_attention.launches == before  # the CPU runs the plain version
    assert got.shape == (b, l, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_multi_head_attention_tree_must_match_the_qkv_bias():
    jm = JaxMultiHeadAttention(num_heads=2, qkv_bias=True)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16))))
    with pytest.raises(ValueError):
        jax_params.load_multi_head_attention(MultiHeadAttention(16, 2, qkv_bias=False), variables)
