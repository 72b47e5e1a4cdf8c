"""Port kernel B6 (SwinV2 cosine window attention, `ops/window_attn.py`):
its plain version against the JAX Pallas kernel in interpret mode and the
XLA oracle, and the CPB bias and logit scale the port's `WindowAttention`
computes from the JAX parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_swinv2 import randomized_params
from vsc22_tpu.models.swinv2 import _WindowAttnParams
from vsc22_tpu.ops.pallas_window_attn import _fused_call, window_attention_reference
from vsc22_tpu_torch.models.swinv2 import WindowAttention
from vsc22_tpu_torch.ops.window_attn import window_attention
from vsc22_tpu_torch.utils.jax_params import _copy, _dense_tree

# f32 on both sides; the sums run in another order.
ATOL = 1e-5
# (W, H, N, hd, nW): a masked stage-1-like group, the masked stage-2 class,
# unmasked stage-4 windows, and tiny windows with a ragged head dim.
CASES = [(8, 4, 256, 32, 4), (6, 8, 64, 32, 2), (3, 4, 64, 32, 1), (6, 2, 16, 8, 2)]


def make_inputs(w, h, n, hd, nw, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((w, h, n, hd)).astype(np.float32) for _ in range(3))
    rpb = (16.0 / (1.0 + np.exp(-rng.standard_normal((h, n, n))))).astype(np.float32)
    scale = np.exp(rng.normal(2.0, 0.3, (h,))).astype(np.float32)
    if nw == 1:
        mask = np.zeros((1, n, n), np.float32)
    else:
        mask = np.where(rng.random((nw, n, n)) > 0.8, -100.0, 0.0).astype(np.float32)
    return q, k, v, rpb, scale, mask


def run_both(w, h, n, hd, nw, jdt, tdt):
    q, k, v, rpb, scale, mask = make_inputs(w, h, n, hd, nw)
    jqkv = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    tables = [jnp.asarray(a) for a in (rpb, scale, mask)]
    fused = _fused_call(*jqkv, *tables, nw, interpret=True)
    ref = window_attention_reference(*jqkv, *tables, nw)
    got = window_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           torch.from_numpy(rpb), torch.from_numpy(scale),
                           torch.from_numpy(mask), nw)
    assert got.dtype == tdt and got.shape == (w, h, n, hd)
    return got, [np.array(x.astype(jnp.float32)) for x in (fused, ref)]


@pytest.mark.parametrize("w,h,n,hd,nw", CASES)
def test_matches_pallas_interpret_and_oracle_f32(w, h, n, hd, nw):
    got, wants = run_both(w, h, n, hd, nw, jnp.float32, torch.float32)
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("w,h,n,hd,nw", CASES[:2])
def test_bf16_rounds_where_jax_rounds(w, h, n, hd, nw):
    """bf16 under chip_smoke's bound (2^-7 + 2 ulps, <= 2% of the outputs
    differing): a misplaced rounding of the probabilities fails it."""
    got, wants = run_both(w, h, n, hd, nw, jnp.bfloat16, torch.bfloat16)
    for want in wants:
        ok, err, share, words = chip_smoke.agreement(
            got, torch.from_numpy(want).bfloat16(), chip_smoke.F32_TOL)
        assert ok, (err, words)


@pytest.mark.parametrize("window,heads,pretrained", [(16, 4, 12), (8, 32, 6), (4, 2, 0)])
def test_cpb_bias_and_scale_match_jax(window, heads, pretrained):
    """16 * sigmoid(CPB MLP) gathered by the relative index, and
    exp(min(logit_scale, ln 100)), from the same parameters."""
    dim = 8 * heads
    jmod = _WindowAttnParams(dim, (window, window), heads, pretrained_window=pretrained)
    params = randomized_params(jmod.init(jax.random.PRNGKey(0))["params"], 5)
    params["logit_scale"][0, 0, 0] = 5.0  # above ln 100: clamped
    _, _, want_rpb, want_scale, _, _ = jmod.apply({"params": params})
    mod = WindowAttention(dim, window, heads, pretrained)
    with torch.no_grad():
        _copy(mod.logit_scale, params["logit_scale"])
        _dense_tree(mod.cpb_fc1, params["cpb_fc1"])
        _dense_tree(mod.cpb_fc2, params["cpb_fc2"])
        rpb, scale = mod.bias_and_scale()
    np.testing.assert_allclose(rpb.numpy(), np.asarray(want_rpb), atol=1e-5, rtol=0)
    np.testing.assert_allclose(scale.numpy(), np.asarray(want_scale), rtol=1e-6)
    assert scale[0].item() == pytest.approx(100.0)


def test_wrapper_takes_cpu_or_cuda_only():
    args = [torch.from_numpy(a).to("meta") for a in make_inputs(2, 2, 16, 8, 2)]
    with pytest.raises(ValueError, match="no kernel for device"):
        window_attention(*args, 2)
