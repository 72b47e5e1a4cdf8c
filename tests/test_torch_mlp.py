"""Port kernels K2 (LayerNorm + MLP + residual) and B7 (`fused_mlp`, the
MLP alone): their plain versions against the JAX Pallas kernels
(interpret mode) and the XLA oracles; and the loop each of B7's products
takes at the SwinV2-Base stage widths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vsc22_tpu.ops.pallas_mlp import _forward, _ln_forward, _xla_ln_mlp, _xla_mlp
from vsc22_tpu_torch.ops.mlp import fused_mlp, fused_mlp_routes, ln_mlp_residual

# f32 on both sides; the sums run in another order.
ATOL = 1e-5


def make_inputs(rows, c, hidden, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, c)) * 0.5).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w1 = (rng.standard_normal((c, hidden)) * c**-0.5).astype(np.float32)  # [in, out]
    b1 = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    w2 = (rng.standard_normal((hidden, c)) * hidden**-0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, ln_s, ln_b, w1, b1, w2, b2


def port(x, ln_s, ln_b, w1, b1, w2, b2, act, eps, dtype=torch.float32):
    t = torch.from_numpy
    return ln_mlp_residual(
        t(x).to(dtype), t(ln_s), t(ln_b), t(np.ascontiguousarray(w1.T)).to(dtype), t(b1),
        t(np.ascontiguousarray(w2.T)).to(dtype), t(b2), act, eps,
    )


@pytest.mark.parametrize("act,eps", [("gelu", 1e-6), ("quick_gelu", 1e-5)])
def test_matches_pallas_interpret(act, eps):
    args = make_inputs(96, 128, 256)
    want = np.asarray(
        _ln_forward(*(jnp.asarray(a) for a in args), row_tile=64, activation=act, eps=eps,
                    interpret=True)
    )
    np.testing.assert_allclose(port(*args, act, eps).numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("act,eps", [("gelu", 1e-6), ("quick_gelu", 1e-5)])
@pytest.mark.parametrize("rows,c,hidden", [(64, 128, 256), (37, 48, 80)])
def test_matches_xla_oracle(act, eps, rows, c, hidden):
    args = make_inputs(rows, c, hidden, seed=1)
    want = np.asarray(_xla_ln_mlp(*(jnp.asarray(a) for a in args), act, eps))
    np.testing.assert_allclose(port(*args, act, eps).numpy(), want, atol=ATOL, rtol=0)


def test_bf16_rounds_where_jax_rounds():
    args = make_inputs(64, 128, 256, seed=2)
    x, ln_s, ln_b, w1, b1, w2, b2 = args
    want = np.asarray(
        _xla_ln_mlp(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(ln_s), jnp.asarray(ln_b),
            jnp.asarray(w1).astype(jnp.bfloat16), jnp.asarray(b1),
            jnp.asarray(w2).astype(jnp.bfloat16), jnp.asarray(b2), "gelu", 1e-6,
        )
    ).astype(np.float32)
    got = port(*args, "gelu", 1e-6, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=1e-2)


def test_unknown_activation_and_device_raise():
    args = make_inputs(8, 16, 32)
    with pytest.raises(ValueError):
        port(*args, "relu", 1e-5)
    t = lambda a: torch.from_numpy(a).to("meta")
    with pytest.raises(ValueError):
        ln_mlp_residual(*(t(a) for a in args), "gelu", 1e-5)


def port_mlp(x, w1, b1, w2, b2, dtype=torch.float32):
    t = torch.from_numpy
    return fused_mlp(
        t(x).to(dtype), t(np.ascontiguousarray(w1.T)).to(dtype), t(b1).to(dtype),
        t(np.ascontiguousarray(w2.T)).to(dtype), t(b2).to(dtype),
    )


def test_fused_mlp_matches_pallas_interpret():
    x, _, _, w1, b1, w2, b2 = make_inputs(96, 128, 512, seed=3)
    want = np.asarray(_forward(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), row_tile=64,
                               activation="gelu", interpret=True))
    np.testing.assert_allclose(port_mlp(x, w1, b1, w2, b2).numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("rows,c,hidden", [(64, 128, 512), (37, 48, 80), (1, 16, 64)])
def test_fused_mlp_matches_xla_oracle(rows, c, hidden):
    x, _, _, w1, b1, w2, b2 = make_inputs(rows, c, hidden, seed=4)
    want = np.asarray(_xla_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2))))
    np.testing.assert_allclose(port_mlp(x, w1, b1, w2, b2).numpy(), want, atol=ATOL, rtol=0)


def test_fused_mlp_bf16_rounds_where_jax_rounds():
    """As `layers.Mlp` calls it: the biases in bf16 too, added in f32; the
    hidden and the output rounded. Under chip_smoke's bf16 bound."""
    x, _, _, w1, b1, w2, b2 = make_inputs(96, 128, 512, seed=5)
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w1, b1, w2, b2)]
    for want in (_forward(*args, row_tile=32, activation="gelu", interpret=True),
                 _xla_mlp(*args)):
        got = port_mlp(x, w1, b1, w2, b2, torch.bfloat16)
        want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
        ok, err, share, words = chip_smoke.agreement(got, want, chip_smoke.F32_TOL)
        assert ok, (err, words)


def test_fused_mlp_takes_cpu_or_cuda_only():
    x, _, _, w1, b1, w2, b2 = make_inputs(8, 16, 32)
    t = lambda a: torch.from_numpy(a).to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_mlp(*(t(a) for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)))


# SwinV2-Base's stage widths C (hidden 4C): B7 runs there on the module
# path (`models/swinv2.py`), in f32 at stage 4 under the default dispatch
# and at every stage with `fused_block=False`.
SWINV2_BASE_WIDTHS = (128, 256, 512, 1024)


@pytest.mark.parametrize("dtype,loop", [(torch.float32, "tf32x3"), (torch.bfloat16, "mma")])
@pytest.mark.parametrize("c", SWINV2_BASE_WIDTHS)
def test_fused_mlp_routes_at_the_swinv2_base_stages(c, dtype, loop):
    """Both products on tensor cores at every stage: bf16 on the
    tensor-core loop, f32 on 3xTF32."""
    x = torch.zeros((64, c), dtype=dtype)
    w1 = torch.zeros((4 * c, c), dtype=dtype)
    w2 = torch.zeros((c, 4 * c), dtype=dtype)
    assert fused_mlp_routes(x, w1, w2) == dict(fc1=loop, fc2=loop)
