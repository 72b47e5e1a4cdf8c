"""The gradients of the port's kernel wrappers against `jax.grad` through
the JAX package's `custom_vjp` functions, on the CPU, on the same numpy
inputs: K1, B9 (`ops/attn_proj.py`), K2, B7 (`ops/mlp.py`), B10
(`ops/vit_block.py`), B8 (`ops/attn.py`), B6 (`ops/window_attn.py`) and
B1 (`ops/swin_block.py`). On the CPU a wrapper is its plain version and
torch's autograd differentiates it; the JAX side runs as its own tests
run it (the XLA oracle, or the Pallas kernel in interpret mode for K2,
B7 and B6), its backward `jax.vjp` of the plain XLA function. Then the
recompute helper of the card path (`ops/vjp.py`), and B5 and K3, which
have no VJP and raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc22_tpu.ops import pallas_attn, pallas_attn_proj, pallas_mlp, pallas_vit_block
from vsc22_tpu.ops.pallas_swin_block import swin_block as jax_swin_block
from vsc22_tpu.ops.pallas_window_attn import window_attention_chunked, window_attention_fused
from vsc22_tpu_torch.ops import attn, attn_proj, mlp, sim, swin_block, topk, vit_block
from vsc22_tpu_torch.ops import window_attn
from vsc22_tpu_torch.ops.vjp import recompute_vjp

# |port - JAX| <= TOL * max |JAX gradient| per input (f32).
TOL = 1e-5


def _w(rng, *shape, std=0.05):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _ln(rng, c):
    return (1 + _w(rng, c, std=0.1)), _w(rng, c, std=0.1)


def k1_case(rng):
    b, l, c, h = 2, 17, 32, 2
    x, qkv = _w(rng, b, l, c, std=1.0), _w(rng, b, l, 3 * c, std=1.0)
    pw, pb = _w(rng, c, c), _w(rng, c)
    return (pallas_attn_proj.attn_proj_residual, attn_proj.attn_proj_residual,
            [x, qkv, pw, pb], "..T.", (h,))


def b9_case(rng):
    b, l, c, h = 2, 17, 32, 2
    s, bb = _ln(rng, c)
    args = [_w(rng, b, l, c, std=1.0), s, bb, _w(rng, c, 3 * c), _w(rng, 3 * c),
            _w(rng, c, c), _w(rng, c)]
    return (pallas_attn_proj.ln_attn_proj_residual, attn_proj.ln_attn_proj_residual,
            args, "...T.T.", (h, 1e-6))


def k2_case(rng):
    rows, c, f = 24, 128, 256  # aligned: JAX runs its Pallas kernel in interpret mode
    s, bb = _ln(rng, c)
    args = [_w(rng, rows, c, std=1.0), s, bb, _w(rng, c, f), _w(rng, f), _w(rng, f, c),
            _w(rng, c)]
    return pallas_mlp.ln_mlp_residual, mlp.ln_mlp_residual, args, "...T.T.", ("gelu", 1e-6)


def b7_case(rng):
    rows, c, f = 24, 128, 256
    args = [_w(rng, rows, c, std=1.0), _w(rng, c, f), _w(rng, f), _w(rng, f, c), _w(rng, c)]
    return (lambda *a: pallas_mlp.fused_mlp(*a, "gelu"), mlp.fused_mlp, args, ".T.T.", ())


def b10_case(rng):
    b, l, c, h = 2, 17, 32, 2
    s1, b1 = _ln(rng, c)
    s2, b2 = _ln(rng, c)
    args = [_w(rng, b, l, c, std=1.0), s1, b1, _w(rng, c, 3 * c), _w(rng, 3 * c),
            _w(rng, c, c), _w(rng, c), s2, b2, _w(rng, c, 4 * c), _w(rng, 4 * c),
            _w(rng, 4 * c, c), _w(rng, c)]
    return (pallas_vit_block.vit_block, vit_block.vit_block, args, "...T.T...T.T.",
            (h, "gelu", 1e-6))


def b8_case(rng):
    q, k, v = (_w(rng, 2, 17, 2, 16, std=1.0) for _ in range(3))
    return pallas_attn.attention, attn.packed_attention, [q * 0.25, k, v], "...", ()


def _mask(rng, nw, n):
    return np.where(rng.random((nw, n, n)) > 0.9, -100.0, 0.0).astype(np.float32)


def b6_case(rng):
    w, h, n, hd, nw = 4, 2, 16, 8, 2
    q, k, v = (_w(rng, w, h, n, hd, std=1.0) for _ in range(3))
    rpb = _w(rng, h, n, n, std=1.0)
    scale = np.exp(_w(rng, h, std=0.1) + 2.0).astype(np.float32)
    return (lambda *a: window_attention_fused(*a, nw, interpret=True),
            lambda *a: window_attn.window_attention(*a, nw),
            [q, k, v, rpb, scale, _mask(rng, nw, n)], "......", ())


def b1_case(rng):
    w, n, c, h, nw = 4, 16, 32, 2, 2
    f = 4 * c
    qkv_b = _w(rng, 3 * c)
    qkv_b[c:2 * c] = 0.0  # the q/v-bias contract
    s1, b1 = _ln(rng, c)
    s2, b2 = _ln(rng, c)
    args = [_w(rng, w, n, c, std=1.0), _w(rng, c, 3 * c), qkv_b, _w(rng, c, c), _w(rng, c),
            s1, b1, _w(rng, c, f), _w(rng, f), _w(rng, f, c), _w(rng, c), s2, b2,
            _w(rng, h, n, n, std=1.0), np.exp(_w(rng, h, std=0.1) + 2.0).astype(np.float32),
            _mask(rng, nw, n)]
    return jax_swin_block, swin_block.swin_block, args, ".T.T...T.T......", (h, nw)


CASES = {"K1": k1_case, "B9": b9_case, "K2": k2_case, "B7": b7_case, "B10": b10_case,
         "B8": b8_case, "B6": b6_case, "B1": b1_case}


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_gradients_match_jax_custom_vjp(name):
    """Every input's gradient of sum(out * cotangent): the port wrapper's
    (Linear weights [out, in], so those compare transposed) against
    `jax.grad` through the JAX function."""
    rng = np.random.default_rng(0)
    jax_fn, port_fn, args, layouts, static = CASES[name](rng)
    out = np.asarray(jax_fn(*map(jnp.asarray, args), *static))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a, *static) * cot),
                    argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    tensors = [torch.from_numpy(np.ascontiguousarray(a.T if lay == "T" else a))
               .requires_grad_() for a, lay in zip(args, layouts)]
    got = port_fn(*tensors, *static)
    np.testing.assert_allclose(got.detach().numpy(), out, atol=1e-5, rtol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    for i, (t, w, lay) in enumerate(zip(tensors, want, layouts)):
        g = t.grad.numpy()
        w = np.asarray(w)
        w = w.T if lay == "T" else w
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= TOL * scale, (name, i, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("chunk_windows", [3, 4, 40])
def test_chunked_window_attention_matches_jax(chunk_windows):
    """`window_attention_chunked` (SwinV2's train attention and B6's
    recompute) with its byte budget set to `chunk_windows` windows' logits
    (3: rounded to whole 2-window items; 40: one call): output and
    gradients against the JAX `window_attention_chunked` at the same
    budget, on 10 windows of nW 2."""
    rng = np.random.default_rng(2)
    w, h, n, hd, nw = 10, 2, 16, 8, 2
    q, k, v = (_w(rng, w, h, n, hd, std=1.0) for _ in range(3))
    rpb = _w(rng, h, n, n, std=1.0)
    scale = np.exp(_w(rng, h, std=0.1) + 2.0).astype(np.float32)
    args = [q, k, v, rpb, scale, _mask(rng, nw, n)]
    budget = chunk_windows * h * n * n * 4
    fn = lambda *a: window_attention_chunked(*a, nw, max_temp_bytes=budget)
    out = np.asarray(fn(*map(jnp.asarray, args)))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(fn(*a) * cot), argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    got = window_attn.window_attention_chunked(*tensors, nw, max_temp_bytes=budget)
    np.testing.assert_allclose(got.detach().numpy(), out, atol=1e-5, rtol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(tensors, want):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= TOL * max(float(np.abs(g).max()), 1e-30)


def test_recompute_vjp_is_autograd_of_the_plain_version():
    """The card path's helper, with the plain version standing in for the
    kernel: its gradients are autograd's through the plain version, an
    input that needs none gets none, the static arguments get None, and
    without grad it calls the kernel alone."""
    calls = []

    def kernel(*a):
        calls.append(torch.is_grad_enabled())
        return attn_proj.attn_proj_residual_reference(*a)

    fn = recompute_vjp(kernel, attn_proj.attn_proj_residual_reference, 4)
    rng = np.random.default_rng(1)
    _, _, args, _, (h,) = k1_case(rng)
    args[2] = np.ascontiguousarray(args[2].T)
    cot = torch.from_numpy(rng.standard_normal(args[0].shape).astype(np.float32))
    direct = [torch.from_numpy(a).requires_grad_(i != 3) for i, a in enumerate(args)]
    (attn_proj.attn_proj_residual_reference(*direct, h) * cot).sum().backward()
    via = [torch.from_numpy(a).requires_grad_(i != 3) for i, a in enumerate(args)]
    out = fn(*via, h)
    assert out.grad_fn is not None and calls == [False]  # the kernel runs under no_grad
    (out * cot).sum().backward()
    for a, b in zip(direct, via):
        if a.requires_grad:
            torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=0)
        else:
            assert b.grad is None
    with torch.no_grad():
        assert fn(*via, h).grad_fn is None
    plain = [torch.from_numpy(a) for a in args]
    assert fn(*plain, h).grad_fn is None and len(calls) == 3


def test_topk_and_row_max_refuse_grad():
    """B5 and K3 have no VJP (neither has the JAX kernel): an operand that
    requires grad raises, on either device; under no_grad they run."""
    q = torch.randn(8, 16, requires_grad=True)
    r = torch.randn(40, 16)
    with pytest.raises(RuntimeError, match="not differentiable"):
        topk.extract_topk(q, r, 40, e=2, tile_r=8, k=4)
    with pytest.raises(RuntimeError, match="not differentiable"):
        sim.row_max_gemm(r, q)
    with torch.no_grad():
        assert sim.row_max_gemm(q, r).shape == (8,)
        assert topk.extract_topk(q, r, 40, e=2, tile_r=8, k=4)[0].shape == (8, 4)
