"""The matching track's MobileNetV3-Small filter in the port against the JAX
model on the CPU, at full width (timm `mobilenetv3_small_100`, 2 classes),
160x160, batch 2, with the JAX variables carried by `utils.jax_params`.

The variables are random but not the JAX init (under which a random
MobileNetV3's features shrink to ~1e-6 and barely depend on the input):
conv and Dense kernels N(0, 1/fan_in), BN scales in [1, 2], running
variances in [0.5, 1.5], Dense and BN biases and running means N(0,
0.02^2), so that every BN and bias rounding is exercised and the
pre-logit features vary by ~50% across inputs. The last layer is rescaled so the logit difference
has a standard deviation of 2 (unsaturated, varied probabilities).

Tolerances:
- float32: logits within 1e-3 absolute and relative (the bar of
  `tests/test_ref_parity.py`), probabilities within 1e-5;
- bfloat16: the JAX side runs eagerly, op by op, so that each op rounds
  to bf16 as the flax modules write it (a jitted XLA CPU program may keep
  bf16 intermediates in float32); the two then differ only where a sum's
  order flips a rounding by an ulp. The head's rescaling (above) magnifies
  those flips with the logit difference: measured here 0.022 apart on
  probabilities (MobileNetV3) and 0.020 (tiny SAM); held to 5e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc22_tpu.models import mobilenetv3 as jmnv3
from vsc22_tpu_torch.models import mobilenetv3
from vsc22_tpu_torch.utils import jax_params

F32_LOGITS = 1e-3
F32_PROBS = 1e-5
BF16_PROBS = 5e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def jitted_apply(model):
    """One jitted `model.apply` per flax model config, compiled once."""
    return jax.jit(model.apply)


def jax_variables(model, sample, seed: int, last: str) -> dict:
    """Random numpy variables of a flax BN CNN (see the module docstring),
    with the kernel and bias of the top-level 2-class module `last`
    rescaled and shifted so that, over `sample`, the f32 model's logit
    difference (class 1 - class 0) has mean 0 and std 2."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), sample[:1]))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if name == "scale":
            return rng.uniform(1.0, 2.0, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    out = np.asarray(jitted_apply(model)(variables, sample), np.float32)
    diff = out[..., 1] - out[..., 0]
    scale = 2.0 / max(float(diff.std()), 1e-6)
    head = variables["params"][last]
    head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    head["bias"] = (head["bias"] * scale - np.array([0.0, scale * diff.mean()])).astype(
        np.float32)
    return variables


def jax_forward(model, variables, x, dtype):
    """float32 through one jitted program; bfloat16 eagerly (op by op)."""
    fn = jitted_apply(model) if dtype == jnp.float32 else model.apply
    return np.asarray(fn(variables, x), np.float32)


def softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def assert_logits_close(got, want, dtype, axis):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=F32_LOGITS, rtol=F32_LOGITS)
        tol = F32_PROBS
    else:
        tol = BF16_PROBS
    np.testing.assert_allclose(softmax(got, axis), softmax(want, axis), atol=tol, rtol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mobilenetv3_small_full_width_matches_jax(dt):
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(1).uniform(-1, 1, (2, 160, 160, 3)).astype(np.float32)
    jm = jmnv3.mobilenetv3_small(dtype=jdt)
    variables = jax_variables(jmnv3.mobilenetv3_small(), x, seed=1, last="classifier")
    want = jax_forward(jm, variables, x, jdt)
    model = jax_params.load_mobilenetv3(mobilenetv3.mobilenetv3_small(dtype=tdt, device="cpu"),
                                        variables)
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(variables["params"]))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    assert np.abs(want).max() > 0.5  # not a trivial head
    assert_logits_close(got.numpy(), want, tdt, axis=1)


def test_hard_sigmoid_rounds_each_op():
    """relu6(x + 3) / 6 with a bf16 rounding after the add and after the
    divide (the flax code's two ops), not `F.hardsigmoid`'s single one."""
    x = torch.linspace(-4, 4, 4097).to(torch.bfloat16)
    want = ((x.float() + 3.0).to(torch.bfloat16).float().clamp(0, 6) / 6.0).to(torch.bfloat16)
    assert torch.equal(mobilenetv3.hard_sigmoid(x), want)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jh = np.asarray(jmnv3.hard_sigmoid(jx).astype(jnp.float32))
    assert np.array_equal(jh, want.float().numpy())


def test_mobilenetv3_loader_rejects_another_width():
    x = np.zeros((1, 64, 64, 3), np.float32)
    shapes = jax.eval_shape(lambda: jmnv3.mobilenetv3_small(num_classes=3).init(
        jax.random.PRNGKey(0), x))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    with pytest.raises(ValueError, match="does not fit"):
        jax_params.load_mobilenetv3(mobilenetv3.mobilenetv3_small(device="cpu"), variables)
    with pytest.raises(ValueError, match="batch_stats"):
        jax_params.load_mobilenetv3(mobilenetv3.mobilenetv3_small(device="cpu"),
                                    {"params": variables["params"]})
