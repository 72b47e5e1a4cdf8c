"""Port transforms against the JAX transforms: crop + resize + normalize
and the CLIP preprocess, f32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc22_tpu.data import transforms as jt
from vsc22_tpu_torch.data import transforms as pt


def frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_cubic_weights_and_presets_are_the_jax_ones():
    assert pt.PRESETS == jt.PRESETS
    for args in [(50, 32), (70, 32, 0, 60), (360, 384, 60, 300), (20, 64, 3, 17)]:
        np.testing.assert_array_equal(
            pt.cubic_resize_weights(*args), jt.cubic_resize_weights(*args)
        )


@pytest.mark.parametrize("box", [(0, 50, 0, 70), (5, 45, 0, 60), (12, 30, 20, 69)])
def test_crop_resize_normalize_f32(box):
    x = frames(3, 50, 70)
    row_w = jt.cubic_resize_weights(50, 32, box[0], box[1])
    col_w = jt.cubic_resize_weights(70, 32, box[2], box[3])
    want = np.asarray(jt.crop_resize_normalize(jnp.asarray(x), jnp.asarray(row_w),
                                               jnp.asarray(col_w), preset="vit"))
    got = pt.crop_resize_normalize(torch.from_numpy(x), torch.from_numpy(row_w),
                                   torch.from_numpy(col_w), preset="vit")
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 32, 32, 3)
    # f32 contractions over <= 70 taps, summed in another order.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _jax_bf16_semantics(x, row_w, col_w, preset):
    """`transforms.crop_resize_normalize` for a bf16 consumer, written with
    f32 einsums over bf16-rounded operands (XLA's CPU backend has no bf16 x
    bf16 -> f32 dot; bf16 products are exact in f32, so this is the same
    arithmetic)."""
    bf, f32 = jnp.bfloat16, jnp.float32
    mean, std = jt.PRESETS[preset]
    xb = (jnp.asarray(x).astype(bf) / jnp.asarray(255.0, bf)).astype(f32)
    y = jnp.einsum("nhwc,hs->nswc", xb, jnp.asarray(row_w).astype(bf).astype(f32))
    y = jnp.einsum("nswc,wt->nstc", y.astype(bf).astype(f32),
                   jnp.asarray(col_w).astype(bf).astype(f32))
    return ((y - jnp.asarray(mean)) / jnp.asarray(std)).astype(bf)


def test_crop_resize_normalize_bf16():
    x = frames(2, 48, 64, seed=1)
    row_w = jt.cubic_resize_weights(48, 40, 4, 44)
    col_w = jt.cubic_resize_weights(64, 40)
    want = np.asarray(_jax_bf16_semantics(x, row_w, col_w, "efficientnet")).astype(np.float32)
    got = pt.crop_resize_normalize(torch.from_numpy(x), torch.from_numpy(row_w),
                                   torch.from_numpy(col_w), preset="efficientnet",
                                   out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # bf16 operands and outputs (values in [-1, 1]): one bf16 ulp.
    np.testing.assert_allclose(got.float().numpy(), want, atol=8e-3, rtol=0)


@pytest.mark.parametrize("h,w", [(48, 80), (90, 40), (32, 32)])
def test_clip_preprocess(h, w):
    x = frames(2, h, w, seed=2)
    want = np.asarray(jt.clip_preprocess(jnp.asarray(x), 32))
    got = pt.clip_preprocess(torch.from_numpy(x), 32)
    assert tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _crop_resize_normalize_before(frames_u8, row_w, col_w, preset, out_dtype):
    """`crop_resize_normalize` as it was before its constants and weights
    were cached on the device: every operand uploaded on each call."""
    mean, std = pt.PRESETS[preset]
    ct = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    device = frames_u8.device
    x = frames_u8.to(ct) / torch.tensor(255.0, dtype=ct, device=device)
    rw = torch.as_tensor(row_w, device=device).to(ct).float()
    cw = torch.as_tensor(col_w, device=device).to(ct).float()
    y = torch.einsum("nhwc,hs->nswc", x.float(), rw).to(ct)
    y = torch.einsum("nswc,wt->nstc", y.float(), cw)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=device)
    std_t = torch.tensor(std, dtype=torch.float32, device=device)
    return ((y - mean_t) / std_t).to(out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed,preset", list(enumerate(sorted(pt.PRESETS))))
def test_cached_constants_keep_the_bits(seed, preset, out_dtype):
    """With the preset's constants and the resize weights cached on the
    device, the three transforms give what they gave before, bit for bit,
    for weights given as arrays and as tensors (twice: the cached path)."""
    x = torch.from_numpy(frames(2, 45, 70, seed=10 + seed))
    row_w = pt.cubic_resize_weights(45, 32, 3, 40)
    col_w = pt.cubic_resize_weights(70, 32, 5, 66)
    want = _crop_resize_normalize_before(x, row_w, col_w, preset, out_dtype)
    square = [pt.cubic_resize_weights(n, 32) for n in (45, 70)]
    nh, nw, top, left = pt.clip_crop_shape(45, 70, 32)
    clip = [pt.cubic_resize_weights(45, nh)[:, top : top + 32],
            pt.cubic_resize_weights(70, nw)[:, left : left + 32]]
    for _ in range(2):
        for rw, cw in ((row_w, col_w), (torch.from_numpy(row_w), torch.from_numpy(col_w))):
            assert torch.equal(pt.crop_resize_normalize(x, rw, cw, preset, out_dtype), want)
        assert torch.equal(pt.resize_normalize(x, 32, preset, out_dtype),
                           _crop_resize_normalize_before(x, *square, preset, out_dtype))
        assert torch.equal(pt.clip_preprocess(x, 32, out_dtype),
                           _crop_resize_normalize_before(x, *clip, "clip", out_dtype))
