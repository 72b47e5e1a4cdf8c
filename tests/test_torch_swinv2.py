"""The port's SwinV2 against the JAX package: the geometry copies, the path
choice of each block, kernel B1 (`ops/swin_block.py`, its plain version on
the CPU) against the JAX Pallas kernel in interpret mode and its XLA
oracle, and the whole model on both block paths with JAX weights."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vsc22_tpu.models import swinv2 as jsw
from vsc22_tpu.ops.pallas_swin_block import _vmem_estimate as jax_vmem_estimate
from vsc22_tpu.ops.pallas_swin_block import swin_block_fused, swin_block_reference
from vsc22_tpu_torch.models import clip, swinv2, vit, vsm
from vsc22_tpu_torch.models.layers import reset_parameters
from vsc22_tpu_torch.ops.swin_block import swin_block
from vsc22_tpu_torch.utils.jax_params import load_swinv2_descriptor
from test_swin_block_fused import _block_args

# The four shape classes of tests/test_swin_block_fused.py: (W, N, C, H, nW).
BLOCK_CASES = [(8, 256, 128, 4, 4), (4, 256, 256, 8, 2), (8, 256, 128, 4, 1), (4, 64, 128, 4, 1)]
# bf16 share limit against JAX on the CPU. XLA and torch sum in other
# orders on the CPU, and B1 rounds seven times inside, so flips cascade:
# 0.4-4.4% of the outputs differ at these shapes (up to 10% at the stage-3
# and stage-4 widths), while each single rounding left out or added changes
# 30-61%. On the card, kernel against plain, the limit is chip_smoke's 2%.
CPU_BLOCK_MAX_SHARE = 0.20
# A narrow config whose blocks all take the fused path in the port (C and
# the MLP width multiples of 128) but the module path in JAX on the CPU:
# stage 1 is shifted and masked (nW = 4, N = 64), stage 2 is one window.
NARROW = dict(img_size=32, patch_size=2, embed_dim=128, depths=(2, 2), num_heads=(4, 8),
              window_size=8, pretrained_window_sizes=(6, 0), output_dim=8)


def randomized_params(params, seed: int):
    """A flax param tree of the same shapes with seeded random values, so
    that no block is an identity (JAX zero-inits the post-norm LN scales and
    the q/v biases): LN scales 1 + N(0, 0.2^2), biases N(0, 0.05^2),
    logit_scale ln 10 + N(0, 0.3^2), kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(params))
    out = {}
    for key, value in flat.items():
        shape, name = np.shape(value), key[-1]
        if name == "logit_scale":
            r = np.log(10.0) + 0.3 * rng.standard_normal(shape)
        elif name == "scale":
            r = 1.0 + 0.2 * rng.standard_normal(shape)
        elif "bias" in name:
            r = 0.05 * rng.standard_normal(shape)
        else:
            r = rng.standard_normal(shape) * max(int(np.prod(shape[:-1])), 1) ** -0.5
        out[key] = r.astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def test_geometry_copies_match_jax():
    for wh, pretrained in ((16, 12), (8, 6), (4, 0), (2, 0)):
        np.testing.assert_array_equal(swinv2._relative_position_index(wh, wh),
                                      jsw._relative_position_index(wh, wh))
        np.testing.assert_array_equal(swinv2._relative_coords_table(wh, wh, pretrained),
                                      jsw._relative_coords_table(wh, wh, pretrained))
    for res, window, shift in ((64, 16, 8), (32, 16, 8), (16, 8, 4), (8, 4, 2)):
        np.testing.assert_array_equal(swinv2._shift_attn_mask(res, res, window, shift),
                                      jsw._shift_attn_mask(res, res, window, shift))
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 8)).astype(np.float32)
    want = np.asarray(jsw.window_partition(jnp.asarray(x), 4))
    got = swinv2.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(swinv2.window_reverse(got, 4, 16, 16).numpy(), x)
    for args in ((1, 256, 128, 512, 4, 2), (1, 64, 1024, 4096, 32, 4), (1, 64, 1024, 4096, 32, 2),
                 (1, 256, 512, 2048, 16, 4)):
        assert swinv2._vmem_estimate(*args) == jax_vmem_estimate(*args)


def _blocks(model):
    return [b for stage in model.stages for b in stage]


def test_base_windows_and_block_paths():
    """SwinV2-Base@256: stages 1-2 alternate unshifted and shifted 16x16
    windows (nW 16 and 4), stage 3 is one unshifted 16x16 window in all 18
    blocks, stage 4 is one unshifted 8x8 window. In bf16 every block takes
    B1; in f32 stage 4 takes the module path (the TPU VMEM estimate is
    50 MB); `fused_block=False` and the tiny widths always do."""
    bf16 = swinv2.swinv2_base_256_descriptor(torch.bfloat16, device="meta")
    blocks = _blocks(bf16)
    assert len(blocks) == 24
    geometry = [(b.res, b.window, b.shift, b.mask.shape[0]) for b in blocks]
    assert geometry == ([(64, 16, 0, 1), (64, 16, 8, 16), (32, 16, 0, 1), (32, 16, 8, 4)]
                        + [(16, 16, 0, 1)] * 18 + [(8, 8, 0, 1)] * 2)
    assert all(b.fused for b in blocks)
    f32 = swinv2.swinv2_base_256_descriptor(torch.float32, device="meta")
    assert [b.fused for b in _blocks(f32)] == [True] * 22 + [False] * 2
    off = swinv2.swinv2_base_256_descriptor(torch.bfloat16, device="meta", fused_block=False)
    assert not any(b.fused for b in _blocks(off))
    assert not any(b.fused for b in _blocks(swinv2.swinv2_tiny_test_descriptor()))


@pytest.mark.parametrize(
    "make_model",
    [swinv2.swinv2_base_256_descriptor, vit.vit_base_patch32_384_descriptor,
     clip.clip_vit_l14, vsm.vsm_base],
)
def test_base_models_default_to_the_card(make_model):
    """Without a card, a Base model made with no device named raises rather
    than landing on the CPU; an explicit device is taken as given."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_model()
    model = make_model(device="meta")
    assert next(model.parameters()).device.type == "meta"


def _port_block_args(args, dtype):
    """The JAX block arguments as the port takes them: Linear layouts, the
    matmul weights in `dtype`, everything else f32."""
    def t(k, transpose=False, dt=torch.float32):
        a = np.asarray(args[k]).astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a)).to(dt)
    return (t("x", dt=dtype), t("qkv_w", True, dtype), t("qkv_b"), t("proj_w", True, dtype),
            t("proj_b"), t("ln1_s"), t("ln1_b"), t("fc1_w", True, dtype), t("fc1_b"),
            t("fc2_w", True, dtype), t("fc2_b"), t("ln2_s"), t("ln2_b"), t("rpb"), t("scale"),
            t("mask"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w,n,c,h,nw", BLOCK_CASES)
def test_swin_block_matches_jax(w, n, c, h, nw, dtype):
    """f32 at the JAX kernel test's bar (atol 2e-4). bf16 under chip_smoke's
    elementwise bound for B1 (`block=True`) and CPU_BLOCK_MAX_SHARE. The bf16 Pallas
    run takes the per-window kernel: XLA on the CPU has no bf16 x bf16 -> f32
    product in the batched kernel's layout; both kernels compute one function."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    args = _block_args(np.random.default_rng(0), w, n, c, h, nw, dtype=jdt)
    if nw == 1:  # unshifted blocks carry no mask (the kernels never read it)
        args["mask"] = jnp.zeros_like(args["mask"])
    fused = swin_block_fused(**args, num_heads=h, num_shift_windows=nw, apply_mask=nw > 1,
                             interpret=True, batched=None if dtype == "float32" else False)
    ref = swin_block_reference(**args, num_heads=h, num_shift_windows=nw)
    got = swin_block(*_port_block_args(args, getattr(torch, dtype)), h, nw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (w, n, c)
    for want in (fused, ref):
        want = np.array(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
        else:
            ok, err, share, words = chip_smoke.agreement(
                got, torch.from_numpy(want).bfloat16(), chip_smoke.F32_TOL, block=True,
                max_share=CPU_BLOCK_MAX_SHARE)
            assert ok, (err, words)


@pytest.mark.parametrize("config", ["tiny", "narrow"])
def test_swinv2_matches_jax(config):
    """The whole model with JAX weights, f32, <= 1e-3: at the tiny widths
    every block takes the module path (B6 + B7 plain versions) on both
    sides; at the narrow config the port takes B1, JAX its module path."""
    if config == "tiny":
        jcfg, pcfg = jsw.SWINV2_TINY_TEST, swinv2.SWINV2_TINY_TEST
    else:
        jcfg = jsw.SwinV2Config(**NARROW, drop_path_rate=0.0)
        pcfg = swinv2.SwinV2Config(**NARROW)
    size = jcfg.img_size
    jmodel = jsw.SwinTransformerV2(cfg=jcfg)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    params = {"params": randomized_params(init["params"], 1)}
    images = np.random.default_rng(2).standard_normal((3, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(images)))
    model = load_swinv2_descriptor(swinv2.SwinTransformerV2(pcfg), params)
    assert all(b.fused == (config == "narrow") for b in _blocks(model))
    with torch.inference_mode():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == (3, 8)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_reset_parameters_gives_working_blocks():
    """The seeded init is representative: logit scale ln 10 as in JAX,
    non-zero post-norm LN scales (no identity blocks), q/v biases in use,
    and a CPB table that varies by relative position (a constant one would
    cancel in the softmax and hide a wrong relative index)."""
    model = swinv2.swinv2_tiny_test_descriptor()
    reset_parameters(model, torch.Generator().manual_seed(0))
    for block in _blocks(model):
        a = block.attn
        torch.testing.assert_close(a.logit_scale, torch.full_like(a.logit_scale, np.log(10.0)))
        assert block.norm1.weight.abs().min() > 0 and block.norm2.weight.abs().min() > 0
        assert a.q_bias.abs().sum() > 0 and a.v_bias.abs().sum() > 0
        rpb, _ = a.bias_and_scale()
        assert all(len(torch.unique(rpb[h])) > 5 for h in range(rpb.shape[0]))
    with torch.inference_mode():
        out = model(torch.rand(2, 32, 32, 3))
    assert out.shape == (2, 8) and torch.isfinite(out).all()


def test_swin_block_wrapper_takes_cpu_or_cuda_only():
    args = _block_args(np.random.default_rng(3), 2, 16, 32, 2, 2)
    port = [a.to("meta") for a in _port_block_args(args, torch.float32)]
    with pytest.raises(ValueError, match="no kernel for device"):
        swin_block(*port, 2, 2)
