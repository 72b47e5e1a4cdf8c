"""Keywords of the JAX package the port now takes, each against JAX on the
CPU: the tiny SwinV2's `output_dim`/`img_size`/`window_size` overrides
(directly and through the registry's config keys, as the learning demo's
config passes them), `gem_pool(axis=)` and `l2_normalize(axis=)`, and the
FSD entry points' `device_frames` and `use_device_maps`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from test_torch_swinv2 import randomized_params
from vsc22_tpu.data import fsd as jfsd
from vsc22_tpu.models import layers as jlayers
from vsc22_tpu.models import swinv2 as jsw
from vsc22_tpu_torch.data import fsd
from vsc22_tpu_torch.models import layers, registry, swinv2
from vsc22_tpu_torch.utils.jax_params import load_swinv2_descriptor

OVERRIDES = dict(output_dim=32, img_size=64, window_size=8)  # scripts/learning_demo.py


def test_tiny_swinv2_overrides_match_jax():
    """f32, JAX weights, <= 1e-3 (the full-model bar of test_swinv2_matches_jax)."""
    jm = jsw.swinv2_tiny_test_descriptor(**OVERRIDES)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = {"params": randomized_params(init["params"], 5)}
    images = np.random.default_rng(6).standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(images)))
    for pm in (swinv2.swinv2_tiny_test_descriptor(**OVERRIDES),
               registry.build_backbone({"type": "swinv2_tiny_test", **OVERRIDES})):
        assert (pm.cfg.output_dim, pm.cfg.img_size, pm.cfg.window_size) == (32, 64, 8)
        load_swinv2_descriptor(pm, params)
        with torch.inference_mode():
            got = pm(torch.from_numpy(images)).numpy()
        assert got.shape == (3, 32)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert swinv2.swinv2_tiny_test_descriptor().cfg == swinv2.SWINV2_TINY_TEST


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gem_pool_and_l2_normalize_take_axis(axis):
    x = np.random.default_rng(axis + 3).random((3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(layers.gem_pool(torch.from_numpy(x), axis=axis).numpy(),
                               np.asarray(jlayers.gem_pool(jnp.asarray(x), axis=axis)),
                               rtol=1e-6)
    np.testing.assert_allclose(layers.l2_normalize(torch.from_numpy(x), axis=axis).numpy(),
                               np.asarray(jlayers.l2_normalize(jnp.asarray(x), axis=axis)),
                               rtol=1e-6)


def test_fsd_entry_points_take_device_frames():
    """The device maps from the frames, from a device copy of them
    (`device_frames`) or with `use_device_maps`: the same cut decisions as
    JAX's entry points, and the same frames out of `image_process`."""
    vids = bench.synth_videos(8, 6, 128, 128)  # test_torch_fsd.py's corpus
    edited = 0
    for frames in vids:
        stack = np.stack(frames)
        want = jfsd.image_process_boxes(frames, device_frames=jnp.asarray(stack))
        assert want == jfsd.image_process_boxes(frames, use_device_maps=True)
        got = fsd.image_process_boxes(frames, device_frames=torch.from_numpy(stack), device="cpu")
        assert got == want
        assert fsd.image_process_boxes(frames, use_device_maps=True, device="cpu") == want
        changed, out = fsd.image_process(frames, device="cpu",
                                         device_frames=torch.from_numpy(stack))
        j_changed, j_out = jfsd.image_process(frames, device_frames=jnp.asarray(stack))
        assert changed == j_changed == want[0] and len(out) == len(j_out)
        assert all(np.array_equal(a, b) for a, b in zip(out, j_out))
        edited += changed
    assert edited >= 1  # the letterboxed video is cut
