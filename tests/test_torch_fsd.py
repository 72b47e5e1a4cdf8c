"""Port FSD against the JAX FSD: device maps and level-0 profiles to f16
rounding, and identical cut decisions on the bench's synthetic corpus
(plain, letterboxed and 2-stack videos)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from vsc22_tpu.data import fsd as jfsd
from vsc22_tpu_torch.data import fsd

V, N, H, W = 8, 6, 128, 128


@pytest.fixture(scope="module")
def maps():
    vids = bench.synth_videos(V, N, H, W)
    stack = np.stack(vids)
    jm, jp = jfsd._batch_maps_profiles(
        jnp.asarray(stack), jnp.asarray(jfsd.sample_edge_frames(N))
    )
    pm, pp, dims = fsd.batch_maps_profiles_dispatch(torch.from_numpy(stack))
    assert dims == (V, H, W)
    assert pm.dtype == torch.float16 and tuple(pm.shape) == (2 * V, H, W)
    assert tuple(pp.shape) == (V, 3 * W + 3 * H + 1)
    return (vids, np.asarray(jm).astype(np.float32), np.asarray(jp),
            pm.float().numpy(), pp.numpy())


def test_edge_maps_identical(maps):
    _, jm, _, pm, _ = maps
    # Integer Sobel arithmetic and boolean floods: exact on both sides.
    np.testing.assert_array_equal(pm[V:], jm[V:])


def test_variance_maps_within_one_f16_ulp(maps):
    _, jm, _, pm, _ = maps
    # f32 variance summed in another order, then rounded to f16 (ulp 2^-10).
    np.testing.assert_allclose(pm[:V], jm[:V], rtol=2**-10, atol=0)


def test_profiles_match(maps):
    _, _, jp, _, pp = maps
    # Column/row means of the f16 variance maps (values up to ~1e3):
    # relative error of the one-ulp flips above.
    np.testing.assert_allclose(pp, jp, rtol=2e-4, atol=1e-5)


def test_cut_decisions_identical(maps):
    vids, jm, jp, pm, pp = maps
    jprofs = jfsd.unpack_profiles(jp, V, H, W)
    pprofs = fsd.unpack_profiles(pp, V, H, W)
    edited = 0
    for i in range(V):
        assert fsd.level0_boxes_from_profiles(pprofs[i], H, W, N) == \
            jfsd.level0_boxes_from_profiles(jprofs[i], H, W, N)
        want = jfsd.image_process_boxes(vids[i], precomputed_maps=(jm[i], jm[V + i]))
        got = fsd.image_process_boxes(vids[i], (pm[i], pm[V + i]))
        assert got == want
        edited += got[0]
    assert edited >= 1  # the letterboxed video is cut


def test_host_cut_logic_matches_on_hand_maps():
    """remove_edges + split on maps with a letterbox and a stacked gap."""
    rng = np.random.default_rng(0)
    var = rng.uniform(200, 900, (300, 200)).astype(np.float32)
    var[:40] = 0.0
    var[140:160] = 0.0
    canny = rng.uniform(0, 0.1, (300, 200)).astype(np.float32)
    canny[40] = 0.9
    for n in (3, 12):
        assert fsd.clean_boxes(var, canny, n, (0, 300, 0, 200)) == \
            jfsd.clean_boxes(var, canny, n, (0, 300, 0, 200))


def test_sample_edge_frames_and_quantile():
    for n in (1, 19, 20, 32, 77):
        assert fsd.sample_edge_frames(n) == jfsd.sample_edge_frames(n)
    a = np.random.default_rng(1).uniform(0, 1, (3, 1001)).astype(np.float32)
    np.testing.assert_array_equal(
        fsd._quantile_linear(torch.from_numpy(a), 0.95).numpy(),
        np.asarray(jnp.quantile(jnp.asarray(a), 0.95, axis=1)),
    )


def test_device_batch_maps_are_the_per_video_maps_in_f16(maps):
    """`variance_and_edges_device_batch`: each video's
    `variance_and_edges_device` maps rounded to f16, bit for bit, and the
    JAX batch twin's maps as the fixture holds them."""
    vids, jm, _, _, _ = maps
    var, edges = fsd.variance_and_edges_device_batch(torch.from_numpy(np.stack(vids)))
    assert var.shape == edges.shape == (V, H, W) and var.dtype == np.float32
    for i, vid in enumerate(vids):
        v1, e1 = fsd.variance_and_edges_device(torch.from_numpy(vid), "cpu")
        np.testing.assert_array_equal(var[i], v1.astype(np.float16).astype(np.float32))
        np.testing.assert_array_equal(edges[i], e1.astype(np.float16).astype(np.float32))
    jvar, jedges = jfsd.variance_and_edges_device_batch(np.stack(vids))
    np.testing.assert_array_equal(edges, jedges)
    np.testing.assert_allclose(var, jvar, rtol=2**-10, atol=0)


def test_batch_maps_profiles_device_is_dispatch_plus_fetch(maps):
    _, _, _, pm, pp = maps
    maps16, profs = fsd.batch_maps_profiles_device(torch.from_numpy(np.stack(maps[0])))
    np.testing.assert_array_equal(maps16.float().numpy(), pm)
    want = fsd.unpack_profiles(pp, V, H, W)
    assert len(profs) == V
    for g, w in zip(profs, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
