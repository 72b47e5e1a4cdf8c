"""The port's checkpoints and snapshots (`vsc22_tpu_torch/train/checkpoint.py`):
a resumed run bit for bit as an unbroken one, retention, and snapshots
across the two packages: a port EMA snapshot read by the JAX package's
`load_params_snapshot` gives the port's descriptors, a JAX snapshot loads
into the port, and a CNN snapshot goes both ways through
`save_cnn_snapshot`/`load_cnn_snapshot`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc22_tpu.models import hrnet as jhrnet
from vsc22_tpu.models import swinv2 as jsw
from vsc22_tpu.models import vit as jvit
from vsc22_tpu.train import checkpoint as jckpt
from vsc22_tpu.train import contrastive as jc
from vsc22_tpu_torch.models import hrnet, swinv2, vit
from vsc22_tpu_torch.models.layers import reset_parameters
from vsc22_tpu_torch.train import checkpoint as tckpt
from vsc22_tpu_torch.train import contrastive as tc
from vsc22_tpu_torch.utils import jax_params
from test_torch_swinv2 import randomized_params

DESC_TOL = 1e-5  # f32 descriptors, JAX against the port on the CPU


def tiny_swin(seed=0):
    model = swinv2.SwinTransformerV2(
        dataclasses.replace(swinv2.SWINV2_TINY_TEST, drop_path_rate=0.3))
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
             for k in ("img_a", "img_b")} for _ in range(n)]


CFG = tc.ContrastiveConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
                           fgm_epsilon=0.1, ema_decay=0.9, weight_decay=0.01)


def run(model, state, tx, data, gen):
    step = tc.make_train_step(model, tx, CFG)
    losses = []
    for batch in data:
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    return state, losses


def test_resumed_run_is_bit_for_bit_the_unbroken_run(tmp_path):
    """Four steps with drop-path masks from the generator, against two
    steps, a checkpoint, a fresh model and state restored from it (with the
    generator), and two more."""
    data = batches(4)
    model = tiny_swin()
    state, tx = tc.create_train_state(model, CFG)
    whole, losses = run(model, state, tx, data, torch.Generator().manual_seed(7))

    model = tiny_swin()
    state, tx = tc.create_train_state(model, CFG)
    gen = torch.Generator().manual_seed(7)
    state, first = run(model, state, tx, data[:2], gen)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    mgr.save(state.step, state, gen)
    for _ in range(3):  # advance the live generator, as a crashed run would have
        torch.rand(5, generator=gen)

    fresh = tiny_swin(seed=1)
    template, tx = tc.create_train_state(fresh, CFG)
    gen = torch.Generator()
    assert mgr.latest_step() == 2
    state = mgr.restore(template, generator=gen)
    tc.load_masters(fresh, state.params)
    state, rest = run(fresh, state, tx, data[2:], gen)
    assert first + rest == losses
    assert state.step == whole.step == 4 and state.opt_state.count == whole.opt_state.count
    for a, b in ((state.params, whole.params), (state.ema_params, whole.ema_params)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    whole.opt_state.mu + whole.opt_state.nu):
        assert torch.equal(a, b)


def test_retention_keeps_the_newest(tmp_path):
    model = tiny_swin()
    state, _ = tc.create_train_state(model, CFG)
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for s in (1, 5, 9):
        mgr.save(s, state)
    assert mgr.all_steps() == [5, 9] and mgr.latest_step() == 9
    assert mgr.restore(state, step=5).step == state.step


def _jax_and_port(kind):
    if kind == "vit":
        return (jvit.vit_tiny_test_descriptor(), vit.vit_tiny_test_descriptor(),
                jvit.VIT_TINY_TEST.img_size)
    return (jsw.swinv2_tiny_test_descriptor(), swinv2.swinv2_tiny_test_descriptor(),
            jsw.SWINV2_TINY_TEST.img_size)


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_port_ema_snapshot_loads_into_jax(tmp_path, kind):
    """A port run's EMA (after a step, so it differs from the params),
    written with `save_ema_snapshot`, read by the JAX package's
    `load_params_snapshot` into its model: the same descriptors as the
    port model holding that EMA."""
    jm, pm, size = _jax_and_port(kind)
    reset_parameters(pm, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    cfg = dataclasses.replace(CFG, fgm_epsilon=None)
    state, tx = tc.create_train_state(pm, cfg)
    step = tc.make_train_step(pm, tx, cfg)
    batch = {"img_a": torch.from_numpy(imgs), "img_b": torch.from_numpy(imgs[::-1].copy())}
    for _ in range(2):
        state, _ = step(state, batch, torch.Generator().manual_seed(0))
    path = str(tmp_path / "ema.npz")
    tckpt.save_ema_snapshot(path, state, pm)
    tc.load_masters(pm, state.ema_params)
    with torch.no_grad():
        want = pm(torch.from_numpy(imgs)).numpy()
    template = jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs))
    params = jckpt.load_params_snapshot(path, template)
    got = np.asarray(jm.apply(params, jnp.asarray(imgs)))
    np.testing.assert_allclose(got, want, atol=DESC_TOL, rtol=DESC_TOL)


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_jax_snapshot_loads_into_the_port(tmp_path, kind):
    """The JAX package's `save_ema_snapshot` of a train state read by the
    port's `load_params_snapshot`: the same descriptors, and masters a
    train state can start from."""
    jm, pm, size = _jax_and_port(kind)
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jstate, _ = jc.create_train_state(jm, jax.random.PRNGKey(0), {"img_a": jnp.asarray(imgs)},
                                      jc.ContrastiveConfig())
    ema = randomized_params(jstate.ema_params, seed=6)
    jstate = jstate.replace(ema_params=ema)
    path = str(tmp_path / "jax_ema.npz")
    jckpt.save_ema_snapshot(path, jstate)
    masters = tckpt.load_params_snapshot(path, pm)
    want = np.asarray(jm.apply(ema, jnp.asarray(imgs)))
    with torch.no_grad():
        got = pm(torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=DESC_TOL, rtol=DESC_TOL)
    state, _ = tc.create_train_state(pm, CFG, params=masters)
    assert all(torch.equal(state.params[n], p) for n, p in pm.named_parameters())


def test_cnn_snapshot_both_ways(tmp_path):
    """The tiny SAM's params and BN statistics: the port's
    `save_cnn_snapshot` read by the JAX `load_cnn_snapshot` holds the
    JAX layouts of the port's values, and the JAX file written back loads
    into a fresh port model equal to the first."""
    pm = hrnet.sam_hrnet_tiny_test()
    reset_parameters(pm, torch.Generator().manual_seed(2))
    with torch.no_grad():
        for m in pm.modules():
            if hasattr(m, "mean") and hasattr(m, "var"):
                m.mean.normal_(generator=torch.Generator().manual_seed(3))
                m.var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "sam.npz")
    tckpt.save_cnn_snapshot(path, pm)
    jm = jhrnet.sam_hrnet_tiny_test()
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                              np.zeros((1, 32, 32, 3), np.float32), train=False))
    variables = jckpt.load_cnn_snapshot(path, template)
    flat = jax_params.jax_flat_params(jax_params.sam_hrnet_entries(pm))
    for key, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(jax_params._leaf(variables, key.split("/"))),
                                      arr)
    back = str(tmp_path / "sam_jax.npz")
    jckpt.save_cnn_snapshot(back, variables["params"], variables["batch_stats"])
    fresh = tckpt.load_cnn_snapshot(back, hrnet.sam_hrnet_tiny_test())
    for (n, a), b in zip(pm.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n


def test_clip_snapshot_both_ways(tmp_path):
    """A JAX CLIP snapshot (the `--clip` file of `query_cli`: the JAX
    package's `save_ema_snapshot` of `clip_vit_l14().init(...)`, here the
    tiny config) loads into the port's CLIPVisual with the same CLS
    features, and the port's snapshot of it loads back into the JAX model
    with every array unchanged."""
    import types

    from vsc22_tpu.models import clip as jclip
    from vsc22_tpu_torch.models import clip as pclip

    jm = jclip.clip_tiny_test()
    imgs = np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs)))
    variables = {"params": randomized_params(variables["params"], seed=8)}
    path = str(tmp_path / "clip.params.npz")
    jckpt.save_ema_snapshot(path, types.SimpleNamespace(params=variables, ema_params=None))
    pm = pclip.clip_tiny_test()
    masters = tckpt.load_params_snapshot(path, pm)
    want = np.asarray(jm.apply(variables, jnp.asarray(imgs)))[:, 0]
    with torch.no_grad():
        got = pm(torch.from_numpy(imgs))[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=DESC_TOL, rtol=DESC_TOL)
    back = str(tmp_path / "port_clip.npz")
    tckpt.save_ema_snapshot(back, types.SimpleNamespace(params=masters, ema_params=None), pm)
    loaded = jckpt.load_params_snapshot(back, variables)
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
