"""The port's sharded trainers at 2 gloo ranks (a data mesh) and 4 ((2, 2):
data x model) on the CPU: three FGM + EMA + Barlow steps of the tiny ViT
against the JAX step on a mesh of the same shape (dropout and drop-path
1e-9: both sides take the plain path, as `test_torch_train.py` sets it)
and against the port's one-rank step on the global batch with drop-path
0.3 (the masks drawn for the global batch); the model axis's blocks
through a checkpoint rank 0 writes whole; the VSM step against JAX's at 2
ranks; the descriptor CLI at 2 ranks (the ranks agree, only rank 0
writes, a resumed run equals an unbroken one).

Each world is spawned once (`torch_parallel_workers.train_rank`, no JAX);
the tolerances are `test_torch_train.py`'s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as workers
from test_torch_swinv2 import randomized_params
from test_torch_train import GRAD_TOL, LOSS_TOL, _flat, assert_params_close, recording_tx
from vsc22_tpu.models import vit as jvit
from vsc22_tpu.models import vsm as jvsm
from vsc22_tpu.parallel import mesh as jmesh
from vsc22_tpu.train import contrastive as jc
from vsc22_tpu.train import vid_score as jvs
from vsc22_tpu_torch.models import vsm
from vsc22_tpu_torch.parallel.launcher import launch_local
from vsc22_tpu_torch.train import contrastive as tc
from vsc22_tpu_torch.utils import jax_params

cv2 = pytest.importorskip("cv2")

from test_torch_descriptor_cli import FLAGS  # noqa: E402
from vsc22_tpu_torch.data.store import FrameStore  # noqa: E402
from vsc22_tpu_torch.pipelines.preprocess import encode_jpegs  # noqa: E402

SHAPES = {2: (2, 1), 4: (2, 2)}
CFG = dict(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10, fgm_epsilon=0.1, ema_decay=0.9,
           barlow_weight=0.5)
VSM_CFG = dict(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10, ema_decay=0.9)


def jax_mesh(shape) -> Mesh:
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def jvit_model(rate):
    return jvit.VitDescriptor(cfg=dataclasses.replace(jvit.VIT_TINY_TEST, dropout=rate,
                                                      drop_path=rate), head_dim=64, out_dim=16)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(2)
    batch = {k: rng.standard_normal((4, 64, 64, 3)).astype(np.float32) for k in ("img_a", "img_b")}
    jm = jvit_model(1e-9)
    variables = randomized_params(jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["img_a"])),
                                  seed=3)
    pm = workers.vit_model(1e-9)
    jax_params.load_entries(jax_params.vit_entries(pm), variables)
    weights = {k: v.numpy().copy() for k, v in pm.state_dict().items()}
    cases = {"plain": dict(rate=1e-9, weights=weights, batch=batch, cfg=CFG),
             "drop_path": dict(rate=0.3, weights=weights, batch=batch, cfg=CFG)}

    jv = jvsm.VideoScoreModel(cfg=dataclasses.replace(jvsm.VSM_TINY_TEST, dropout=0.0))
    feats = rng.standard_normal((4, 8, 16)).astype(np.float32)
    feats[1, 5:] = 0.0
    labels = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    vvars = randomized_params(jv.init(jax.random.PRNGKey(0), jnp.asarray(feats)), seed=8)
    pv = vsm.VideoScoreModel(dataclasses.replace(vsm.VSM_TINY_TEST, dropout=0.0))
    jax_params.load_video_score_model(pv, vvars)
    vsm_case = dict(weights={k: v.numpy().copy() for k, v in pv.state_dict().items()},
                    batch={"feats": feats, "label": labels}, cfg=VSM_CFG)

    root = tmp_path_factory.mktemp("parallel_train")
    store = str(root / "f.rec")
    srng = np.random.default_rng(0)
    FrameStore.build(store, [(v, encode_jpegs(srng.integers(0, 255, (5, 64, 64, 3), np.uint8)))
                             for v in ("Q000000", "R000001", "R000002", "R000003")])
    flags = [f if f != "4" else "2" for f in FLAGS]  # --batch_size 2 a rank: 4 a step
    cli = dict(flags=flags, store=store, resumed=str(root / "resumed"),
               unbroken=str(root / "unbroken"))

    results = {}
    for n, shape in SHAPES.items():
        d = root / f"world{n}"
        d.mkdir()
        got = launch_local(workers.train_rank, n,
                           args=(str(d / "store"), shape, cases, str(d),
                                 vsm_case if n == 2 else None, cli if n == 2 else None),
                           timeout=400.0)
        results[n] = got
    return dict(batch=batch, variables=variables, weights=weights, vsm=(jv, vvars, vsm_case),
                results=results)


def jax_steps(setup, shape, steps=3):
    """The JAX sharded step on a `shape` mesh, params placed as its
    `create_train_state(mesh=)` places them: the losses, params and EMA."""
    mesh = jax_mesh(shape)
    cfg = jc.ContrastiveConfig(**CFG)
    params = jax.tree.map(jax.device_put, setup["variables"],
                          jmesh.param_shardings(mesh, setup["variables"]))
    tx = jc.make_optimizer(cfg)
    state = jc.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                          ema_params=jax.tree.map(jnp.copy, params))
    step = jc.make_train_step(jvit_model(1e-9), tx, cfg, mesh=mesh)
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    losses = []
    for i in range(steps):
        state, metrics = step(state, batch, jax.random.fold_in(jax.random.PRNGKey(5), i))
        losses.append({k: float(v) for k, v in metrics.items()})
    return losses, _flat(state.params), _flat(state.ema_params)


def one_rank(setup, rate, steps=3):
    """The port's one-rank step on the global batch."""
    pm = workers.vit_model(rate)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in setup["weights"].items()})
    cfg = tc.ContrastiveConfig(**CFG)
    state, tx = tc.create_train_state(pm, cfg)
    step = tc.make_train_step(pm, tx, cfg)
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    _, grads = step.gradients(batch, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch, gen)
        losses.append({k: float(v) for k, v in metrics.items()})
    names = [n for n, _ in pm.named_parameters()]
    return (losses, dict(zip(names, (g.numpy() for g in grads))),
            workers.numpy_dict(state.params), workers.numpy_dict(state.ema_params), pm)


def port_as_jax(pm, tree: dict) -> dict:
    """A port {name: array} in the JAX package's flat keys and layouts."""
    by_id = {id(p): torch.from_numpy(tree[n]) for n, p in pm.named_parameters()}
    return jax_params.jax_flat_params(jax_params.vit_entries(pm), by_id)


def rank0(setup, n):
    got = setup["results"][n]
    for r in got[1:]:  # every rank ends with the same whole state
        for case in r["contrastive"]:
            for key in ("params", "ema", "grads", "model"):
                a, b = r["contrastive"][case][key], got[0]["contrastive"][case][key]
                assert all(np.array_equal(a[k], b[k]) for k in b), (case, key)
    return got[0]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_jax_on_the_same_mesh(setup, n):
    res = rank0(setup, n)["contrastive"]["plain"]
    losses, params, ema = jax_steps(setup, SHAPES[n])
    for got, want in zip(res["losses"], losses):
        for k in ("loss", "ici_loss", "entropy_loss", "barlow_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL, err_msg=k)
    pm = workers.vit_model(1e-9)
    ref_grads = _flat_grads(setup, pm)
    assert_params_close(port_as_jax(pm, res["params"]), params, ref_grads)
    assert_params_close(port_as_jax(pm, res["ema"]), ema, ref_grads)


def _flat_grads(setup, pm) -> dict:
    """The port one-rank first-step gradients in JAX keys, for
    `assert_params_close`'s rounding-residue rule."""
    _, grads, _, _, _ = one_rank(setup, 1e-9, steps=0)
    return port_as_jax(pm, grads)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["plain", "drop_path"])
def test_sharded_step_equals_the_one_rank_step(setup, n, case):
    """Drop-path 0.3 draws the same masks for the global batch at any world
    size: the sharded gradients, losses, params and EMA are the one-rank
    step's on the global batch but for the sum order; the model holds the
    gathered masters."""
    res = rank0(setup, n)["contrastive"][case]
    rate = 0.3 if case == "drop_path" else 1e-9
    losses, grads, params, ema, pm = one_rank(setup, rate)
    for got, want in zip(res["losses"], losses):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_TOL)
    for name, want in grads.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(res["grads"][name] - want).max() <= GRAD_TOL * scale, name
    ref = port_as_jax(pm, grads)
    assert_params_close(port_as_jax(pm, res["params"]), port_as_jax(pm, params), ref)
    assert_params_close(port_as_jax(pm, res["ema"]), port_as_jax(pm, ema), ref)
    for name, value in res["params"].items():
        np.testing.assert_array_equal(res["model"][name], value)


def test_model_axis_keeps_blocks_and_round_trips_a_checkpoint(setup):
    """At (2, 2) each rank holds half of every qkv, proj, fc1 and fc2
    weight (and whole biases and norms); rank 0's whole checkpoint reads
    back into every rank's blocks bit for bit."""
    got = setup["results"][4]
    shapes = got[0]["contrastive"]["plain"]["shard_shapes"]
    assert shapes["backbone.blocks.0.attn.qkv.weight"] == (48, 32)
    assert shapes["backbone.blocks.0.attn.proj.weight"] == (32, 16)
    assert shapes["backbone.blocks.0.mlp.fc2.weight"] == (32, 64)
    assert shapes["backbone.blocks.0.attn.qkv.bias"] == (96,)
    assert all(r["round_trip"] for r in got)
    assert all(r["round_trip"] for r in setup["results"][2])


def test_sharded_vid_score_step_matches_jax(setup):
    jv, vvars, case = setup["vsm"]
    res = setup["results"][2][0]["vsm"]
    for r in setup["results"][2][1:]:
        assert r["vsm"]["losses"] == res["losses"]
    cfg = jvs.VidScoreConfig(**VSM_CFG)
    mesh = jax_mesh((2, 1))
    jstate, jtx = jvs.create_vid_score_state(jv, jax.random.PRNGKey(0),
                                             jnp.asarray(case["batch"]["feats"]), cfg)
    jstate = jstate.replace(params=vvars, opt_state=jtx.init(vvars),
                            ema_params=jax.tree.map(jnp.copy, vvars))
    step = jvs.make_vid_score_train_step(jv, jtx, cfg, mesh=mesh)
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    rec = recording_tx()
    first = jc.TrainState(step=jnp.zeros((), jnp.int32), params=vvars,
                          opt_state=rec.init(vvars), ema_params=None)
    jgrads = jvs.make_vid_score_train_step(jv, rec, cfg, mesh=mesh)(
        first, batch, jax.random.PRNGKey(0))[0].opt_state
    for i, got in enumerate(res["losses"]):
        jstate, m = step(jstate, batch, jax.random.PRNGKey(i))
        np.testing.assert_allclose(got, float(m["loss"]), rtol=LOSS_TOL)
    pv = vsm.VideoScoreModel(dataclasses.replace(vsm.VSM_TINY_TEST, dropout=0.0))
    entries = jax_params.vsm_entries(pv)
    for tree, want in ((res["params"], jstate.params), (res["ema"], jstate.ema_params)):
        by_id = {id(p): torch.from_numpy(tree[n]) for n, p in pv.named_parameters()}
        assert_params_close(jax_params.jax_flat_params(entries, by_id), _flat(want),
                            _flat(jgrads))


def test_descriptor_cli_at_two_ranks(setup):
    """`--batch_size 2` a rank over 20 frames: 5 steps an epoch. Both ranks
    end with the same masters; only rank 0 wrote checkpoints and EMA
    snapshots; a run cut after its first epoch's checkpoint (each rank's
    loader failing in the second) and resumed equals two unbroken epochs
    bit for bit, every rank's dropout generator restored."""
    got = [r["cli"] for r in setup["results"][2]]
    assert [c["steps"] for c in got] == [(10, 10), (10, 10)]
    assert got[1]["writes"] == []
    assert got[0]["writes"] == [("ckpt", 5), ("ema", "epoch_0_ema.npz"), ("ckpt", 10),
                                ("ema", "epoch_1_ema.npz"), ("ckpt", 5),
                                ("ema", "epoch_0_ema.npz"), ("ckpt", 10),
                                ("ema", "epoch_1_ema.npz")]
    assert [c["cut_steps"] for c in got] == [[5], [5]]
    for key in ("resumed", "unbroken", "resumed_ema"):
        for name, value in got[0][key].items():
            np.testing.assert_array_equal(got[1][key][name], value)
    for name, value in got[0]["resumed"].items():
        np.testing.assert_array_equal(value, got[0]["unbroken"][name], err_msg=name)
