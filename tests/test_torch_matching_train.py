"""The port's matching-track trainer (`vsc22_tpu_torch/train/matching.py`)
against the JAX package's (`vsc22_tpu/train/matching.py`) on the CPU: the
host helpers (labels, augmentation, folds, and the fold trainers' batch
streams), BatchNorm's train mode against flax's, three classify steps of
MobileNetV3-Small (dropout 0, 32x32, batch 4) and three refine steps of
the tiny SAM (32x32, batch 2) against `make_classify_train_step` and
`make_refine_train_step` from the same variables, the head's dropout, and
the SAM refusing train mode on its packed branch.

Tolerances (float32 on both sides, other summation orders):
- gradients of the first step: per leaf within GRAD_TOL of max |g_JAX|
  (a leaf that is rounding residue on the JAX side must be residue on the
  port's: `assert_grads_close`);
- the first step's loss LOSS_TOL relative, its BN running buffers BN_ATOL
  absolute (observed: 6.7e-7 and 8.3e-7);
- the later steps' losses LATER_LOSS_TOL relative and buffers
  LATER_BN_ATOL absolute, from what was observed (classify: 4.1e-5 and
  1.5e-5; refine: 5.5e-7 and 7.2e-7). Adam's eps is 1e-8 here, so its
  first update moves every element whose gradient is rounding noise (the
  `project` BN biases, a few kernel elements at 1e-8 of the largest |g|)
  by a full lr of either sign: after one step the two sides' params are
  2 lr = 2e-4 apart there, and the second forward pass feels it;
- params after three steps: `tests/test_torch_train.py`'s rule
  (`assert_params_close` with its ROUNDING_GRAD exclusion) at the
  trainers' lr 1e-4 (observed: worst 3.8e-6, 9 of 1.4M elements over
  PARAM_ATOL);
- BN's train-mode output BN_OUT_ATOL absolute (values of order 1) and its
  input, scale and bias gradients GRAD_TOL of max |g|;
- labels, augmentations, folds and batches: identical.

The classify case runs at 64x64, where MobileNetV3's last stage is 2x2:
at 32x32 it is 1x1, every late BN normalises over the batch's 4 values,
and flax's fast variance E[x^2] - E[x]^2 cancels so far that the JAX
package's own jitted and eager train-mode logits differ by 5.9e-4 (and
its f32 from its f64 by 5.3e-4, on logits of 24). At lr 1e-3 the refine
case's params after three steps are 1.1e-3 apart (JAX against itself
eager: 2.9e-7). Both: `scripts/torch_matching_train_probes.py`.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_matching_models import jax_variables
from test_torch_train import ROUNDING_GRAD, _flat, assert_params_close
from vsc22_tpu.models import hrnet as jhrnet
from vsc22_tpu.models import mobilenetv3 as jmnv3
from vsc22_tpu.train import matching as jm
from vsc22_tpu_torch.models import hrnet, layers, mobilenetv3
from vsc22_tpu_torch.train import matching as tm
from vsc22_tpu_torch.utils import jax_params

GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
BN_ATOL = 1e-6
LATER_LOSS_TOL = 1e-4
LATER_BN_ATOL = 5e-5
BN_OUT_ATOL = 1e-5
LR = 1e-4


def test_labels_augment_and_folds_match_jax():
    for res, gts in (((32, 32), [(5, 15, 5, 15)]), ((40, 30), [(2.5, 30.2, 1.0, 25.7)]),
                     ((16, 16), [(3, 3, 5, 5), (0, 20, 4, 12)]), ((24, 24), [])):
        np.testing.assert_array_equal(tm.soft_band_label(res, gts), jm.soft_band_label(res, gts))
    sim = np.random.default_rng(0).standard_normal((40, 50)).astype(np.float32)
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(30):
        np.testing.assert_array_equal(tm.augment_sim(sim, r1), jm.augment_sim(sim, r2))
    for n in (1, 7, 20, 101):
        ids = [f"Q{i:06d}" for i in range(n)] * 2
        assert tm.split_folds(ids, seed=2023) == jm.split_folds(ids, seed=2023)
        assert tm.split_folds(ids, seed=5) == jm.split_folds(ids, seed=5)


def _record(module, monkeypatch, maker):
    """Patch `module`'s state, step and (port) model makers so that its fold
    trainer only records the batches it would train on."""
    seen = []

    def step(state, images, labels, _key):
        seen.append((np.asarray(images), np.asarray(labels)))
        return state, 0.0

    monkeypatch.setattr(module, maker, lambda model, tx: step)
    monkeypatch.setattr(module, "create_cnn_state", lambda *a: None)
    if module is tm:
        monkeypatch.setattr(tm, "_fresh_model", lambda *a: None)
    return seen


def test_fold_trainers_draw_jax_batches(monkeypatch):
    """Both packages' fold trainers, on the same data and seed, train their
    two models on identical batches (order, last-batch padding, random
    transposes, augmentations, labels) and return the same fold."""
    rng = np.random.default_rng(3)
    features = [rng.random((20 + i % 5, 18)).astype(np.float32) for i in range(22)]
    infos = [[f"Q{i // 2:06d}", f"R{i:06d}", i % 3 == 0] for i in range(22)]
    meta = []
    for i in range(9):
        r = rng.standard_normal((24, 8)).astype(np.float32)
        q = rng.standard_normal((20, 8)).astype(np.float32)
        meta.append((f"Q{i:06d}", f"R{i:06d}", q, r, [(2, 12, 3, 13)] if i % 2 else []))
    for fn, maker, args, kw in (
            ("train_classify_model", "make_classify_train_step", (features, infos),
             dict(num_epochs=2, batch=4, resolution=16)),
            ("train_refine_model", "make_refine_train_step", (meta,),
             dict(num_epochs=2, batch=4, resolution=16))):
        want = _record(jm, monkeypatch, maker)
        got = _record(tm, monkeypatch, maker)
        _, fold_j = getattr(jm, fn)(lambda: None, *args, **kw)
        _, fold_t = getattr(tm, fn)(None, *args, device="cpu", **kw)
        assert fold_t == fold_j
        assert len(got) == len(want) > 0
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_batch_norm_train_mode_matches_flax():
    """Output, gradients (input, scale, bias) and the updated running
    buffers of one train-mode BN over [B, H, W, C] against flax's."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 6, 8)) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    mean = rng.normal(0, 0.1, 8).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}

    def f(x, params):
        return bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                        mutable=["batch_stats"])

    y, stats = f(jnp.asarray(x), variables["params"])
    _, vjp = jax.vjp(lambda x, p: f(x, p)[0], jnp.asarray(x), variables["params"])
    gx, gp = vjp(jnp.asarray(cot))

    port = layers.BatchNorm(8)
    with torch.no_grad():
        for t, v in ((port.weight, scale), (port.bias, bias), (port.mean, mean), (port.var, var)):
            t.copy_(torch.from_numpy(v))
    tx = torch.from_numpy(x).requires_grad_()
    out = port(tx, train=True)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=0, atol=BN_OUT_ATOL)
    for got, want in ((tx.grad, gx), (port.weight.grad, gp["scale"]), (port.bias.grad, gp["bias"])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= GRAD_TOL * np.abs(want).max()
    for got, key in ((port.mean, "mean"), (port.var, "var")):
        np.testing.assert_allclose(got.numpy(), np.asarray(stats["batch_stats"][key]),
                                   rtol=0, atol=BN_ATOL)
    # Inference mode reads the buffers and leaves them.
    before = port.var.clone()
    port(tx.detach())
    assert torch.equal(port.var, before)


def assert_grads_close(grads, jgrads, model, entries) -> None:
    """Each port gradient leaf within GRAD_TOL of its JAX leaf's max |g|;
    a leaf whose JAX gradient is rounding residue (max |g| at most
    ROUNDING_GRAD of the step's largest |g| over all leaves) is held to
    being residue on the port's side too. Such leaves are exactly zero in
    exact arithmetic: the bias of a BN whose output reaches the next
    train-mode BN only through a 1x1 convolution (MobileNetV3's `project`
    BNs) adds a per-channel constant that the next BN's batch mean takes
    out again."""
    by_id = {id(p): g.numpy() for p, g in zip(model.parameters(), grads)}
    pairs = []
    for key, t, layout in entries:
        if key[0] == "params":
            want = jax_params._TO_PORT[layout](np.asarray(jax_params._leaf(jgrads, key[1:])))
            pairs.append(("/".join(key), by_id[id(t)], want))
    top = max(float(np.abs(w).max()) for _, _, w in pairs)
    for name, got, want in pairs:
        scale = float(np.abs(want).max())
        if scale <= ROUNDING_GRAD * top:
            assert float(np.abs(got).max()) <= ROUNDING_GRAD * top, (name, scale, top)
        else:
            err = float(np.abs(got - want).max())
            assert err <= GRAD_TOL * scale, (name, err / scale)


def recording(tx):
    """`tx` with the last gradients kept beside its state (state[0])."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    return optax.chain(keep, tx)


def _cases(kind):
    """(JAX model, port model, entries, images, labels, JAX step maker, port
    step maker)."""
    rng = np.random.default_rng(5)
    if kind == "classify":
        x = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
        labels = np.array([0, 1, 1, 0], np.int32)
        jmodel = jmnv3.MobileNetV3Small(dropout=0.0)
        variables = jax_variables(jmodel, x, seed=6, last="classifier")
        pm = mobilenetv3.MobileNetV3Small(dropout=0.0)
        jax_params.load_mobilenetv3(pm, variables)
        return (jmodel, pm, jax_params.mobilenetv3_entries(pm), variables, x, labels,
                jm.make_classify_train_step, tm.make_classify_train_step)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    labels = np.stack([jm.soft_band_label((32, 32), [(4, 28, 2, 26)]),
                       jm.soft_band_label((32, 32), [(0, 12, 10, 22)])])
    jmodel = jhrnet.sam_hrnet_tiny_test()
    variables = jax_variables(jmodel, x, seed=7, last="fuse2")
    pm = hrnet.sam_hrnet_tiny_test()
    jax_params.load_sam_hrnet(pm, variables)
    return (jmodel, pm, jax_params.sam_hrnet_entries(pm), variables, x, labels,
            jm.make_refine_train_step, tm.make_refine_train_step)


@pytest.mark.parametrize("kind", ["classify", "refine"])
def test_three_train_steps_match_jax(kind):
    """Three steps from the same variables and batch: the first step's
    gradients leaf by leaf, each step's loss and BN buffers, the params
    after the third."""
    jmodel, pm, entries, variables, x, labels, jmake, tmake = _cases(kind)
    jtx = recording(jm.make_cnn_optimizer(LR))
    jstate = jm.CNNTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=jtx.init(variables["params"]))
    jstep = jmake(jmodel, jtx)
    tx = tm.make_cnn_optimizer(LR)
    state = tm.create_cnn_state(pm, tx)
    step = tmake(pm, tx)
    images, tlabels = torch.from_numpy(x), torch.from_numpy(labels)

    gen = torch.Generator().manual_seed(0)
    stats_entries = [e for e in entries if e[0][0] == "batch_stats"]
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(labels),
                              jax.random.PRNGKey(i))
        loss, grads = step.gradients(images, tlabels, gen)
        state = step.update(state, grads)
        np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_TOL if i == 0 else LATER_LOSS_TOL,
                                   err_msg=f"step {i}")
        if i == 0:
            jgrads = jstate.opt_state[0]
            assert_grads_close(grads, jgrads, pm, entries)
        for key, t, _ in stats_entries:
            want = np.asarray(jax_params._leaf(jstate.batch_stats, key[1:]))
            np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                       atol=BN_ATOL if i == 0 else LATER_BN_ATOL,
                                       err_msg=f"step {i} {'/'.join(key)}")
    assert state.step == 3 and jstate.step == 3
    got = jax_params.jax_flat_params(
        [e for e in entries if e[0][0] == "params"],
        {id(p): state.params[n] for n, p in pm.named_parameters()})
    want = {f"params/{k}": v for k, v in _flat(jstate.params).items()}
    assert got.keys() == want.keys()
    assert_params_close(got, want, {f"params/{k}": v for k, v in _flat(jgrads).items()})


def test_classifier_dropout_rate_scaling_and_train_mode():
    """The head's dropout: values 0 or x / 0.8, about 80% kept, the same
    mask for one DropRng key; train mode without a DropRng raises; eval
    mode is deterministic and leaves the BN buffers."""
    x = torch.ones(200, 1024)
    rng = layers.DropRng(torch.Generator().manual_seed(0))
    y = layers.dropout(x, 0.2, rng, "head")
    assert set(y.unique().tolist()) == {0.0, float(torch.tensor(1.0) / 0.8)}
    assert abs(float((y > 0).float().mean()) - 0.8) < 0.01
    assert torch.equal(layers.dropout(x, 0.2, rng, "head"), y)
    model = mobilenetv3.MobileNetV3Small()
    layers.reset_parameters(model, torch.Generator().manual_seed(1))
    images = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (4, 32, 32, 3))
                              .astype(np.float32))
    with pytest.raises(ValueError, match="DropRng"):
        model(images, train=True)
    a = model(images, train=True, rng=layers.DropRng(torch.Generator().manual_seed(2)))
    b = model(images, train=True, rng=layers.DropRng(torch.Generator().manual_seed(3)))
    assert not torch.equal(a, b)
    before = {n: t.clone() for n, t in model.named_buffers()}
    assert torch.equal(model(images), model(images))
    assert all(torch.equal(t, before[n]) for n, t in model.named_buffers())


def test_sam_refuses_train_mode_on_its_packed_branch():
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="s2d_branch0"):
        hrnet.sam_hrnet_tiny_test(s2d=True)(x, train=True)
    assert hrnet.sam_hrnet_tiny_test()(x, train=True).shape == (1, 16, 16, 2)
