"""The port's descriptor and video-score trainers against the JAX package's
(`vsc22_tpu/train/contrastive.py`, `vid_score.py`) on the CPU: the four
losses, the optimizer's updates at every count of its schedule and its
global-norm clip, three FGM + EMA train steps of the tiny ViT (on its
kernel path and on its plain dropout path) and the tiny SwinV2 from the
same params (loss, every gradient, the params and EMA after), remat
against plain, DropPath's rate, scaling and mask reuse, and the
video-score step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vsc22_tpu.models import swinv2 as jsw
from vsc22_tpu.models import vit as jvit
from vsc22_tpu.models import vsm as jvsm
from vsc22_tpu.train import contrastive as jc
from vsc22_tpu.train import vid_score as jvs
from vsc22_tpu_torch.models import swinv2, vit, vsm
from vsc22_tpu_torch.models.layers import DropPath, DropRng, reset_parameters
from vsc22_tpu_torch.train import contrastive as tc
from vsc22_tpu_torch.train import vid_score as tvs
from vsc22_tpu_torch.utils import jax_params
from test_torch_swinv2 import randomized_params

# Gradients: |port - JAX| <= GRAD_TOL * max |JAX| per leaf (f32, other
# summation orders). Loss: relative LOSS_TOL. Params and EMA after three
# steps at lr 1e-3: PARAM_ATOL absolute, for all but PARAM_MAX_SHARE of
# the elements, and every element within PARAM_WORST (observed: no element
# over PARAM_ATOL, the worst 5.4e-7, on each of the three models). An
# element whose first-step JAX gradient is at most ROUNDING_GRAD of the
# step's largest |g| over all leaves is left out: its gradient is zero but
# for rounding, and Adam's update m / (sqrt(v) + 1e-6) turns a rounding
# residue of either sign into a step of up to lr / (4 eps) = 250 times it,
# so its trajectory is rounding noise. That rule takes the ViT's k bias
# (the middle third of each qkv bias, which the softmax cancels: |g| <=
# 1.6e-8 of the max, while every q and v bias element is >= 7.5e-4 of it;
# 64 elements) and 19 SwinV2 elements.
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
PARAM_ATOL = 1e-6
PARAM_MAX_SHARE = 1e-3
PARAM_WORST = 1e-5
ROUNDING_GRAD = 1e-6


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_losses_match_jax(margin):
    rng = np.random.default_rng(0)
    a, b = unit_rows(rng, 12, 16), unit_rows(rng, 12, 16)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (tc.contrastive_loss(ta, tb, 0.05, margin), jc.contrastive_loss(a, b, 0.05, margin)),
        (tc.entropy_loss(ta @ tb.t(), 30.0), jc.entropy_loss(a @ b.T, 30.0)),
        (tc.product_entropy_loss(ta, tb), jc.product_entropy_loss(a, b)),
        (tc.barlow_twins_loss(ta, tb, 5e-3), jc.barlow_twins_loss(a, b, 5e-3)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("clip", [None, 0.5, 100.0], ids=["no_clip", "clipped", "unclipped"])
def test_optimizer_updates_match_optax_at_every_count(clip):
    """A few leaves through `total_steps + 2` updates of the port's AdamW
    and of `make_optimizer`'s chain on the same gradients: the params after
    each update agree, so the lr agrees at every count 0..total_steps
    (count 0: lr 0) and the clip acts where optax's does."""
    cfg = jc.ContrastiveConfig(learning_rate=1e-3, warmup_ratio=0.2, total_steps=20,
                               weight_decay=0.05, clip_grad_norm=clip)
    port_cfg = tc.ContrastiveConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jc.make_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    update = jax.jit(tx.update)
    port = tc.make_optimizer(port_cfg)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = port.init(tp)
    for count in range(cfg.total_steps + 2):
        grads = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in shapes]
        u, js = update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, u)
        port.apply([torch.from_numpy(g) for g in grads], ts, tp)
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8,
                                       err_msg=f"count {count}")
    assert port.schedule(0) == 0.0


def test_schedule_matches_join_schedules():
    cfg = tc.ContrastiveConfig(learning_rate=3e-4, warmup_ratio=0.1, total_steps=37)
    warmup = int(cfg.warmup_ratio * cfg.total_steps)
    want = optax.join_schedules(
        [optax.linear_schedule(0.0, cfg.learning_rate, max(warmup, 1)),
         optax.linear_schedule(cfg.learning_rate, 0.0, max(cfg.total_steps - warmup, 1))],
        [max(warmup, 1)])
    got = tc.make_schedule(cfg)
    for count in range(cfg.total_steps + 1):
        assert got(count) == float(want(count)), count


def recording_tx():
    """An optax transformation whose state is the last gradients and whose
    updates are zero: the JAX step's gradients, exposed."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (jax.tree.map(jnp.zeros_like, updates), updates))


def _models(kind):
    """(JAX model, port model, port entry table, image size)."""
    if kind.startswith("vit"):
        rate = 1e-9 if kind == "vit_plain" else 0.0
        cfg = dataclasses.replace(jvit.VIT_TINY_TEST, dropout=rate, drop_path=rate)
        jm = jvit.VitDescriptor(cfg=cfg, head_dim=64, out_dim=16)
        pm = vit.VitDescriptor(dataclasses.replace(vit.VIT_TINY_TEST, dropout=rate,
                                                   drop_path=rate), head_dim=64, out_dim=16)
        return jm, pm, jax_params.vit_entries(pm), cfg.img_size
    jm = jsw.swinv2_tiny_test_descriptor()
    pm = swinv2.swinv2_tiny_test_descriptor()
    return jm, pm, jax_params.swinv2_entries(pm), jsw.SWINV2_TINY_TEST.img_size


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", ["vit", "vit_plain", "swin"])
def test_three_fgm_ema_steps_match_jax(kind):
    """`make_train_step` with FGM and EMA, three steps from the same
    randomized params: the gradients of the first step leaf by leaf, the
    loss of each step, and the params and EMA after the third. "vit_plain"
    sets dropout and drop-path to 1e-9: both sides take the plain train
    path (every mask keeps, the scale rounds to 1)."""
    check_three_fgm_ema_steps(kind)


def three_fgm_ema_steps(kind, entropy_weight: float = 30.0, dtype=np.float32) -> dict:
    """Run `test_three_fgm_ema_steps_match_jax`'s steps at an entropy
    weight, with the params and images in `dtype` (float64 needs both
    packages' float32 casts lifted: `test_torch_train_faults.float64_everywhere`).
    Flat JAX-keyed trees, each as (port, JAX): `grads`, the first step's
    gradients; `params` and `ema` after the third step; and `losses`, the
    (port, JAX) loss of each step, and `steps`, the port state's count."""
    jm, pm, entries, size = _models(kind)
    rng = np.random.default_rng(2)
    imgs = {k: rng.standard_normal((3, size, size, 3)).astype(np.float32)
            for k in ("img_a", "img_b")}
    variables = randomized_params(jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs["img_a"])),
                                  seed=3)
    if dtype == np.float64:
        imgs = {k: v.astype(np.float64) for k, v in imgs.items()}
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        jm = jm.clone(dtype=jnp.float64)
        pm = pm.double()
        for m in pm.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
    jax_params.load_entries(entries, variables)
    cfg = jc.ContrastiveConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
                               fgm_epsilon=0.1, ema_decay=0.9, entropy_weight=entropy_weight)
    pcfg = tc.ContrastiveConfig(**dataclasses.asdict(cfg))
    batch = {k: jnp.asarray(v) for k, v in imgs.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in imgs.items()}
    key = jax.random.PRNGKey(5)

    # The first step's gradients.
    rec = recording_tx()
    jstate = jc.TrainState(step=jnp.zeros((), jnp.int32), params=variables,
                           opt_state=rec.init(variables), ema_params=None)
    jgrads = jc.make_train_step(jm, rec, cfg)(jstate, batch, key)[0].opt_state
    state, tx = tc.create_train_state(pm, pcfg)
    step = tc.make_train_step(pm, tx, pcfg)
    _, grads = step.gradients(tbatch, torch.Generator().manual_seed(0))
    out = {"grads": (jax_params.jax_flat_params(
        entries, {id(p): g for p, g in zip(pm.parameters(), grads)}), _flat(jgrads))}

    # Three steps.
    jtx = jc.make_optimizer(cfg)
    jstate = jc.TrainState(step=jnp.zeros((), jnp.int32), params=variables,
                           opt_state=jtx.init(variables),
                           ema_params=jax.tree.map(jnp.copy, variables))
    jstep = jc.make_train_step(jm, jtx, cfg)
    gen = torch.Generator().manual_seed(0)
    out["losses"] = []
    for i in range(3):
        jstate, jmetrics = jstep(jstate, batch, jax.random.fold_in(key, i))
        state, metrics = step(state, tbatch, gen)
        out["losses"].append((float(metrics["loss"]), float(jmetrics["loss"])))
    out["steps"] = state.step
    for name, got_tree, want_tree in (("params", state.params, jstate.params),
                                      ("ema", state.ema_params, jstate.ema_params)):
        tensors = {id(p): got_tree[n] for n, p in pm.named_parameters()}
        out[name] = (jax_params.jax_flat_params(entries, tensors), _flat(want_tree))
    return out


def check_three_fgm_ema_steps(kind, entropy_weight: float = 30.0, dtype=np.float32):
    """`three_fgm_ema_steps` held to the bars: every gradient leaf within
    GRAD_TOL of its largest |JAX| element, each loss within LOSS_TOL, the
    params and EMA by `assert_params_close`."""
    r = three_fgm_ema_steps(kind, entropy_weight, dtype)
    got, want = r["grads"]
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert np.abs(got[k] - want[k]).max() <= GRAD_TOL * scale, (k, scale)
    for i, (loss, jloss) in enumerate(r["losses"]):
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL, err_msg=f"step {i}")
    assert r["steps"] == 3
    for name in ("params", "ema"):
        got, jtree = r[name]
        assert got.keys() == jtree.keys()
        assert_params_close(got, jtree, want)


def assert_params_close(got: dict, want: dict, ref_grads: dict | None = None) -> None:
    """Flat param trees within PARAM_ATOL but for PARAM_MAX_SHARE of the
    elements, all within PARAM_WORST, leaving out the elements whose
    reference gradient (`ref_grads`, the same keys, where given) is
    rounding residue (ROUNDING_GRAD)."""
    top = max((float(np.abs(g).max()) for g in (ref_grads or {}).values()), default=0.0)
    over, total = 0, 0
    for k in want:
        err = np.abs(got[k] - want[k])
        if ref_grads is not None:
            err = err[np.abs(ref_grads[k]) > ROUNDING_GRAD * top]
        assert err.max(initial=0.0) <= PARAM_WORST, (k, float(err.max()))
        over += int((err > PARAM_ATOL).sum())
        total += err.size
    assert over <= PARAM_MAX_SHARE * total, (over, total)


def _grads_of(model, cfg, imgs, seed=0):
    state, tx = tc.create_train_state(model, cfg)
    step = tc.make_train_step(model, tx, cfg)
    return step.gradients(imgs, torch.Generator().manual_seed(seed))


def test_remat_equals_plain():
    """The ViT's whole-model remat (`cfg.remat`) and the SwinV2's per-block
    remat (with drop-path 0.3, so that the recomputed blocks must redraw
    nothing) give the plain run's loss and gradients."""
    rng = np.random.default_rng(4)
    cfg = tc.ContrastiveConfig(fgm_epsilon=0.1)
    for build, size in ((vit.vit_tiny_test_descriptor, 64), (None, 32)):
        imgs = {k: torch.from_numpy(rng.standard_normal((2, size, size, 3)).astype(np.float32))
                for k in ("img_a", "img_b")}
        if build is not None:
            plain, remat = build(), build()
            reset_parameters(plain, torch.Generator().manual_seed(0))
            remat_cfg = dataclasses.replace(cfg, remat=True)
        else:
            scfg = dataclasses.replace(swinv2.SWINV2_TINY_TEST, drop_path_rate=0.3)
            plain = swinv2.SwinTransformerV2(scfg)
            remat = swinv2.SwinTransformerV2(scfg, remat=True)
            remat_cfg = cfg
            reset_parameters(plain, torch.Generator().manual_seed(0))
        remat.load_state_dict(plain.state_dict())
        m1, g1 = _grads_of(plain, cfg, imgs)
        m2, g2 = _grads_of(remat, remat_cfg, imgs)
        assert float(m1["loss"]) == float(m2["loss"])
        for a, b in zip(g1, g2):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_drop_path_rate_scaling_and_reuse():
    layer = DropPath(0.25)
    x = torch.ones(40_000, 3, 2)
    rng = DropRng(torch.Generator().manual_seed(0))
    y = layer(x, rng)
    per_sample = y[:, 0, 0]
    assert bool((y == y[:, :1, :1]).all())  # one draw per sample
    values = set(per_sample.unique().tolist())
    assert values == {0.0, float(torch.tensor(1.0) / 0.75)}
    kept = float((per_sample > 0).float().mean())
    assert abs(kept - 0.75) < 0.01
    assert torch.equal(layer(x, rng), y)  # the same step's second pass: same masks
    assert not torch.equal(layer(x, DropRng(torch.Generator().manual_seed(0).manual_seed(1))), y)
    assert torch.equal(layer(x, None), x) and torch.equal(DropPath(0.0)(x, rng), x)


def test_fgm_pass_reuses_the_first_pass_masks():
    """With drop-path on, the FGM pass's masks are the clean pass's: a
    step's gradients equal the sum of two passes run by hand with one
    DropRng, and differ from passes with fresh masks."""
    scfg = dataclasses.replace(swinv2.SWINV2_TINY_TEST, drop_path_rate=0.5)
    model = swinv2.SwinTransformerV2(scfg)
    reset_parameters(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    imgs = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
    drop = DropRng(torch.Generator().manual_seed(0))
    first = model(imgs, train=True, rng=drop)
    assert torch.equal(model(imgs, train=True, rng=drop), first)
    other = model(imgs, train=True, rng=DropRng(torch.Generator().manual_seed(1)))
    assert not torch.equal(other, first)
    with pytest.raises(ValueError, match="DropRng"):
        model(imgs, train=True)


def test_vid_score_step_matches_jax():
    """Three steps of the VSM trainer (dropout 0, EMA on) from the same
    params: the loss of each step and the params after."""
    jcfg = dataclasses.replace(jvsm.VSM_TINY_TEST, dropout=0.0)
    jm = jvsm.VideoScoreModel(cfg=jcfg)
    pm = vsm.VideoScoreModel(dataclasses.replace(vsm.VSM_TINY_TEST, dropout=0.0))
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((4, 8, 16)).astype(np.float32)
    feats[1, 5:] = 0.0
    labels = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    variables = randomized_params(jm.init(jax.random.PRNGKey(0), jnp.asarray(feats)), seed=8)
    jax_params.load_video_score_model(pm, variables)
    cfg = jvs.VidScoreConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
                             ema_decay=0.9)
    pcfg = tvs.VidScoreConfig(**dataclasses.asdict(cfg))
    jstate, jtx = jvs.create_vid_score_state(jm, jax.random.PRNGKey(0), jnp.asarray(feats), cfg)
    jstate = jstate.replace(params=variables, opt_state=jtx.init(variables),
                            ema_params=jax.tree.map(jnp.copy, variables))
    jstep = jvs.make_vid_score_train_step(jm, jtx, cfg)
    batch = {"feats": jnp.asarray(feats), "label": jnp.asarray(labels)}
    rec = recording_tx()
    first = jc.TrainState(step=jnp.zeros((), jnp.int32), params=variables,
                          opt_state=rec.init(variables), ema_params=None)
    jgrads = jvs.make_vid_score_train_step(jm, rec, cfg)(first, batch,
                                                         jax.random.PRNGKey(0))[0].opt_state
    state, tx = tvs.create_vid_score_state(pm, pcfg)
    step = tvs.make_vid_score_train_step(pm, tx, pcfg)
    tbatch = {"feats": torch.from_numpy(feats), "label": torch.from_numpy(labels)}
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        jstate, jm_ = jstep(jstate, batch, jax.random.PRNGKey(i))
        state, m = step(state, tbatch, gen)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=LOSS_TOL)
    entries = jax_params.vsm_entries(pm)
    for got_tree, want_tree in ((state.params, jstate.params),
                                (state.ema_params, jstate.ema_params)):
        got = jax_params.jax_flat_params(
            entries, {id(p): got_tree[n] for n, p in pm.named_parameters()})
        assert_params_close(got, _flat(want_tree), _flat(jgrads))
    ap, scores, lab = tvs.evaluate_ap(pm, [{"feats": feats, "label": labels}])
    assert scores.shape == (4,) and 0.0 <= ap <= 1.0
