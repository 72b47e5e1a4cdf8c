"""Two faults of the port's trainers against the JAX package's, on the CPU.

A BatchNorm member: the JAX contrastive step applies the model in train
mode with no mutable `batch_stats` collection, so flax refuses it at the
first trace; the port's `make_train_step` (and so `descriptor_cli` at
start-up) refuses it before any step runs. JAX's BYOL step applies the
backbone in inference mode, and its optimizer and EMA move the
`batch_stats` leaves of the online dict like any weight; the port's BYOL
step does the same (one step on `efficientnet_tiny_test`, held leaf by
leaf, running statistics included).

Entropy weight 1.0: three FGM + EMA steps of the tiny ViT in float32 leave
a few elements over `PARAM_WORST`, each with a first-step gradient about
1e-6 of the step's largest, just above `ROUNDING_GRAD`, where the two
packages' float32 gradients differ by tens of percent around the float64
value and Adam's m / (sqrt(v) + 1e-6) carries that into the step. Run in
float64 on both sides (every float32 cast of both packages lifted for the
run: `float64_everywhere`), the same three steps agree within the unchanged bars
of `test_torch_train.py`, so the float32 gap is rounding."""

import contextlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_train as base
from test_torch_byol import J_CFG, P_CFG
from vsc22_tpu.models import efficientnet as jeff
from vsc22_tpu.train import byol as jbyol
from vsc22_tpu.train import contrastive as jc
from vsc22_tpu_torch.models import efficientnet
from vsc22_tpu_torch.train import byol
from vsc22_tpu_torch.train import contrastive as tc
from vsc22_tpu_torch.train.contrastive import AdamW
from vsc22_tpu_torch.utils import jax_params

BYOL_TOL = 1e-4  # test_torch_byol.TOL: f32, absolute
TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                    "tiny_smoke.py")


def _images(n=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def test_batch_norm_member_is_refused_by_both_steps():
    a, b = _images(seed=1), _images(seed=2)
    jm = jeff.efficientnet_tiny_test()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(a))
    cfg = jc.ContrastiveConfig(learning_rate=1e-3, total_steps=4)
    tx = jc.make_optimizer(cfg)
    state = jc.TrainState(step=jnp.zeros((), jnp.int32), params=variables,
                          opt_state=tx.init(variables), ema_params=None)
    with pytest.raises(Exception, match="batch_stats.*immutable") as jerr:
        jc.make_train_step(jm, tx, cfg)(state, {"img_a": a, "img_b": b}, jax.random.PRNGKey(1))
    assert type(jerr.value).__name__ == "ModifyScopeVariableError"

    pm = efficientnet.efficientnet_tiny_test()
    pcfg = tc.ContrastiveConfig(learning_rate=1e-3, total_steps=4)
    pstate, ptx = tc.create_train_state(pm, pcfg)
    before = {n: t.clone() for n, t in pm.named_buffers()}
    with pytest.raises(ValueError, match="BatchNorm.*stem_bn"):
        tc.make_train_step(pm, ptx, pcfg)
    assert all(torch.equal(t, before[n]) for n, t in pm.named_buffers())


def test_descriptor_cli_refuses_a_batch_norm_member(tmp_path):
    pytest.importorskip("cv2")
    from vsc22_tpu_torch.data.store import FrameStore
    from vsc22_tpu_torch.pipelines.preprocess import encode_jpegs
    from vsc22_tpu_torch.train import descriptor_cli

    rng = np.random.default_rng(0)
    store = str(tmp_path / "f.rec")
    FrameStore.build(store, [(f"R{i:06d}", encode_jpegs(rng.integers(0, 255, (2, 32, 32, 3),
                                                                     np.uint8)))
                             for i in range(2)])
    with pytest.raises(ValueError, match="BatchNorm"):
        descriptor_cli.main(["--config", TINY, "--store", store, "--work_dir",
                             str(tmp_path / "run"), "--batch_size", "2", "--num_workers", "1",
                             "--epochs", "1", "--device", "cpu",
                             "model.type=efficientnet_tiny_test", "img_width=32"])
    assert not (tmp_path / "run" / "checkpoints").exists()


def test_byol_step_on_a_batch_norm_member_matches_jax():
    """One BYOL step on `efficientnet_tiny_test` (hidden 32, projection 8):
    the loss, and the online and target leaves after it, the BatchNorm
    running statistics among them (moved by Adam and the EMA in both)."""
    a, b = _images(4, seed=3), _images(4, seed=4)
    model = jeff.efficientnet_tiny_test()
    heads = jbyol.ByolHeads(J_CFG)
    emb = model.apply(model.init(jax.random.PRNGKey(0), jnp.asarray(a)), jnp.asarray(a))
    online, _ = jbyol.init_byol(lambda k: model.init(k, jnp.asarray(a)), heads,
                                jax.random.PRNGKey(1), emb)
    online = jax.device_get(online)
    target = jax.tree_util.tree_map(np.array, online)
    tx = optax.adam(1e-3)
    step = jbyol.make_byol_step(lambda p, x: model.apply(p, x), heads, tx, J_CFG)
    j_online, j_target, _, j_loss = jax.device_get(step(online, target, tx.init(online), a, b))

    net = byol.ByolNet(efficientnet.efficientnet_tiny_test(),
                       byol.ByolHeads(emb.shape[1], P_CFG))
    jax_params.load_byol(net, online)
    ptx = AdamW(lambda count: 1e-3, eps=1e-8)
    net, tgt, state = byol.init_byol(net.backbone, net.heads, ptx)
    state, loss = byol.make_byol_step(net, tgt, ptx, P_CFG)(state, torch.from_numpy(a),
                                                           torch.from_numpy(b))
    assert abs(float(loss) - float(j_loss)) < 1e-5
    for port_net, tree in ((net, j_online), (tgt, j_target)):
        moved = 0
        for key, t, layout in jax_params.byol_entries(port_net):
            want = jax_params._TO_PORT[layout](np.asarray(jax_params._leaf(tree, key)))
            np.testing.assert_allclose(t.detach().numpy(), want, atol=BYOL_TOL, rtol=0,
                                       err_msg="/".join(key))
            if key[1] == "batch_stats":
                start = np.asarray(jax_params._leaf(online, key))
                moved += int(np.abs(want - start).max() > 1e-6)
        assert moved > 0  # the running statistics are trained leaves


class _Float64(types.ModuleType):
    """A module's `jnp` or `torch` whose `float32` is float64."""

    def __init__(self, module, f64):
        super().__init__(module.__name__)
        self._module = module
        self.float32 = f64

    def __getattr__(self, name):
        return getattr(self._module, name)


@contextlib.contextmanager
def float64_everywhere():
    """Both packages in float64 while it is entered: x64 on, every module
    of `vsc22_tpu` and `vsc22_tpu_torch` reads `jnp.float32` /
    `torch.float32` as float64, and `Tensor.float()` keeps a float64
    tensor as it is."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for name, module in list(sys.modules.items()):
            if module is None or not name.startswith(("vsc22_tpu.", "vsc22_tpu_torch.")):
                continue
            for attr, real, f64 in (("jnp", jnp, jnp.float64), ("torch", torch, torch.float64)):
                if getattr(module, attr, None) is real:
                    mp.setattr(module, attr, _Float64(real, f64))
        to_f32 = torch.Tensor.float
        mp.setattr(torch.Tensor, "float", lambda self, *a, **k: (
            self if self.dtype == torch.float64 else to_f32(self, *a, **k)))
        yield


@pytest.mark.parametrize("kind", ["vit", "vit_plain"])
def test_three_fgm_ema_steps_at_entropy_weight_one_in_float64(kind):
    """`test_three_fgm_ema_steps_match_jax` at entropy weight 1.0, both
    sides in float64: the float32 gap (`vit`: block1/mlp/fc1_kernel, 1.0e-5
    over PARAM_WORST; `vit_plain`: patch_embed/kernel, 9.8e-5) is gone
    under the same GRAD_TOL, LOSS_TOL, PARAM_* and ROUNDING_GRAD."""
    with float64_everywhere():
        base.check_three_fgm_ema_steps(kind, entropy_weight=1.0, dtype=np.float64)
