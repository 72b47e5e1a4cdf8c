"""The port's BYOL recipe (`vsc22_tpu_torch/train/byol.py`) against the JAX
package's (`vsc22_tpu/train/byol.py`) on the CPU: the regression loss,
the heads, and one step on `mae_tiny_test` (hidden 32, projection 8),
`optax.adam(1e-3)` against `AdamW(const 1e-3, eps 1e-8)`: the loss, the
online and target weights and the optimizer's moments, with both of
BYOL's online and target dicts carried across by `utils/jax_params`.
Tolerance: f32, 1e-4 absolute (the moments relative to their scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from test_torch_swinv2 import randomized_params
from vsc22_tpu.models import mae as jmae
from vsc22_tpu.train import byol as jbyol
from vsc22_tpu_torch.models import mae
from vsc22_tpu_torch.train import byol
from vsc22_tpu_torch.train.contrastive import AdamW
from vsc22_tpu_torch.utils import jax_params

TOL = 1e-4
J_CFG = jbyol.ByolConfig(projection_size=8, hidden_size=32)
P_CFG = byol.ByolConfig(projection_size=8, hidden_size=32)


def views(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((4, 32, 32, 3)).astype(np.float32) for _ in range(2)]


def jax_online(seed=0) -> dict:
    """JAX `init_byol`'s online dict on `mae_tiny_test`, made lively
    (`randomized_params`)."""
    model = jmae.mae_tiny_test()
    heads = jbyol.ByolHeads(J_CFG)
    online, _ = jbyol.init_byol(
        lambda k: model.init(k, jnp.zeros((1, 32, 32, 3))), heads, jax.random.PRNGKey(seed),
        jnp.zeros((1, 16)))
    return {k: {"params": randomized_params(v["params"], seed + i)}
            for i, (k, v) in enumerate(jax.device_get(online).items())}


def port_nets(online_tree):
    heads = byol.ByolHeads(16, P_CFG)
    backbone = mae.mae_tiny_test()
    jax_params.load_byol(byol.ByolNet(backbone, heads), online_tree)
    return backbone, heads


def leaves_close(net, tensors, tree, tol=TOL, rel=False, start=None):
    """Each port tensor (by `net`'s parameter order) against the JAX leaf
    its `byol_entries` key names. Given the `start` tree (the weights
    before the step), the key third of each QKV bias is held apart: adding
    a constant to every key shifts a row of logits alike, so its gradient
    is 0 in exact arithmetic and rounding noise (~1e-9) in each package,
    and Adam's first step moves it by lr * noise / (|noise| + eps), up to
    lr either way whatever the noise: both packages' key thirds must lie
    within lr (1e-3) of the start, the rest within `tol`."""
    index = {id(p): i for i, (_, p) in enumerate(net.named_parameters())}
    for key, t, layout in jax_params.byol_entries(net):
        want = jax_params._TO_PORT[layout](np.asarray(jax_params._leaf(tree, key)))
        got = tensors[index[id(t)]].detach().numpy()
        if start is not None and key[-3:] == ("attn", "qkv", "bias"):
            c = got.shape[0] // 3
            before = np.asarray(jax_params._leaf(start, key))[c:2 * c]
            for side in (got, want):
                assert np.abs(side[c:2 * c] - before).max() <= 1e-3 * (1 + 1e-5), key
            got, want = np.delete(got, np.s_[c:2 * c]), np.delete(want, np.s_[c:2 * c])
        scale = max(float(np.abs(want).max()), 1e-30) if rel else 1.0
        np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0,
                                   err_msg="/".join(key))


def test_regression_loss_and_heads_match_jax():
    rng = np.random.default_rng(1)
    pred, target = (rng.standard_normal((5, 8)).astype(np.float32) for _ in range(2))
    want = float(jbyol._regression_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = float(byol.regression_loss(torch.from_numpy(pred), torch.from_numpy(target)))
    assert abs(got - want) < 1e-6
    emb = rng.standard_normal((5, 16)).astype(np.float32)
    jheads = jbyol.ByolHeads(J_CFG)
    v = {"params": randomized_params(jheads.init(jax.random.PRNGKey(0), emb)["params"], 2)}
    heads = byol.ByolHeads(16, P_CFG)
    jax_params.load_entries(jax_params.byol_heads_entries(heads), v)
    x = torch.from_numpy(emb)
    with torch.no_grad():
        np.testing.assert_allclose(heads(x).numpy(), np.asarray(jheads.apply(v, emb)),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(
            heads.project(x).numpy(),
            np.asarray(jheads.apply(v, emb, method=jbyol.ByolHeads.project)), atol=TOL, rtol=0)


def test_one_byol_step_matches_jax():
    a, b = views()
    online = jax_online()
    target = jax.tree_util.tree_map(np.array, online)
    model = jmae.mae_tiny_test()
    tx = optax.adam(1e-3)
    step = jbyol.make_byol_step(lambda p, x: model.apply(p, x), jbyol.ByolHeads(J_CFG), tx,
                                J_CFG)
    j_online, j_target, j_opt, j_loss = jax.device_get(
        step(online, target, tx.init(online), a, b))

    ptx = AdamW(lambda count: 1e-3, eps=1e-8)
    net, tgt, state = byol.init_byol(*port_nets(online), ptx)
    p_step = byol.make_byol_step(net, tgt, ptx, P_CFG)
    state, loss = p_step(state, torch.from_numpy(a), torch.from_numpy(b))

    assert abs(float(loss) - float(j_loss)) < 1e-5
    assert state.step == 1 and state.opt_state.count == 1
    leaves_close(net, list(state.online.values()), j_online, start=online)
    leaves_close(net, list(state.target.values()), j_target)
    adam = j_opt[0]
    leaves_close(net, state.opt_state.mu, adam.mu, rel=True)
    leaves_close(net, state.opt_state.nu, adam.nu, rel=True)
    # The networks hold the masters (f32 here: exactly).
    for (_, p), m in zip(net.named_parameters(), state.online.values()):
        assert torch.equal(p.detach(), m)
    for (_, p), m in zip(tgt.named_parameters(), state.target.values()):
        assert torch.equal(p.detach(), m)


def test_target_moves_by_one_minus_decay_of_the_gap():
    """After a step, target' = target + (1 - decay) (online' - target) in
    f32, and no gradient reaches the target network."""
    a, b = views(3)
    ptx = AdamW(lambda count: 1e-3, eps=1e-8)
    net, tgt, state = byol.init_byol(*port_nets(jax_online(4)), ptx)
    before = {k: v.clone() for k, v in state.target.items()}
    step = byol.make_byol_step(net, tgt, ptx, P_CFG)
    for _ in range(2):
        old = {k: v.clone() for k, v in state.target.items()}
        state, _ = step(state, torch.from_numpy(a), torch.from_numpy(b))
        for k, new in state.target.items():
            want = old[k] + 0.01 * (state.online[k] - old[k])
            torch.testing.assert_close(new, want, atol=1e-7, rtol=1e-6)
    assert any(not torch.equal(before[k], v) for k, v in state.target.items())
    assert all(p.grad is None for p in tgt.parameters())
