"""CPU probes behind the tolerances of tests/test_torch_matching_train.py
and tests/test_torch_matching_train_cli.py: the port's matching trainers
against the JAX package's.

    JAX_PLATFORMS=cpu python scripts/torch_matching_train_probes.py

1. conditioning: MobileNetV3-Small's train-mode logits (batch statistics,
   flax's fast variance) on the random variables of
   `tests/test_torch_matching_models.jax_variables`, at 32x32 and 64x64,
   batch 4: the JAX package jitted, eager and in float64, and the port,
   each against the jitted JAX logits (max |difference|, max |logit|).
2. lr: three refine steps of the tiny SAM from the same variables and
   batch (the test's case) at lr 1e-3 and 1e-4: the port's params and the
   JAX package's after them (worst |difference|, share over 1e-6), and at
   1e-3 the JAX package jitted against itself eager.
3. cli_ap: the training CLI (`--tiny`, the planted corpus of the CLI
   test) at seeds 2023, 1 and 2: the out-of-fold classify AP of the JAX
   CLI, of the port's CLI, and of the port's CLI from the JAX models'
   initial weights.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def conditioning() -> None:
    import jax
    import torch

    from test_torch_matching_models import jax_variables
    from vsc22_tpu.models import mobilenetv3 as jmnv3
    from vsc22_tpu_torch.models import mobilenetv3
    from vsc22_tpu_torch.utils import jax_params

    for size in (32, 64):
        x = np.random.default_rng(5).uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
        jm = jmnv3.MobileNetV3Small(dropout=0.0)
        v = jax_variables(jm, x, seed=6, last="classifier")
        apply = lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0]
        jit = np.asarray(jax.jit(apply)(v, x))
        eager = np.asarray(apply(v, x))
        jax.config.update("jax_enable_x64", True)
        try:
            f64 = np.asarray(apply(jax.tree.map(lambda a: np.asarray(a, np.float64), v),
                                   x.astype(np.float64)))
        finally:
            jax.config.update("jax_enable_x64", False)
        pm = mobilenetv3.MobileNetV3Small(dropout=0.0)
        jax_params.load_mobilenetv3(pm, v)
        with torch.no_grad():
            port = pm(torch.from_numpy(x), train=True).numpy()
        print(f"conditioning {size}x{size} batch 4, train-mode logits (max |logit| "
              f"{np.abs(jit).max():.3f}) against JAX jitted: JAX eager "
              f"{np.abs(eager - jit).max():.3e}, JAX float64 {np.abs(f64 - jit).max():.3e}, "
              f"port {np.abs(port - jit).max():.3e}", flush=True)


def lr() -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from test_torch_matching_train import _cases
    from test_torch_train import _flat
    from vsc22_tpu.train import matching as jm
    from vsc22_tpu_torch.train import matching as tm
    from vsc22_tpu_torch.utils import jax_params

    def jax_run(rate, eager=False):
        jmodel, _, _, variables, x, labels, jmake, _ = _cases("refine")
        tx = jm.make_cnn_optimizer(rate)
        state = jm.CNNTrainState(variables["params"], variables["batch_stats"],
                                 tx.init(variables["params"]))
        step = jmake(jmodel, tx)
        for i in range(3):
            if eager:
                with jax.disable_jit():
                    state, _ = step(state, jnp.asarray(x), jnp.asarray(labels),
                                    jax.random.PRNGKey(i))
            else:
                state, _ = step(state, jnp.asarray(x), jnp.asarray(labels), jax.random.PRNGKey(i))
        return {f"params/{k}": v for k, v in _flat(state.params).items()}

    def compare(name, got, want):
        err = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        print(f"lr {name}: worst {err.max():.3e}, {(err > 1e-6).mean():.1%} of {err.size} "
              "elements over 1e-6", flush=True)

    for rate in (1e-3, 1e-4):
        _, pm, entries, _, x, labels, _, tmake = _cases("refine")
        tx = tm.make_cnn_optimizer(rate)
        state, step = tm.create_cnn_state(pm, tx), tmake(pm, tx)
        for _ in range(3):
            state, _ = step(state, torch.from_numpy(x), torch.from_numpy(labels), None)
        got = jax_params.jax_flat_params(
            [e for e in entries if e[0][0] == "params"],
            {id(p): state.params[n] for n, p in pm.named_parameters()})
        compare(f"{rate:g}, port against JAX jitted", got, jax_run(rate))
    compare("0.001, JAX eager against JAX jitted", jax_run(1e-3, eager=True), jax_run(1e-3))


def cli_ap() -> None:
    import jax
    import jax.numpy as jnp
    import pytest

    from test_torch_matching_train_cli import FlaxTinyCNN, planted_corpus
    from vsc22_tpu.models import hrnet as jhrnet
    from vsc22_tpu.train import matching_cli as jcli
    from vsc22_tpu_torch.train import matching as tm
    from vsc22_tpu_torch.train import matching_cli as tcli
    from vsc22_tpu_torch.utils import jax_params

    def jax_init(factory, seed, device):
        model = factory()
        zeros = jnp.zeros((1, 32, 32, 3))
        if isinstance(model, tcli.TinyCNN):
            v = FlaxTinyCNN().init(jax.random.PRNGKey(seed), zeros)
            jax_params.load_entries(model.entries(), jax.tree.map(np.asarray, v))
        else:
            v = jhrnet.sam_hrnet_tiny_test().init(jax.random.PRNGKey(seed), zeros)
            jax_params.load_sam_hrnet(model, jax.tree.map(np.asarray, v))
        return model.to(device)

    with tempfile.TemporaryDirectory() as root:
        paths, _ = planted_corpus(Path(root))
        for seed in ("2023", "1", "2"):
            argv = ["--query_features", paths["q"], "--ref_features", paths["r"],
                    "--candidates", paths["cands"], "--gt", paths["gt"], "--tiny",
                    "--cls_epochs", "8", "--refine_epochs", "4", "--cls_resolution", "32",
                    "--refine_resolution", "32", "--cls_threshold", "0.0", "--lr", "3e-3",
                    "--seed", seed]
            aps = [jcli.main(argv + ["--work_dir", os.path.join(root, f"j{seed}")])]
            aps.append(tcli.main(argv + ["--work_dir", os.path.join(root, f"p{seed}"),
                                         "--device", "cpu"]))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tm, "_fresh_model", jax_init)
                aps.append(tcli.main(argv + ["--work_dir", os.path.join(root, f"i{seed}"),
                                             "--device", "cpu"]))
            print(f"cli_ap seed {seed}: JAX {aps[0]['classify_ap']:.4f}, port "
                  f"{aps[1]['classify_ap']:.4f}, port from JAX's init "
                  f"{aps[2]['classify_ap']:.4f}", flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    conditioning()
    lr()
    cli_ap()
