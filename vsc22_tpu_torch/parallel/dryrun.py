"""A multi-rank dry run: one sharded train step, the sharded search and the
sharded extractor, each held against its one-rank result.

Counterpart of `__graft_entry__.dryrun_multichip` (`__graft_entry__.py:
54-171`). JAX provisions n virtual CPU devices in one process; here
`launcher.launch_local` spawns n ranks that form a gloo (`device="cpu"`)
or NCCL (`device="cuda"`: one card per rank, by LOCAL_RANK) world through
a file store, and lay a (n/2, 2) mesh when n >= 4 is even, else a data
mesh. Each rank runs:

- one full step of the real trainer on `VIT_TINY_TEST` (a global batch of
  at least 8 pairs dividing by the data axis; InfoNCE + entropy, EMA,
  AdamW with warm-up);
- the sharded search against the one-device searcher (1024 x 64 unit
  refs, 37 queries, row top-10 and a global top-200);
- the sharded extractor against the unsharded one (11 frames, chunk 8).

Usage: python -m vsc22_tpu_torch.parallel.dryrun [N] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from vsc22_tpu_torch.parallel.distributed import initialize
from vsc22_tpu_torch.parallel.launcher import launch_local
from vsc22_tpu_torch.parallel.mesh import batch_sharding, create_mesh


def _check(cond: bool, what: str) -> None:
    """Raise where a sharded result differs from its one-rank counterpart."""
    if not cond:
        raise AssertionError(what)


def _seeded_vit(device, seed: int):
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.models.vit import vit_tiny_test_descriptor

    model = vit_tiny_test_descriptor(device=device)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _dryrun_step(mesh, device) -> dict:
    from vsc22_tpu_torch.train.contrastive import (
        ContrastiveConfig,
        create_train_state,
        make_train_step,
    )

    model = _seeded_vit(device, 0)
    cfg = ContrastiveConfig(total_steps=10, entropy_weight=1.0)
    dp = mesh.shape["data"]
    batch_size = max(2, -(-8 // dp)) * dp  # >= 8 and divisible by the data axis
    rng = np.random.default_rng(0)
    local = batch_sharding(mesh)
    batch = {k: torch.from_numpy(local(rng.standard_normal((batch_size, 64, 64, 3),
                                                           np.float32))).to(device)
             for k in ("img_a", "img_b")}
    state, tx = create_train_state(model, cfg, mesh=mesh)
    step = make_train_step(model, tx, cfg, mesh=mesh)
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    loss = float(metrics["loss"])
    _check(bool(np.isfinite(loss)), f"non-finite loss in dryrun: {loss}")
    _check(state.step == 1, f"step counter {state.step}")
    whole = state.whole()
    digest = float(sum(t.double().abs().sum() for t in whole.params.values()))
    return {"loss": loss, "global_batch": batch_size, "params_digest": digest}


def _dryrun_search(mesh, device) -> dict:
    from vsc22_tpu_torch.retrieval.search import SimilaritySearcher

    rng = np.random.default_rng(0)
    refs = rng.standard_normal((1024, 64)).astype(np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    queries = rng.standard_normal((37, 64)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    sharded = SimilaritySearcher(refs, device=device, mesh=mesh)
    local = SimilaritySearcher(refs, device=device)
    s_sh, i_sh = sharded.row_topk(queries, 10)
    s_lo, i_lo = local.row_topk(queries, 10)
    _check(np.allclose(s_sh, s_lo, rtol=0, atol=1e-5), "sharded row_topk scores")
    _check(np.array_equal(i_sh, i_lo), "sharded row_topk indices")
    q_sh, r_sh, sc_sh = sharded.global_topk(queries, 200)
    q_lo, r_lo, sc_lo = local.global_topk(queries, 200)
    _check(np.allclose(sc_sh, sc_lo, rtol=0, atol=1e-5), "sharded global_topk scores")
    _check(set(zip(q_sh.tolist(), r_sh.tolist())) == set(zip(q_lo.tolist(), r_lo.tolist())),
           "sharded global_topk pairs")
    return {"row_topk": i_sh.shape, "global_topk": len(sc_sh)}


def _dryrun_extractor(mesh, device) -> dict:
    from vsc22_tpu_torch.pipelines.query_extract import DescriptorExtractor

    model = _seeded_vit(device, 1)
    frames = [(np.random.default_rng(i).random((72, 96, 3)) * 255).astype(np.uint8)
              for i in range(11)]
    ext_sh = DescriptorExtractor(model, size=64, preset="vit", chunk=8, device=device, mesh=mesh)
    ext_lo = DescriptorExtractor(model, size=64, preset="vit", chunk=8, device=device)
    got, want = ext_sh.extract(frames), ext_lo.extract(frames)
    _check(bool(np.allclose(got, want, rtol=0, atol=1e-4)), "sharded extractor features")
    return {"features": got.shape, "chunk": ext_sh.chunk}


def mesh_shape(n: int) -> tuple:
    """(n/2, 2) for an even n >= 4, else (n, 1)."""
    return (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)


def _rank(index: int, count: int, store_path: str, device: str) -> dict:
    os.environ["LOCAL_RANK"] = str(index)
    initialize(world_size=count, rank=index, store=dist.FileStore(store_path, count),
               device=device)
    try:
        mesh = create_mesh(mesh_shape(count))
        return {"mesh": mesh.shape, "train": _dryrun_step(mesh, device),
                "search": _dryrun_search(mesh, device),
                "extractor": _dryrun_extractor(mesh, device)}
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cpu", timeout: float = 600.0) -> list:
    """Spawn `n` ranks, run the three checks on each and return their
    results in rank order; raises where a rank fails or the ranks'
    losses or parameters disagree."""
    with tempfile.TemporaryDirectory() as tmp:
        results = launch_local(_rank, n, args=(os.path.join(tmp, "store"), device),
                               timeout=timeout)
    first = results[0]["train"]
    for r in results[1:]:
        _check(r["train"] == first, f"the ranks' steps disagree: {r['train']} vs {first}")
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("n", type=int, nargs="?", default=4, help="ranks")
    parser.add_argument("--device", default="cpu", help="cpu (gloo) or cuda (NCCL)")
    args = parser.parse_args()
    for res in dryrun_multichip(args.n, args.device):
        print(res)
