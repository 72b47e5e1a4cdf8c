"""Rank functions for the port's multi-process tests (`test_torch_parallel*.py`).

Each function runs in a rank spawned by the port's `launch_local`, forms a
gloo world on the CPU through a file store, runs the port's sharded code
and returns numpy results to the parent, which holds them against the
JAX package and the port's one-rank results. This module imports neither
JAX nor the JAX package, so that a spawned rank starts quickly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from vsc22_tpu_torch.parallel.distributed import barrier, initialize
from vsc22_tpu_torch.parallel.mesh import batch_sharding, create_mesh


@contextlib.contextmanager
def gloo_world(index: int, count: int, store_path: str):
    """This rank in a `count`-rank gloo world met at `store_path`, one
    intra-op thread (the ranks share the test host's cores)."""
    torch.set_num_threads(1)
    initialize(world_size=count, rank=index, store=dist.FileStore(store_path, count),
               device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def numpy_dict(tensors: dict) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


# --- launcher and environment ------------------------------------------------


def times_ten(index, count, base):
    return base + index * 10


def boom(index, count):
    if index == 1:
        raise ValueError("kaput")
    return index


def silent_death(index, count):
    if index == 1:
        os._exit(3)  # dies without enqueueing a result or raising
    return index


def env_rank(index, count, port: int):
    """Rank 0 reads the JAX names, rank 1 the torchrun ones; both meet at
    one coordinator. Then a barrier and a gather of rank-shaped arrays."""
    from vsc22_tpu_torch.parallel.distributed import maybe_initialize, process_allgather
    from vsc22_tpu_torch.utils.observability import rank

    torch.set_num_threads(1)
    for name in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        os.environ.pop(name, None)
    if index == 0:
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                          JAX_NUM_PROCESSES=str(count), JAX_PROCESS_ID=str(index))
    else:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          WORLD_SIZE=str(count), RANK=str(index))
    try:
        formed = maybe_initialize(device="cpu")
        again = maybe_initialize(device="cpu")
        barrier()
        gathered = process_allgather(np.full((2, 3), rank(), np.int64))
        return {"formed": formed, "again": again, "rank": rank(),
                "world": dist.get_world_size(), "backend": dist.get_backend(),
                "gathered": gathered}
    finally:
        dist.destroy_process_group()


def mesh_rank(index, count, store_path, shape):
    """The mesh's coordinates and one collective along each axis."""
    with gloo_world(index, count, store_path):
        mesh = create_mesh(shape)
        x = torch.tensor([float(index)])
        return {"shape": mesh.shape, "coords": {a: mesh.index(a) for a in mesh.axis_names},
                "data_peers": [float(t) for t in mesh.all_gather(x, "data")],
                "model_peers": [float(t) for t in mesh.all_gather(x, "model")],
                "data_sum": float(mesh.all_reduce_(x.clone(), "data")),
                "rows": batch_sharding(mesh)(np.arange(8)).tolist()}


# --- search, score-norm, extractor -------------------------------------------


def _spy_extract_topk(calls: list):
    from vsc22_tpu_torch.ops import topk

    real = topk.extract_topk

    def spy(*args, **kwargs):
        calls.append(tuple(args[1].shape))
        return real(*args, **kwargs)

    return spy


def search_rank(index, count, store_path, data):
    """The sharded searcher, score-norm and (at 2 ranks) extractor over
    `data`'s corpora, on a (count, 1) mesh."""
    from vsc22_tpu_torch.core.types import VideoFeature
    from vsc22_tpu_torch.models import vit
    from vsc22_tpu_torch.pipelines.query_extract import DescriptorExtractor
    from vsc22_tpu_torch.retrieval import score_norm, search

    with gloo_world(index, count, store_path):
        mesh = create_mesh((count, 1))
        out = {}
        saved = search.REF_TILE, search.EXTRACT_E
        search.REF_TILE, search.EXTRACT_E = 256, 4  # the JAX searcher's ref_tile, extract_e
        try:
            s = search.SimilaritySearcher(data["refs"], device="cpu", mesh=mesh)
            out["tile"] = (s.shard_rows, s.ref_tile, s.base, s.local_valid)
            out["row_topk"] = s.row_topk(data["q"], 4)
            out["row_topk_exact"] = s.row_topk(data["q"], 40)
            out["global_topk"] = [s.global_topk(data["q"], gk) for gk in (50, 700, 5000)]
            out["threshold"] = s.threshold_search(data["q"], 0.45, k0=8)
        finally:
            search.REF_TILE, search.EXTRACT_E = saved

        ints = search.SimilaritySearcher(data["int_refs"], device="cpu", mesh=mesh)
        out["int_row_topk"] = ints.row_topk(data["int_q"], 8)
        out["int_global_topk"] = ints.global_topk(data["int_q"], 100)

        calls = []
        search.topk.extract_topk, real = _spy_extract_topk(calls), search.topk.extract_topk
        try:
            big = search.SimilaritySearcher(data["b5_refs"], device="cpu", mesh=mesh)
            out["b5_active"] = big._fused_active(16)
            out["b5_row_topk"] = big.row_topk(data["b5_q"], 10)
        finally:
            search.topk.extract_topk = real
        out["b5_calls"] = calls

        def videos(key):
            return [VideoFeature(video_id=f"{key}{i}", timestamps=np.arange(len(f), dtype=np.float32),
                                 feature=f) for i, f in enumerate(data[key])]

        # the callers' mesh= paths: the eval's budget search (f32 shipped,
        # the index's max aggregation) and the matching track's recall
        from vsc22_tpu_torch.pipelines import descriptor_eval, matching_infer

        cands = descriptor_eval.search(videos("sn_q"), videos("sn_r"), retrieve_per_query=20.0,
                                       candidates_per_query=3.0, device="cpu",
                                       transfer_dtype=np.float32, mesh=mesh)
        out["eval_search"] = [(c.query_id, c.ref_id, c.score) for c in cands]
        out["recall"] = matching_infer.recall_candidates(videos("sn_q"), videos("sn_r"),
                                                         threshold=0.3, device="cpu", mesh=mesh)

        out["score_norm"] = {}
        for nk in (1, 10):
            q, r = score_norm.score_normalize(videos("sn_q"), videos("sn_r"), videos("sn_noise"),
                                              nk=nk, device="cpu", mesh=mesh)
            out["score_norm"][nk] = (np.concatenate([f.feature for f in q]),
                                     np.concatenate([f.feature for f in r]))

        if count == 2:
            model = vit.vit_tiny_test_descriptor()
            model.load_state_dict({k: torch.from_numpy(v) for k, v in data["vit"].items()})
            ext = DescriptorExtractor(model, size=64, preset="vit", chunk=data["chunk"],
                                      device="cpu", mesh=mesh)
            out["extractor_chunk"] = ext.chunk
            out["extractor"] = ext.extract(data["frames"])
        return out


# --- training ------------------------------------------------------------------


def vit_model(rate: float):
    from vsc22_tpu_torch.models import vit

    return vit.VitDescriptor(dataclasses.replace(vit.VIT_TINY_TEST, dropout=rate, drop_path=rate),
                             head_dim=64, out_dim=16)


def run_contrastive(mesh, case: dict, steps: int = 3) -> dict:
    """`steps` sharded steps of `case` (its model weights, global batch and
    config) from this rank's rows: the losses, the first step's reduced
    gradients, and the whole params and EMA after."""
    from vsc22_tpu_torch.train import contrastive as tc

    model = vit_model(case["rate"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["weights"].items()})
    cfg = tc.ContrastiveConfig(**case["cfg"])
    local = batch_sharding(mesh)
    batch = {k: torch.from_numpy(local(v)) for k, v in case["batch"].items()}
    state, tx = tc.create_train_state(model, cfg, mesh=mesh)
    step = tc.make_train_step(model, tx, cfg, mesh=mesh)
    _, grads = step.gradients(batch, torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()]
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch, gen)
        losses.append({k: float(v) for k, v in metrics.items()})
    whole = state.whole()
    return {"losses": losses, "grads": dict(zip(names, (g.numpy() for g in grads))),
            "params": numpy_dict(whole.params), "ema": numpy_dict(whole.ema_params),
            "shard_shapes": {n: tuple(t.shape) for n, t in state.params.items()},
            "model": numpy_dict(dict(model.named_parameters())), "state": state}


def checkpoint_round_trip(state, root: str) -> bool:
    """Rank 0 writes the whole state; every rank reads it back into its
    blocks: the same blocks, moments and EMA, bit for bit."""
    from vsc22_tpu_torch.train.checkpoint import CheckpointManager
    from vsc22_tpu_torch.utils.observability import rank

    ckpt = CheckpointManager(root)
    whole = state.whole()
    if rank() == 0:
        ckpt.save(state.step, whole)
    barrier()
    back = state.take_shards(ckpt.restore(state.whole()))
    pairs = [(back.params, state.params), (back.ema_params, state.ema_params),
             (dict(enumerate(back.opt_state.mu)), dict(enumerate(state.opt_state.mu))),
             (dict(enumerate(back.opt_state.nu)), dict(enumerate(state.opt_state.nu)))]
    return back.step == state.step and all(
        torch.equal(a[k], b[k]) for a, b in pairs for k in b)


def train_rank(index, count, store_path, shape, cases, root, vsm=None, cli=None):
    """The contrastive `cases` on a `shape` mesh, a checkpoint round trip
    of the last one's state, and where given the VSM case and the CLI."""
    with gloo_world(index, count, store_path):
        mesh = create_mesh(shape)
        out = {"contrastive": {}}
        state = None
        for name, case in cases.items():
            res = run_contrastive(mesh, case)
            state = res.pop("state")
            out["contrastive"][name] = res
        out["round_trip"] = checkpoint_round_trip(state, os.path.join(root, "ckpt"))
        if vsm is not None:
            out["vsm"] = run_vsm(mesh, vsm)
        if cli is not None:
            out["cli"] = run_cli(cli)
        return out


def run_vsm(mesh, case: dict, steps: int = 3) -> dict:
    from vsc22_tpu_torch.models import vsm
    from vsc22_tpu_torch.train import vid_score as tvs

    model = vsm.VideoScoreModel(dataclasses.replace(vsm.VSM_TINY_TEST, dropout=0.0))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["weights"].items()})
    cfg = tvs.VidScoreConfig(**case["cfg"])
    state, tx = tvs.create_vid_score_state(model, cfg)
    step = tvs.make_vid_score_train_step(model, tx, cfg, mesh=mesh)
    local = batch_sharding(mesh)
    batch = {k: torch.from_numpy(local(v)) for k, v in case["batch"].items()}
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "params": numpy_dict(state.params),
            "ema": numpy_dict(state.ema_params)}


def run_cli(cli: dict) -> dict:
    """The descriptor CLI in this world: two unbroken epochs, then a run
    cut after its first epoch's checkpoint (the loader failing in the
    second) and resumed; which files each rank wrote."""
    from vsc22_tpu_torch.data.datasets import DataLoader
    from vsc22_tpu_torch.train import checkpoint, descriptor_cli

    writes = []
    real_save, real_snapshot = checkpoint.CheckpointManager.save, descriptor_cli.save_ema_snapshot
    real_epoch = DataLoader.epoch

    def save(self, step, *args, **kwargs):
        writes.append(("ckpt", step))
        return real_save(self, step, *args, **kwargs)

    def snapshot(path, *args, **kwargs):
        writes.append(("ema", os.path.basename(path)))
        return real_snapshot(path, *args, **kwargs)

    def cut(self, e=0):
        if e == 1:
            raise KeyboardInterrupt("cut")
        return real_epoch(self, e)

    checkpoint.CheckpointManager.save = save
    descriptor_cli.save_ema_snapshot = snapshot
    flags = [*cli["flags"], "--store", cli["store"], "--epochs", "2"]
    try:
        unbroken = descriptor_cli.main([*flags, "--work_dir", cli["unbroken"]])
        DataLoader.epoch = cut
        try:
            descriptor_cli.main([*flags, "--work_dir", cli["resumed"]])
        except KeyboardInterrupt:
            pass
        DataLoader.epoch = real_epoch
        barrier()  # rank 0's checkpoint is written
        cut_steps = checkpoint.CheckpointManager(
            os.path.join(cli["resumed"], "checkpoints")).all_steps()
        resumed = descriptor_cli.main([*flags, "--work_dir", cli["resumed"], "--resume"])
    finally:
        checkpoint.CheckpointManager.save = real_save
        descriptor_cli.save_ema_snapshot = real_snapshot
        DataLoader.epoch = real_epoch
    return {"cut_steps": cut_steps, "steps": (resumed.step, unbroken.step), "writes": writes,
            "resumed": numpy_dict(resumed.whole().params),
            "unbroken": numpy_dict(unbroken.whole().params),
            "resumed_ema": numpy_dict(resumed.whole().ema_params)}
