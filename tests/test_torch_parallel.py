"""The port's multi-process layer (`vsc22_tpu_torch/parallel/`) on the CPU:
the launcher against the JAX twin's contract, the world formed from each
environment form (and not formed for one process), barrier and
process_allgather at 2 ranks, the mesh's groups at (2, 2), the parameter
rules against the JAX package's on the tiny ViT and SwinV2, and
`dryrun_multichip(4)`.

Ranks are spawned by the port's `launch_local` and run
`torch_parallel_workers`, which imports no JAX."""

import socket
import time
import types

import numpy as np
import pytest
from jax.sharding import Mesh

import jax
import torch_parallel_workers as workers
from vsc22_tpu.models import swinv2 as jsw
from vsc22_tpu.models import vit as jvit
from vsc22_tpu.parallel import mesh as jmesh
from vsc22_tpu_torch.models import swinv2, vit
from vsc22_tpu_torch.parallel import distributed, mesh
from vsc22_tpu_torch.parallel.dryrun import dryrun_multichip
from vsc22_tpu_torch.parallel.launcher import launch_local
from vsc22_tpu_torch.utils import jax_params

TIMEOUT = 240.0


def test_launch_local_orders_results():
    def work(index, count, base):
        return base + index * 10

    assert launch_local(work, 1, args=(5,)) == [5]
    assert launch_local(workers.times_ten, 3, args=(100,)) == [100, 110, 120]


def test_launch_local_failure_propagates():
    with pytest.raises(RuntimeError, match="(?s)worker 1 failed:.*kaput"):
        launch_local(workers.boom, 2, timeout=TIMEOUT)


def test_launch_local_detects_silent_worker_death():
    """A worker that exits nonzero without reporting raises promptly, not
    at the deadline (the reference's join-with-exitcode contract)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exit code 3"):
        launch_local(workers.silent_death, 2, timeout=30.0)
    assert time.monotonic() - t0 < 25.0


def test_maybe_initialize_is_a_no_op_for_one_process(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize(device="cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert distributed.maybe_initialize(device="cpu") is False
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert distributed.maybe_initialize(device="cpu") is False
    assert not torch_dist_initialized()
    distributed.barrier()
    np.testing.assert_array_equal(distributed.process_allgather(np.arange(3)), [[0, 1, 2]])


def torch_dist_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_initialized()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_maybe_initialize_from_each_environment_form():
    """Rank 0 finds the world through JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID, rank 1 through MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK; gloo for the CPU; a second call is a
    no-op; the barrier passes and process_allgather stacks by rank."""
    got = launch_local(workers.env_rank, 2, args=(free_port(),), timeout=TIMEOUT)
    for i, r in enumerate(got):
        assert (r["formed"], r["again"], r["rank"], r["world"], r["backend"]) == (
            True, True, i, 2, "gloo")
        np.testing.assert_array_equal(r["gathered"], np.stack([np.full((2, 3), 0),
                                                              np.full((2, 3), 1)]))


def test_mesh_axes_groups_and_batch_rows(tmp_path):
    """A (2, 2) mesh: rank = 2 * data + model; the data peers of a rank
    share its model coordinate and vice versa; a batch's rows split by the
    data coordinate alone. A shape that does not cover the world raises."""
    got = launch_local(workers.mesh_rank, 4, args=(str(tmp_path / "s"), (2, 2)), timeout=TIMEOUT)
    for r, res in enumerate(got):
        d, m = divmod(r, 2)
        assert res["shape"] == {"data": 2, "model": 2}
        assert res["coords"] == {"data": d, "model": m}
        assert res["data_peers"] == [float(m), float(2 + m)]
        assert res["model_peers"] == [float(2 * d), float(2 * d + 1)]
        assert res["data_sum"] == float(2 + 2 * m)
        assert res["rows"] == list(range(4 * d, 4 * d + 4))
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        mesh.create_mesh((2, 1))
    one = mesh.create_mesh()
    assert one.shape == {"data": 1, "model": 1} and one.group("data") is None


# Layouts of `jax_params`' tables: the JAX dim each port dim is.
JAX_DIM_OF = {"id": lambda n: list(range(n)), "T": lambda n: list(range(n))[::-1],
              "conv": lambda n: [3, 2, 0, 1]}


def jax_specs_in_port_dims(jax_shardings, entries) -> dict:
    """{id(port tensor): spec in the port's dims} from the JAX
    NamedSharding tree, through the key table's layouts."""
    out = {}
    for key, t, layout in entries:
        spec = tuple(jax_params._leaf(jax_shardings, key).spec)
        spec = spec + (None,) * (t.ndim - len(spec))
        port = tuple(spec[j] for j in JAX_DIM_OF[layout](t.ndim))
        out[id(t)] = () if all(a is None for a in port) else port
    return out


@pytest.mark.parametrize("kind", ["vit", "swinv2"])
@pytest.mark.parametrize("nm", [1, 2, 3])
def test_param_rules_match_jax(kind, nm):
    """`param_shardings` (and `infer_param_spec` under it) give every
    parameter of the tiny ViT and tiny SwinV2 the JAX package's spec on a
    (1, nm) mesh, mapped through the key tables' layouts (at 3, a dim that
    does not divide by 3 replicates, as in JAX)."""
    if kind == "vit":
        jm, pm = jvit.vit_tiny_test_descriptor(), vit.vit_tiny_test_descriptor()
        entries, size = jax_params.vit_entries(pm), 64
    else:
        jm, pm = jsw.swinv2_tiny_test_descriptor(), swinv2.swinv2_tiny_test_descriptor()
        entries, size = jax_params.swinv2_entries(pm), jsw.SWINV2_TINY_TEST.img_size
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                               np.zeros((1, size, size, 3), np.float32)))
    jax_mesh = Mesh(np.array(jax.devices()[:nm]).reshape(1, nm), ("data", "model"))
    want = jax_specs_in_port_dims(jmesh.param_shardings(jax_mesh, variables), entries)
    got = mesh.param_shardings(types.SimpleNamespace(shape={"data": 1, "model": nm}),
                               pm.named_parameters())
    by_id = {id(p): n for n, p in pm.named_parameters()}
    assert set(want) == set(by_id)
    assert {by_id[i]: s for i, s in want.items()} == got
    if nm == 2:
        assert sum(1 for s in got.values() if s) >= 8  # qkv, proj, fc1, fc2 of each block
        for name, p in pm.named_parameters():
            assert mesh.infer_param_spec(name, p) == got[name]


def test_dryrun_multichip_four_ranks():
    """The twin of `__graft_entry__.dryrun_multichip(4)`: a (2, 2) mesh, one
    trainer step (agreeing on every rank), the sharded search and the
    sharded extractor against their one-rank results."""
    results = dryrun_multichip(4, timeout=TIMEOUT)
    assert [r["mesh"] for r in results] == [{"data": 2, "model": 2}] * 4
    assert all(np.isfinite(r["train"]["loss"]) and r["train"]["global_batch"] == 8
               for r in results)
    assert all(r["search"]["global_topk"] == 200 and r["extractor"]["features"] == (11, 16)
               for r in results)
