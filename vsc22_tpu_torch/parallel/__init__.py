"""Multi-process parallelism on torch.distributed (the NCCL/DDP role).

Counterpart of `vsc22_tpu/parallel/`. The reference's distributed runtime
is torch.distributed + NCCL (SURVEY §2.8): DDP data parallelism, a packed
all_gather for the global contrastive loss, DistributedSampler data
sharding and rank-0 npz merges. The port keeps torch.distributed, one
process per device, with a `Mesh` over the world's ranks:

- a ``data`` axis (batch rows, reference-corpus rows, a chunk's frames)
  and a ``model`` axis (the f32 masters, Adam moments and EMA of the wide
  transformer products, sharded);
- `batch_sharding` gives a rank its rows of a global batch; the global
  losses gather the embeddings explicitly (`train/contrastive.py`);
- `infer_param_spec` / `param_shardings` are the JAX package's
  name-based rules on the port's parameter names and layouts;
- `launcher.launch_local` spawns local ranks, `distributed` forms the
  process group, `dryrun.dryrun_multichip` runs a whole sharded check.
"""

from vsc22_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    infer_param_spec,
    param_shardings,
    replicated,
)
