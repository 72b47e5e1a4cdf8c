"""Row-max similarity (kernel K3): max_j q_i . r_j per query row.

Counterpart of `vsc22_tpu/ops/pallas_sim.py` `row_max_gemm`; the CUDA
kernel is `csrc/row_max.cu`. Operands are rounded to f16 (as the JAX
wrapper ships them) and the products are accumulated in f32, without ever
materialising the [Nq, Nr] similarity matrix. The kernel runs on the f16
tensor-core tile of `csrc/gemm_nt.cuh`, over the grid of `row_max_grid`;
its first pass rounds both operands to f16 into scratch copies whose D is
padded with zeros to `padded_width(D)`. The launch is the registered op
`vsc22::row_max` (`ops/library.py`), so a profiler's trace holds its shapes
and its device time.
"""

from __future__ import annotations

import torch

from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.library import kernel_op
from vsc22_tpu_torch.ops.vjp import refuse_grad

_ARGTYPES = [build.PTR] * 4 + [build.INT] * 5 + [build.PTR]
# Rows of a query tile (the kernel's block tile), and the fewest blocks
# the grid should hold: two per SM of an H100 (132 SMs).
QUERY_TILE = 128
MIN_BLOCKS = 2 * 132
D_MULTIPLE = 16  # the kernel's D: whole 16-byte loads, whole k16 mma steps


def row_max_grid(nq: int, nr: int) -> tuple:
    """(query_tiles, ref_splits) of K3's grid: 128-row query tiles, and the
    refs cut into that many contiguous, balanced chunks (split s holds refs
    s * nr // splits .. (s + 1) * nr // splits), as few as give the grid
    MIN_BLOCKS blocks, and never more than nr, so no chunk is empty."""
    tiles = -(-nq // QUERY_TILE)
    return tiles, max(1, min(nr, -(-MIN_BLOCKS // max(tiles, 1))))


def padded_width(d: int) -> int:
    """D of the kernel's f16 operand copies: d rounded up to a multiple of
    D_MULTIPLE. The zero columns add exact zeros to every product sum, so
    the row maxima are those of the unpadded operands."""
    return -(-d // D_MULTIPLE) * D_MULTIPLE


def row_max_gemm_reference(queries, refs):
    """Plain PyTorch version: max of q @ r.T on the f16-rounded operands."""
    q = queries.to(torch.float16).float()
    r = refs.to(torch.float16).float()
    return (q @ r.t()).amax(dim=1)


def row_max_gemm(queries, refs):
    """[Nq] f32 row maxima; K3 on CUDA tensors, the plain version on CPU
    ones. Not differentiable, on either device (the JAX kernel has no VJP):
    raises on an operand that requires grad."""
    refuse_grad("row_max_gemm", queries, refs)
    if queries.ndim != 2 or refs.ndim != 2 or queries.shape[1] != refs.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} and {tuple(refs.shape)} do not pair")
    if refs.shape[0] == 0:
        raise ValueError("row_max_gemm needs at least one ref row")
    if queries.device.type == "cpu":
        return row_max_gemm_reference(queries, refs)
    device = build.require_cuda(queries)
    if refs.device != device:
        raise ValueError(f"refs on {refs.device}, queries on {device}")
    if queries.shape[0] == 0:
        return torch.empty(0, dtype=torch.float32, device=device)
    return _row_max_op(queries.float().contiguous(), refs.float().contiguous())


def _row_max_cuda(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    device = q.device
    nq, (nr, d) = q.shape[0], r.shape
    out = torch.empty(nq, dtype=torch.float32, device=device)
    dp = padded_width(d)
    # the f16 copies of both operands, in one allocation: at the query
    # pass's shape each allocation costs the host as much as a launch
    scratch = torch.empty((nq + nr) * dp, dtype=torch.float16, device=device)
    build.call(
        "row_max", "vsc22_row_max", _ARGTYPES,
        q.data_ptr(), r.data_ptr(), scratch.data_ptr(), out.data_ptr(), nq, nr, d, dp,
        row_max_grid(nq, nr)[1], build.stream_ptr(device),
    )
    row_max_gemm.launches += 1
    return out


row_max_gemm.launches = 0
_row_max_op = kernel_op(
    "row_max", _row_max_cuda,
    fake=lambda q, r: q.new_empty((q.shape[0],), dtype=torch.float32),
)
