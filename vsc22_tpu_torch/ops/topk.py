"""Per-block top-e extraction of q . r^T (kernel B5) and its merge.

Counterpart of `vsc22_tpu/ops/pallas_topk.py` `extract_topk`; the CUDA
kernel is `csrc/extract_topk.cu`. For every query row and every
`tile_r`-wide block of reference columns it surfaces the block's top `e`
scores with their global column indices, without materialising [Nq, Nr].
Columns at or past `num_valid` score float32's lowest value; among equal
scores the lowest column wins. The merge then takes the row top-k over the
nb * e surfaced entries (padding with float32 lowest / 0 when nb * e < k)
and `bound[q]`, the max over blocks of the e-th score: it bounds every
entry the extraction did not surface, which is the certificate
`retrieval.search.SimilaritySearcher.row_topk` rescans on.

Operands are taken as the searcher holds them, f16, bf16 (the searcher's
`compute_dtype`) or f32, and multiplied in f32 (TF32 off): the JAX
kernel's bf16 hi/lo split is not needed. The kernel has two product loops,
chosen by the static rule of `topk_route`: tensor cores for f16 or bf16
operands with D % 8 == 0 and 16-byte-aligned bases, the f32 FFMA tile for
f32 and for f16 off that rule. bf16 has the tensor-core loop only: a bf16
call off the rule raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.vjp import refuse_grad

NEG_INF = float(np.finfo(np.float32).min)
MAX_E = 8  # the kernel's template range
MAX_BLOCKS = 65535  # grid y
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}  # csrc `Dtype`
_ARGTYPES = [build.PTR] * 4 + [build.INT] * 9 + [build.PTR]
# The plain version computes this many scores at a time.
_CHUNK_ELEMS = 1 << 27


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 inside the block, whatever the
    caller's TF32 setting."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def topk_route(dtype: torch.dtype, d: int, *operands: torch.Tensor) -> str:
    """The product loop B5 takes: "mma" (tensor cores) for float16 or
    bfloat16 with D % 8 == 0 and 16-byte-aligned operands, "ffma" (the f32
    CUDA-core tile) otherwise. The wrapper passes it to the kernel, which
    refuses "mma" off the rule (`topk_is_mma` in `csrc/extract_topk.cu`)
    and bfloat16 on "ffma"."""
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    half = dtype in (torch.float16, torch.bfloat16)
    return "mma" if half and d % 8 == 0 and aligned else "ffma"


def _check(queries, refs, num_valid, e, tile_r):
    if queries.ndim != 2 or refs.ndim != 2 or queries.shape[1] != refs.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} and {tuple(refs.shape)} do not pair")
    if queries.dtype != refs.dtype or queries.dtype not in _DTYPE_CODE:
        raise TypeError(f"operands {queries.dtype}, {refs.dtype}: both float16, bfloat16 or "
                        "float32")
    if refs.shape[0] == 0 or refs.shape[1] == 0:
        raise ValueError("extract_topk needs at least one ref row and one dimension")
    if not 0 <= num_valid <= refs.shape[0]:
        raise ValueError(f"num_valid {num_valid} outside [0, {refs.shape[0]}]")
    if e < 1 or tile_r < e:
        raise ValueError(f"e {e} and tile_r {tile_r}: need 1 <= e <= tile_r")


def merge_blocks(s_blocks, i_blocks, k: int):
    """(scores [Nq, k], indices [Nq, k] int32, bound [Nq]) from per-block
    lists [nb, e, Nq]. A stable sort keeps equal scores in block order, so
    the row's ranking is (score desc, column asc), as `lax.top_k` ranks."""
    nb, e, nq = s_blocks.shape
    s_flat = s_blocks.reshape(nb * e, nq).t()
    i_flat = i_blocks.reshape(nb * e, nq).t()
    kk = min(k, nb * e)
    s, pos = torch.sort(s_flat, dim=1, descending=True, stable=True)
    s, pos = s[:, :kk], pos[:, :kk]
    i = torch.gather(i_flat, 1, pos)
    if kk < k:
        s = torch.cat([s, s.new_full((nq, k - kk), NEG_INF)], dim=1)
        i = torch.cat([i, i.new_zeros((nq, k - kk))], dim=1)
    return s, i, s_blocks[:, e - 1, :].amax(dim=0)


def extract_blocks_reference(queries, refs, num_valid: int, *, e: int, tile_r: int):
    """Plain PyTorch per-block lists [nb, e, Nq] (scores f32, columns
    int32): f32 products of the operands, chunked over ref blocks so that
    [Nq, Nr] is never whole, and an argmax peel that takes the first (the
    lowest) column among equal scores."""
    _check(queries, refs, num_valid, e, tile_r)
    nq = queries.shape[0]
    nr = refs.shape[0]
    nb = -(-nr // tile_r)
    device = queries.device
    s_out = torch.empty((nb, e, nq), dtype=torch.float32, device=device)
    i_out = torch.empty((nb, e, nq), dtype=torch.int32, device=device)
    q = queries.float()
    per_chunk = max(1, _CHUNK_ELEMS // (max(nq, 1) * tile_r))
    with no_tf32():
        for b0 in range(0, nb, per_chunk):
            b1 = min(nb, b0 + per_chunk)
            c0, c1 = b0 * tile_r, min(nr, b1 * tile_r)
            sims = torch.full((nq, (b1 - b0) * tile_r), NEG_INF, device=device)
            sims[:, : c1 - c0] = q @ refs[c0:c1].float().t()
            cols = torch.arange(c0, c0 + (b1 - b0) * tile_r, device=device)
            sims[:, cols >= num_valid] = NEG_INF
            sims = sims.view(nq, b1 - b0, tile_r)
            base = (c0 + tile_r * torch.arange(b1 - b0, device=device))[None, :]
            for p in range(e):
                a = sims.argmax(dim=2, keepdim=True)  # the first maximum
                s_out[b0:b1, p] = sims.gather(2, a).squeeze(2).t()
                i_out[b0:b1, p] = (a.squeeze(2) + base).t().to(torch.int32)
                sims.scatter_(2, a, -float("inf"))
    return s_out, i_out


def extract_topk_reference(queries, refs, num_valid: int, *, e: int, tile_r: int, k: int):
    """Plain PyTorch version of `extract_topk` (same outputs)."""
    return merge_blocks(*extract_blocks_reference(queries, refs, num_valid, e=e, tile_r=tile_r),
                        k)


def extract_topk(queries, refs, num_valid: int, *, e: int, tile_r: int, k: int):
    """(scores [Nq, k] f32, indices [Nq, k] int32, bound [Nq] f32): the row
    top-k of the surfaced entries and the truncation bound. B5 on CUDA
    tensors, the plain version on CPU ones. Not differentiable, on either
    device (the JAX kernel has no VJP): raises on an operand that requires
    grad."""
    refuse_grad("extract_topk", queries, refs)
    _check(queries, refs, num_valid, e, tile_r)
    if queries.device.type == "cpu":
        return extract_topk_reference(queries, refs, num_valid, e=e, tile_r=tile_r, k=k)
    device = build.require_cuda(queries)
    if refs.device != device:
        raise ValueError(f"refs on {refs.device}, queries on {device}")
    if e > MAX_E:
        raise ValueError(f"the kernel takes e <= {MAX_E}, got {e}")
    nq, d = queries.shape
    nr = refs.shape[0]
    nb = -(-nr // tile_r)
    if nb > MAX_BLOCKS:
        raise ValueError(f"{nb} ref blocks of {tile_r}: the kernel takes at most {MAX_BLOCKS}")
    q = queries.contiguous()
    r = refs.contiguous()
    s = torch.empty((nb, e, nq), dtype=torch.float32, device=device)
    i = torch.empty((nb, e, nq), dtype=torch.int32, device=device)
    if nq > 0:
        route = topk_route(q.dtype, d, q, r)
        if q.dtype == torch.bfloat16 and route != "mma":
            raise ValueError(f"bfloat16 operands take the tensor-core loop only, which needs "
                             f"D % 8 == 0 (D {d}) and 16-byte-aligned operands")
        build.call(
            "extract_topk", "vsc22_extract_topk", _ARGTYPES,
            q.data_ptr(), r.data_ptr(), s.data_ptr(), i.data_ptr(), nq, nr, d, int(num_valid),
            tile_r, e, nb, _DTYPE_CODE[q.dtype], int(route == "mma"), build.stream_ptr(device),
        )
        extract_topk.launches += 1
        extract_topk.route_launches[route] += 1
        extract_topk.dtype_launches[q.dtype] += 1
    return merge_blocks(s, i, k)


extract_topk.launches = 0
# Launches by product loop, for runs that check which loop a path took.
extract_topk.route_launches = {"mma": 0, "ffma": 0}
# Launches by operand type, for runs that check the bf16 route ran.
extract_topk.dtype_launches = dict.fromkeys(_DTYPE_CODE, 0)
