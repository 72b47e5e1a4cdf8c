"""CSLS-style score normalization against a noise reference corpus.

Counterpart of `vsc22_tpu/retrieval/score_norm.py`: each query frame gets
an extra dimension holding -beta * mean(top-nk inner-product similarities
to the noise corpus), references a constant-1 extra dimension, so a plain
inner product realizes sim(q, r) + bias(q). Before that the noise corpus's
minimum-variance dimension is deleted and rows are re-L2-normalized. nk=1
runs kernel K3 (`ops/sim.py`) on `device`; nk > 1 one batched `row_topk`
of the searcher (`retrieval/search.py`) over every frame. With a `mesh`
(`parallel/mesh.Mesh`) the noise corpus is row-sharded over its data axis
and the searcher serves nk 1 too (K3 is off that path, as in JAX).

`query_score_normalize` is the span `score_norm` (`utils/observability`,
`call=<number>`), holding `score_norm.prepare` (the queries and the noise
corpus prepared on the host) and `score_norm.bias` (`_noise_bias`); K3's
two operand copies go to the `h2d_bytes` counter.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.ops.sim import row_max_gemm
from vsc22_tpu_torch.retrieval.search import SimilaritySearcher
from vsc22_tpu_torch.utils.observability import count, span

_calls = itertools.count()  # numbers each query_score_normalize call's span


def transform_features(features: List[VideoFeature], transform) -> List[VideoFeature]:
    return [dataclasses.replace(f, feature=transform(f.feature)) for f in features]


def _repack(features: List[VideoFeature], packed: np.ndarray) -> List[VideoFeature]:
    """Split a packed [sum(N_i), D] matrix back into per-video views."""
    offsets = np.cumsum([len(f.feature) for f in features[:-1]])
    return [
        dataclasses.replace(f, feature=part)
        for f, part in zip(features, np.split(packed, offsets))
    ]


def _prepare(
    features: List[VideoFeature],
    delete_dim: Optional[int],
    l2_normalize: bool,
    append: Optional[np.ndarray] = None,
) -> List[VideoFeature]:
    """delete-dim -> L2 -> optional appended column, on one packed matrix."""
    if not features:
        return []
    d = features[0].feature.shape[1]
    kept = d - (1 if delete_dim is not None else 0)
    extra = append.shape[1] if append is not None else 0
    n_rows = sum(len(f.feature) for f in features)
    out = np.empty((n_rows, kept + extra), features[0].feature.dtype)
    row = 0
    for f in features:
        m = len(f.feature)
        if delete_dim is None:
            out[row : row + m, :d] = f.feature
        else:
            out[row : row + m, :delete_dim] = f.feature[:, :delete_dim]
            out[row : row + m, delete_dim:kept] = f.feature[:, delete_dim + 1 :]
        row += m
    if l2_normalize:
        norms = np.sqrt(np.einsum("ij,ij->i", out[:, :kept], out[:, :kept], optimize=True))
        out[:, :kept] /= np.maximum(norms, 1e-12)[:, None]
    if append is not None:
        out[:, kept:] = append
    return _repack(features, out)


def _min_variance_dim(features: List[VideoFeature]) -> int:
    stacked = np.concatenate([f.feature for f in features], axis=0)
    return int(stacked.var(axis=0).argmin())


# Serving calls score-norm once per batch against the same noise corpus;
# the searcher (the corpus on the device) is kept for the next call. Keyed
# by the device and a content digest of the prepared matrix, so a hit is
# only possible for byte-identical noise. Least recently used goes first.
_SEARCHER_CACHE: "OrderedDict[tuple, SimilaritySearcher]" = OrderedDict()
_SEARCHER_CACHE_SIZE = 4


def _cached_searcher(noise: np.ndarray, device) -> SimilaritySearcher:
    key = (
        str(device),
        noise.shape,
        hashlib.blake2b(np.ascontiguousarray(noise).tobytes(), digest_size=16).hexdigest(),
    )
    searcher = _SEARCHER_CACHE.get(key)
    if searcher is None:
        searcher = SimilaritySearcher(noise, device=device)
        _SEARCHER_CACHE[key] = searcher
        while len(_SEARCHER_CACHE) > _SEARCHER_CACHE_SIZE:
            _SEARCHER_CACHE.popitem(last=False)
    else:
        _SEARCHER_CACHE.move_to_end(key)
    return searcher


def _to_device(array: np.ndarray, device) -> torch.Tensor:
    """`array` on `device` by a plain pageable copy, its bytes counted as
    `h2d_bytes`."""
    array = np.ascontiguousarray(array)
    count("h2d_bytes", array.nbytes)
    return torch.from_numpy(array).to(device)


def _noise_bias(
    queries: List[VideoFeature],
    score_norm_refs: List[VideoFeature],
    beta: float,
    nk: int,
    device,
    mesh=None,
) -> np.ndarray:
    """Packed per-query-frame bias [sum(N_i), 1] =
    -beta * mean(top-nk sims to the noise corpus): K3 for nk=1 on one
    device, else one batched top-k over every video's frames (the sharded
    searcher, uncached, under a mesh)."""
    noise = np.concatenate([r.feature for r in score_norm_refs], axis=0)
    all_q = np.concatenate([q.feature for q in queries], axis=0)
    if mesh is not None:
        sims, _ = SimilaritySearcher(noise, device=device, mesh=mesh).row_topk(all_q, nk)
        return -beta * sims.mean(axis=1, keepdims=True)
    if nk == 1:
        sims = row_max_gemm(_to_device(all_q, device), _to_device(noise, device))
        return -beta * sims.cpu().numpy()[:, None]
    sims, _ = _cached_searcher(noise, device).row_topk(all_q, nk)
    return -beta * sims.mean(axis=1, keepdims=True)


def _check_disjoint(refs: List[VideoFeature], score_norm_refs: List[VideoFeature]):
    if {f.video_id for f in refs} & {f.video_id for f in score_norm_refs}:
        raise ValueError(
            "Score-normalizing against the evaluated reference set is against "
            "VSC rules; an independent noise corpus is required."
        )


def score_normalize(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    score_norm_refs: List[VideoFeature],
    l2_normalize: bool = True,
    replace_dim: bool = True,
    beta: float = 1.0,
    nk: int = 1,
    device="cuda",
    mesh=None,
) -> Tuple[List[VideoFeature], List[VideoFeature]]:
    """Normalize queries and refs together against a noise corpus; the
    noise search runs on `device` (the card unless the caller says
    otherwise), sharded over `mesh` where given."""
    device = resolve(device)
    _check_disjoint(refs, score_norm_refs)
    low_var_dim = (
        _min_variance_dim(score_norm_refs)
        if score_norm_refs is not None and replace_dim
        else None
    )
    score_norm_refs = _prepare(score_norm_refs, low_var_dim, l2_normalize)
    queries = _prepare(queries, low_var_dim, l2_normalize)
    bias = _noise_bias(queries, score_norm_refs, beta, nk, device, mesh)
    adapted_queries = _prepare(queries, None, False, append=bias)
    n_ref_rows = sum(len(r.feature) for r in refs)
    ones = np.ones((n_ref_rows, 1), refs[0].feature.dtype if refs else np.float32)
    adapted_refs = _prepare(refs, low_var_dim, l2_normalize, append=ones)
    return adapted_queries, adapted_refs


def query_score_normalize(
    queries: List[VideoFeature],
    score_norm_refs: List[VideoFeature],
    video_scores: Optional[Dict[str, float]] = None,
    score_threshold: float = 0.001,
    low_var_dim: int = 0,
    l2_normalize: bool = True,
    replace_dim: bool = True,
    beta: float = 1.0,
    nk: int = 1,
    device="cuda",
    mesh=None,
) -> List[VideoFeature]:
    """Query-side normalization with VED gating: queries whose video score
    is under `score_threshold` get bias -100. The noise search runs on
    `device` (the card unless the caller says otherwise), sharded over
    `mesh` where given."""
    device = resolve(device)
    dim = low_var_dim if score_norm_refs is not None and replace_dim else None
    with span("score_norm", call=next(_calls)):
        with span("score_norm.prepare"):
            queries = _prepare(queries, dim, l2_normalize)
            score_norm_refs = _prepare(score_norm_refs, dim, l2_normalize)
        with span("score_norm.bias"):
            bias = _noise_bias(queries, score_norm_refs, beta, nk, device, mesh)
        if video_scores is not None:
            gated = np.repeat(
                np.fromiter(
                    (video_scores[q.video_id] < score_threshold for q in queries),
                    bool, count=len(queries),
                ),
                [len(q.feature) for q in queries],
            )
            bias = np.where(gated[:, None], -100.0, bias).astype(bias.dtype)
        return _prepare(queries, None, False, append=bias)


def ref_score_normalize(
    refs: List[VideoFeature],
    score_norm_refs: List[VideoFeature],
    l2_normalize: bool = True,
    replace_dim: bool = True,
    beta: float = 1.0,
    nk: int = 1,
) -> List[VideoFeature]:
    """Reference-side normalization: delete noise min-var dim, L2, append 1s.
    `beta` and `nk` are taken, and ignored, as the JAX signature takes them:
    the reference side gets no bias."""
    _check_disjoint(refs, score_norm_refs)
    dim = (
        _min_variance_dim(score_norm_refs)
        if score_norm_refs is not None and replace_dim
        else None
    )
    if not refs:
        return []
    n_rows = sum(len(r.feature) for r in refs)
    ones = np.ones((n_rows, 1), refs[0].feature.dtype)
    return _prepare(refs, dim, l2_normalize, append=ones)
