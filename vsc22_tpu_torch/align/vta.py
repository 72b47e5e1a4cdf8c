"""Video temporal alignment over Q x R frame-similarity maps: the TN method.

Counterpart of the TN part of `vsc22_tpu/align/vta.py`: an alignment maps
a [Q, R] similarity matrix to boxes [q0, r0, q1, r1] (inclusive frame
indices) marking copied segments. The JAX package runs TN through a C++
build of the same algorithm when one is available; this is its numpy
version (`_tn_numpy` there), which the C++ one matches bit for bit.
DTW, DP and HV come with the matching track.

Alignment is host work on numpy maps. `BaseVtaModel` fans it over a pool
of worker processes started by a forkserver, so a worker never inherits
the parent's CUDA context: it gets numpy maps and never touches torch.
"""

from __future__ import annotations

import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Any, List, Sequence, Tuple

import numpy as np


def iou(bbox: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [n,4] vs [m,4] boxes (inclusive-index convention)."""
    if len(bbox) == 0 or len(gt) == 0:
        return np.array(0)
    lt = np.maximum(bbox[:, None, :2], gt[:, :2])
    rb = np.minimum(bbox[:, None, 2:], gt[:, 2:])
    wh = np.maximum(rb - lt + 1, 0)
    inter = wh[:, :, 0] * wh[:, :, 1]
    area_a = (bbox[:, 2] - bbox[:, 0] + 1) * (bbox[:, 3] - bbox[:, 1] + 1)
    area_b = (gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1)
    return inter / (area_a[:, None] + area_b - inter)


class _Dag:
    """Minimal weighted DAG with repeated longest-path extraction.

    Node ids are already in topological order (edges always go low -> high).
    """

    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        self.preds: List[List[int]] = [[] for _ in range(num_nodes)]
        self.weights = {}

    def add_edge(self, u: int, v: int, w: float):
        if (u, v) not in self.weights:
            self.preds[v].append(u)
        self.weights[(u, v)] = w

    def longest_path(self) -> List[int]:
        dist = np.zeros(self.num_nodes, np.float64)
        parent = np.full(self.num_nodes, -1, np.int64)
        for v in range(self.num_nodes):
            best, arg = 0.0, -1
            for u in self.preds[v]:
                cand = dist[u] + self.weights[(u, v)]
                if cand > best:
                    best, arg = cand, u
            dist[v] = best
            parent[v] = arg
        v = int(np.argmax(dist))
        path = [v]
        while parent[v] != -1:
            v = int(parent[v])
            path.append(v)
        return path[::-1]

    def zero_path(self, path: Sequence[int]):
        for u, v in zip(path[:-1], path[1:]):
            if (u, v) in self.weights:
                self.weights[(u, v)] = 0.0


def tn(
    sims: np.ndarray,
    tn_max_step: int = 10,
    tn_top_k: int = 5,
    max_path: int = 10,
    min_sim: float = 0.2,
    min_length: int = 5,
    max_iou: float = 0.3,
) -> List[List[int]]:
    """Temporal-network alignment: top-k matches per query frame become DAG
    nodes; constraint-filtered edges (C1 step bound, C2 forward ref motion,
    C3 no used intermediate ref frame, C4 min similarity); repeated longest
    paths become boxes, NMS'd by IoU. The top-k per frame is a stable
    descending sort, so ties break toward the lower ref frame."""
    boxes: List[List[int]] = []
    q_len = sims.shape[0]
    top = min(tn_top_k, sims.shape[1])

    topk_indices = np.argsort(-sims, kind="stable")[:, :top]
    topk_sims = np.take_along_axis(sims, topk_indices, axis=-1)

    # Node layout: 0 = source; pair (q, k) -> 1 + q*top + k. The last pair
    # node doubles as the sink (reference convention).
    num_nodes = 1 + q_len * top
    dag = _Dag(num_nodes)
    node_pair = {0: (-1, -1)}
    for q in range(q_len):
        for k in range(top):
            node_pair[1 + q * top + k] = (q, int(topk_indices[q, k]))

    for q_i in range(q_len):
        r_i = topk_indices[q_i]
        intermediate_rs = np.empty((0,), dtype=np.int64)
        for q_j in range(q_i + 1, min(q_len, q_i + tn_max_step)):
            r_j = topk_indices[q_j]
            r_diff = r_j[:, None] - r_i[None, :]  # [dst k, src k]
            c2 = (r_diff > 0) & (r_diff < tn_max_step)
            if len(intermediate_rs) == 0:
                c3 = np.ones_like(c2)
            else:
                cond1 = intermediate_rs[None, :] > r_i[:, None]  # [src, inter]
                cond2 = intermediate_rs[None, :] < r_j[:, None]  # [dst, inter]
                c3 = np.sum(cond2[:, None, :] & cond1[None, :, :], axis=-1) == 0
            s_j = np.repeat(topk_sims[q_j].reshape(-1, 1), top, axis=1)
            c4 = s_j >= min_sim

            rows, cols = np.where(c2 & c3 & c4)
            intermediate_rs = np.unique(np.concatenate([intermediate_rs, r_j[rows]]))
            for r, c in zip(rows, cols):
                dag.add_edge(
                    1 + q_i * top + c, 1 + q_j * top + r, float(s_j[r, c])
                )

    # Sink edges into the last pair node.
    sink = num_nodes - 1
    pair_sink = node_pair[sink]
    for i in range(sink):
        pi = node_pair[i]
        if (
            pair_sink[0] > pi[0]
            and pair_sink[1] > pi[1]
            and pair_sink[0] - pi[0] <= tn_max_step
            and pair_sink[1] - pi[1] <= tn_max_step
        ):
            dag.add_edge(i, sink, 0.0)

    for _ in range(max_path + 1):
        path = dag.longest_path()
        dag.zero_path(path)
        path = [v for v in path if v != 0 and v != sink]
        if not path:
            break
        qs = [node_pair[v][0] for v in path]
        rs = [node_pair[v][1] for v in path]
        score = float(sum(sims[q, r] for q, r in zip(qs, rs)))
        if score > 0:
            q_min, q_max = min(qs), max(qs)
            r_min, r_max = min(rs), max(rs)
        else:
            q_min = q_max = r_min = r_max = 0
        ave_length = (r_max - r_min + q_max - q_min) / 2
        ious = iou(
            np.array([[q_min, r_min, q_max, r_max]], dtype=np.float64),
            np.asarray(boxes, dtype=np.float64),
        )
        if (
            ave_length > 0
            and score / ave_length > min_sim
            and min(r_max - r_min, q_max - q_min) > min_length
            and ious.max() < max_iou
        ):
            boxes.append([int(q_min), int(r_min), int(q_max), int(r_max)])
    return boxes


def chamfer_sim(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Symmetric chamfer similarity between per-frame local-descriptor sets:
    q [Q, m, D], r [R, n, D] -> [Q, R], the average of mean-over-n
    (max-over-m) and mean-over-m (max-over-n)."""
    sim = np.einsum("qmd,rnd->qmnr", q, r)
    c1 = sim.max(axis=1).mean(axis=1)
    c2 = sim.max(axis=2).mean(axis=1)
    return (c1 + c2) / 2.0


def sim_norm(
    sim: np.ndarray, lower_bound: float = 0.0, upper_bound: float = 0.3
) -> np.ndarray:
    """Clip to [lower, upper] and rescale by the range."""
    return np.clip(sim, lower_bound, upper_bound) / (upper_bound - lower_bound)


def sim_map(
    qid: str,
    rid: str,
    q: np.ndarray,
    r: np.ndarray,
    normalize_input: bool = False,
    similarity_type: str = "cos",
) -> Tuple[str, str, np.ndarray]:
    """Similarity map between two descriptor sequences: ``cos`` over [N, D]
    rows, ``chamfer`` (then sim_norm) over [N, m, D] per-frame sets."""
    if normalize_input:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        r = r / np.linalg.norm(r, axis=-1, keepdims=True)
    if similarity_type == "cos":
        return qid, rid, np.dot(q, r.T)
    if similarity_type == "chamfer":
        return qid, rid, sim_norm(chamfer_sim(q, r))
    raise ValueError(f"Unknown similarity_type {similarity_type}")


class BaseVtaModel:
    """Applies an alignment function to batches of (key, sim_matrix) pairs,
    sequentially, or over `concurrency` worker processes when > 0.

    A worker started by a forkserver imports the caller's main module
    afresh, seconds where that module imports torch. So inside a `with`
    block the model keeps one pool for every call; outside one, each call
    starts and stops its own."""

    def __init__(self, func_to_run, concurrency: int = 0):
        self.func_to_run = func_to_run
        self.concurrency = concurrency
        self._pool = None

    def __enter__(self) -> "BaseVtaModel":
        if self.concurrency > 0 and self._pool is None:
            self._pool = ProcessPoolExecutor(
                max_workers=self.concurrency, mp_context=multiprocessing.get_context("forkserver"))
        return self

    def __exit__(self, *exc) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def forward(
        self,
        data: List[Tuple[str, str, np.ndarray, np.ndarray]],
        normalize_input: bool = False,
        similarity_type: str = "cos",
    ) -> List[Any]:
        sims = [
            (f"{q}-{r}", sim_map(q, r, qf, rf, normalize_input, similarity_type)[2])
            for q, r, qf, rf in data
        ]
        return self.forward_sim(sims)

    def forward_sim(self, data: List[Tuple[str, np.ndarray]]) -> List[Any]:
        if self.concurrency > 0 and len(data) > 1:
            if self._pool is None:
                with self:
                    return self.forward_sim(data)
            keys = [key for key, _ in data]
            chunk = max(1, len(data) // (4 * self.concurrency))
            results = self._pool.map(self.func_to_run, [np.asarray(sim) for _, sim in data],
                                     chunksize=chunk)
            return list(zip(keys, results))
        return [(key, self.func_to_run(sim)) for key, sim in data]


_METHODS = {"TN": tn}
_LATER = ("DTW", "DP", "HV")  # with the matching track


def build_vta_model(method: str = "TN", concurrency: int = 0, **config) -> BaseVtaModel:
    if method in _LATER:
        raise NotImplementedError(f"{method} alignment is not ported yet; TN is")
    if method not in _METHODS:
        raise ValueError(f"Unknown method {method}")
    return BaseVtaModel(functools.partial(_METHODS[method], **config), concurrency)
