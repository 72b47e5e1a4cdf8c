"""Video temporal alignment over Q x R frame-similarity maps: DTW, DP, TN
and HV.

Counterpart of `vsc22_tpu/align/vta.py`: an alignment maps a [Q, R]
similarity matrix to boxes [q0, r0, q1, r1] (inclusive frame indices)
marking copied segments. DTW and HV are numpy. The sequential parts of DP
(the mPDP fill) and TN (the temporal network) run in the host library
`csrc/vta_kernels.cpp`, built with g++ at first use (`kernels/build.py`);
they raise if it cannot be built. Their Python versions,
`dp_matrix_reference` and `tn_reference`, which the library matches bit
for bit, are the plain versions the tests hold it against; no method
calls them.

Alignment is host work on numpy maps. `BaseVtaModel` fans it over a pool
of worker processes started by a forkserver, so a worker never inherits
the parent's CUDA context: it gets numpy maps and never touches the card.
`build_vta_model` builds and loads the library in the parent, so that a
worker only opens the built file.
"""

from __future__ import annotations

import ctypes
import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Any, List, Sequence, Tuple

import numpy as np


@functools.cache
def _native() -> ctypes.CDLL:
    """The host library with its two entry points typed (once a process)."""
    from vsc22_tpu_torch.kernels.build import host_library

    lib = host_library("vta_kernels")
    lib.vta_dp_fill.restype = None
    lib.vta_dp_fill.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_double, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.vta_tn.restype = ctypes.c_int64
    lib.vta_tn.argtypes = [
        ctypes.c_void_p,  # sims
        ctypes.c_int64,  # q_len
        ctypes.c_int64,  # r_len
        ctypes.c_int64,  # tn_max_step
        ctypes.c_int64,  # tn_top_k
        ctypes.c_int64,  # max_path
        ctypes.c_double,  # min_sim
        ctypes.c_int64,  # min_length
        ctypes.c_double,  # max_iou
        ctypes.c_void_p,  # out_boxes
        ctypes.c_int64,  # max_boxes
    ]
    return lib


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


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


def zero_runs(a: np.ndarray) -> np.ndarray:
    """[start, end) ranges of consecutive zeros in `a`."""
    iszero = np.concatenate(([0], np.equal(a, 0).astype(np.int8), [0]))
    absdiff = np.abs(np.diff(iszero))
    return np.where(absdiff == 1)[0].reshape(-1, 2)


def cut_path(path: np.ndarray, diagonal_thres: int) -> np.ndarray:
    """Split an alignment path at long horizontal/vertical runs.

    Returns [k, 2] kept [start, end) ranges into `path`.
    """
    vertical = zero_runs(np.diff(path[:, 0]))
    vertical[:, 1] += 1
    horizontal = zero_runs(np.diff(path[:, 1]))
    horizontal[:, 1] += 1

    vertical = vertical[np.diff(vertical, axis=-1).squeeze(axis=-1) > diagonal_thres]
    horizontal = horizontal[np.diff(horizontal, axis=-1).squeeze(axis=-1) > diagonal_thres]
    discard = np.concatenate([vertical, horizontal], axis=0)
    discard = discard[discard[:, 0].argsort()]

    endpoints = discard.ravel()
    if len(endpoints) == 0:
        return np.array([[0, len(path)]], dtype=np.int32)
    endpoints = endpoints[1:] if endpoints[0] == 0 else np.concatenate([[0], endpoints])
    endpoints = (
        endpoints[:-1]
        if endpoints[-1] == len(path)
        else np.concatenate([endpoints, [len(path)]])
    )
    return endpoints.reshape(-1, 2)


def _boxes_from_path(
    path: np.ndarray,
    sim_matrix: np.ndarray,
    keep_ranges: np.ndarray,
    min_sim: float,
    min_length: int,
) -> List[List[int]]:
    out = []
    for s, e in keep_ranges:
        sub = path[s:e]
        mean_sim = np.mean(sim_matrix[sub[:, 0], sub[:, 1]])
        if (
            mean_sim > min_sim
            and (sub[-1][0] - sub[0][0]) > min_length
            and (sub[-1][1] - sub[0][1]) > min_length
        ):
            out.append([int(sub[0][0]), int(sub[0][1]), int(sub[-1][0]), int(sub[-1][1])])
    return out


# ---------------------------------------------------------------------------
# DTW
# ---------------------------------------------------------------------------


def _dtw_accumulate(cost: np.ndarray) -> np.ndarray:
    """DTW accumulated-cost matrix with moves (1,1),(1,0),(0,1).

    Row recurrence x_j = min(b_j, c_j + x_{j-1}) where
    b_j = c_j + min(top_j, topleft_j). Solved per row in closed form:
    x_j = C_j + cummin_k<=j (b_k - C_k) with prefix sums C — one vector op
    per row instead of an inner sequential loop.
    """
    m, n = cost.shape
    acc = np.empty((m, n), np.float64)
    acc[0] = np.cumsum(cost[0])
    for i in range(1, m):
        prev = acc[i - 1]
        best_up = np.empty(n, np.float64)
        best_up[0] = prev[0]
        best_up[1:] = np.minimum(prev[1:], prev[:-1])  # min(top, topleft)
        b = cost[i] + best_up
        b[0] = cost[i, 0] + prev[0]
        csum = np.cumsum(cost[i])
        acc[i] = np.minimum.accumulate(b - csum) + csum
    return acc


def _dtw_path(acc: np.ndarray) -> np.ndarray:
    """Backtrack from the corner; diagonal preferred on ties (tslearn order)."""
    i, j = acc.shape[0] - 1, acc.shape[1] - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            options = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
            k = int(np.argmin(options))
            if k == 0:
                i, j = i - 1, j - 1
            elif k == 1:
                i -= 1
            else:
                j -= 1
        path.append((i, j))
    return np.asarray(path[::-1], dtype=np.int64)


def dtw(
    sim_matrix: np.ndarray,
    discontinue: int = 3,
    min_sim: float = 0.2,
    min_length: int = 5,
    max_iou: float = 0.3,
) -> List[List[int]]:
    """Full-matrix DTW path, cut at long horizontal/vertical runs."""
    acc = _dtw_accumulate(1.0 - np.asarray(sim_matrix, np.float64))
    path = _dtw_path(acc)
    keep = cut_path(path, diagonal_thres=discontinue)
    keep = keep[np.diff(keep, axis=-1).squeeze(axis=-1) > min_length]
    return _boxes_from_path(path, sim_matrix, keep, min_sim, min_length)


# ---------------------------------------------------------------------------
# DP (mPDP: "Pattern-Based Near-Duplicate Video Retrieval and Localization")
# ---------------------------------------------------------------------------


def _dp_matrix(sim_mat: np.ndarray, discontinue: int = 3, min_sim: float = 0.0):
    """mPDP dynamic program fill in the host library: (dp [m, n] f64,
    accu [m, n] i32, back [m, n] i8), as `dp_matrix_reference` fills them."""
    m, n = sim_mat.shape[:2]
    sim64 = np.ascontiguousarray(sim_mat, np.float64)
    dp = np.empty((m, n), np.float64)
    accu = np.empty((m, n), np.int32)
    back = np.empty((m, n), np.int8)
    _native().vta_dp_fill(
        sim64.ctypes.data_as(ctypes.c_void_p), m, n, int(discontinue), float(min_sim),
        dp.ctypes.data_as(ctypes.c_void_p), accu.ctypes.data_as(ctypes.c_void_p),
        back.ctypes.data_as(ctypes.c_void_p))
    return dp, accu, back


def dp_matrix_reference(sim_mat: np.ndarray, discontinue: int = 3, min_sim: float = 0.0):
    """The mPDP fill in numpy, the plain version of `_dp_matrix`.

    dp[i,j] extends the best of (diag, up+0.5s, left+0.5s); cells whose
    accumulated unmatched run (sim < min_sim along the chosen path) exceeds
    `discontinue` are frozen at their own similarity with no back pointer.
    The inner loop is sequential by construction (left-dependency +
    conditional freeze)."""
    dp = sim_mat.astype(np.float64).copy()
    m, n = sim_mat.shape[:2]
    accu = np.zeros((m, n), np.int32)
    back = -np.ones((m, n), np.int8)

    for i in range(1, m):
        dp_im1 = dp[i - 1]
        dp_i = dp[i]
        sim_i = sim_mat[i]
        accu_im1 = accu[i - 1]
        accu_i = accu[i]
        back_i = back[i]
        for j in range(1, n):
            s = sim_i[j]
            top_left = dp_im1[j - 1] + s
            top = dp_im1[j] + 0.5 * s
            left = dp_i[j - 1] + 0.5 * s
            if top_left >= top and top_left >= left:
                max_ind, max_value, prev_accu = 0, top_left, accu_im1[j - 1]
            elif top >= left:
                max_ind, max_value, prev_accu = 1, top, accu_im1[j]
            else:
                max_ind, max_value, prev_accu = 2, left, accu_i[j - 1]
            if s < min_sim:
                accu_i[j] = prev_accu + 1
            if accu_i[j] <= discontinue:
                back_i[j] = max_ind
                dp_i[j] = max_value
    return dp, accu, back


def _find_path(dp_mat: np.ndarray, back: np.ndarray) -> np.ndarray:
    i, j = np.unravel_index(np.argmax(dp_mat), dp_mat.shape)
    path = [(i, j)]
    while back[i, j] != -1:
        if back[i, j] == 0:
            i, j = i - 1, j - 1
        elif back[i, j] == 1:
            i -= 1
        else:
            j -= 1
        if dp_mat[i, j] == -np.inf:
            break
        path.append((i, j))
    return np.asarray(path[::-1], dtype=np.int32)


def dp(
    sim_matrix: np.ndarray,
    discontinue: int = 3,
    min_sim: float = 1.0,
    ave_sim: float = 1.3,
    min_length: int = 5,
    diagonal_thres: int = 30,
) -> List[List[int]]:
    """Iterative best-path extraction over the mPDP matrix (up to 100 paths)."""
    sim_matrix = np.asarray(sim_matrix, np.float64) + 1.0  # make sims non-negative
    dp_mat, _, back = _dp_matrix(sim_matrix, discontinue=discontinue, min_sim=min_sim)

    results: List[List[int]] = []
    for _ in range(100):
        path = _find_path(dp_mat, back)
        if dp_mat[path[-1][0], path[-1][1]] == -np.inf:
            break
        r1, c1 = int(path[0][0]), int(path[0][1])
        r2, c2 = int(path[-1][0]), int(path[-1][1])
        dp_mat[r1 : r2 + 1, c1 : c2 + 1] = -np.inf

        keep = cut_path(path, diagonal_thres=diagonal_thres)
        keep = keep[np.diff(keep, axis=-1).squeeze(axis=-1) > min_length]
        results.extend(_boxes_from_path(path, sim_matrix, keep, ave_sim, min_length))
    return results


# ---------------------------------------------------------------------------
# TN (temporal network: "Scalable detection of partial near-duplicate videos
# by visual-temporal consistency")
# ---------------------------------------------------------------------------


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
    paths become boxes, NMS'd by IoU. Runs in the host library (`vta_tn`),
    bit for bit `tn_reference`."""
    sims64 = np.ascontiguousarray(sims, np.float64)
    max_boxes = max_path + 1
    out = np.empty((max_boxes, 4), np.int32)
    n = _native().vta_tn(
        sims64.ctypes.data_as(ctypes.c_void_p), sims64.shape[0], sims64.shape[1],
        int(tn_max_step), int(tn_top_k), int(max_path), float(min_sim), int(min_length),
        float(max_iou), out.ctypes.data_as(ctypes.c_void_p), max_boxes)
    return [[int(v) for v in row] for row in out[:n]]


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


def tn_reference(
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
    paths become boxes, NMS'd by IoU: the Python version, the plain
    version of `tn`. The top-k per frame is a stable descending sort, so
    ties break toward the lower ref frame."""
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


# ---------------------------------------------------------------------------
# HV (diagonal histogram voting)
# ---------------------------------------------------------------------------


def hv(
    sims: np.ndarray,
    iou_thresh: float = 0.9,
    min_sim: float = 0.2,
    max_peaks: int = 100,
) -> List[List[int]]:
    """Vote per diagonal offset sigma = r - q; strongest diagonals become
    boxes (bounding the above-threshold matches on that diagonal), NMS'd."""
    sims = np.asarray(sims, np.float64).copy()
    sims[sims < min_sim] = 0.0
    boxes: List[List[int]] = []

    q_idx, r_idx = np.where(sims >= min_sim)
    if len(q_idx) == 0:
        return boxes
    sigmas = np.unique(r_idx - q_idx)

    entries = []
    for sigma in sigmas:
        start = -sigma if sigma < 0 else 0
        end = min(max(sims.shape[1] - sigma, 0), sims.shape[0])
        if end <= start:
            continue
        qs = np.arange(start, end)
        rs = qs + sigma
        diag = sims[qs, rs]
        entries.append((float(diag.sum()), qs, rs, diag))

    entries.sort(key=lambda e: e[0], reverse=True)
    for score, qs, rs, diag in entries[:max_peaks]:
        if score <= 0.0:
            continue
        box = [int(qs.min()), int(rs.min()), int(qs.max()), int(rs.max())]
        ious = iou(
            np.asarray([box], np.float64), np.asarray(boxes, dtype=np.float64)
        )
        if np.any(ious > iou_thresh):
            continue
        boxes.append(box)
    return boxes


# ---------------------------------------------------------------------------
# Similarity maps and the model wrapper
# ---------------------------------------------------------------------------


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


_METHODS = {"DTW": dtw, "DP": dp, "TN": tn, "HV": hv}


def build_vta_model(method: str = "DTW", concurrency: int = 0, **config) -> BaseVtaModel:
    if method not in _METHODS:
        raise ValueError(f"Unknown method {method}")
    if method in ("DP", "TN"):
        _native()  # built and loaded here, before any worker starts
    return BaseVtaModel(functools.partial(_METHODS[method], **config), concurrency)
