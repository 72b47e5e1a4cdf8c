"""Exact similarity search on one device: tiled products + top-k.

Counterpart of `vsc22_tpu/retrieval/search.py` (the FAISS replacement). The
reference's adaptive range search returns exactly the global top-`global_k`
entries of the Q x R inner-product matrix; this computes that directly:

  1. per-query-row top-m candidates (`row_topk`), from a scan over ref
     tiles that never holds the whole similarity matrix;
  2. the global threshold tau = k-th best of the collected candidates;
  3. rows whose m-th candidate still exceeds tau are rescanned with doubled
     m (`global_topk`);
  4. host-side sort + truncate.

`row_topk` is the fast-exact scan: it surfaces only the top `e` entries of
each ref block and carries, per row, the max over blocks of the e-th one.
That value bounds every entry not surfaced, from the very same products,
so a row whose bound is strictly below its k-th score is exact; the rare
rows that fail are rescanned through the exact per-tile path. Where the
dispatch rule of the JAX package (`_fused_active`) holds, the scan is
kernel B5 (`ops/topk.extract_topk`, e 4 over 1024-column blocks); else it
is `_row_topk_fast`, the same function at (REF_TILE, EXTRACT_E) in plain
torch, as it is XLA in JAX. On a CUDA device where the rule holds, B5
runs or the call raises: nothing falls back.

Multi-device (`mesh=`, `parallel/mesh.Mesh`): every rank holds its rows
of the corpus along the mesh's data axis, padded to `shard_rows =
round_up(n, nd * 128) / nd` as the JAX searcher pads them; each rank scans
its shard, its local winners are all-gathered and every rank re-reduces
them alike to the global top-k (a stable sort: equal scores keep the
shard order, as `lax.top_k` keeps it), so every rank returns the same
result. On the fast scans the truncation bounds are max-reduced over the
ranks before the suspect rows are picked, and suspects are rescanned
through the exact sharded path. B5 serves each shard where the dispatch
rule holds on the shard's rows. The JAX searcher switches its fused
kernel off under a mesh and runs the XLA form of the same extraction
there; both give the same exact top-k, so the port keeps its hand kernel
on the sharded path.

The port is exact only: the JAX options `use_approx` (`lax.approx_max_k`)
and `compute_dtype` (bf16 products) are not ported.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.ops import topk

NEG_INF = topk.NEG_INF

QUERY_TILE = 4096  # query rows per scan (one B5 launch each)
REF_TILE = 8192  # ref columns per tile of the exact and the fast scan
EXTRACT_E = 16  # entries the fast scan surfaces per ref tile
FAST_SCAN_SCORES = 1 << 27  # f32 scores the fast scan holds at a time (512 MiB)
B5_MIN_REFS = 32768  # B5 serves corpora of at least this many rows
B5_TILE_R, B5_E = 1024, 4  # B5's ref block and entries per block


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tile_sims(q, refs, c0: int, width: int, num_valid: int):
    """[Tq, width] f32 products of q with ref columns c0 .. c0 + width
    (call under `topk.no_tf32`); columns past the corpus or at or past
    num_valid score float32 lowest."""
    sims = torch.full((q.shape[0], width), NEG_INF, device=q.device)
    c1 = min(refs.shape[0], c0 + width)
    sims[:, : c1 - c0] = q @ refs[c0:c1].float().t()
    if c0 + width > num_valid:
        sims[:, max(0, num_valid - c0):] = NEG_INF
    return sims


def _row_topk_exact(queries, refs, num_valid: int, k: int, ref_tile: int):
    """Per-row top-k of queries @ refs.T by a scan over ref tiles: f32
    products (TF32 off), a per-tile `torch.topk` and a running merge.
    Columns at or past num_valid score float32 lowest. (scores [Tq, k],
    indices [Tq, k] int64), sorted descending."""
    tq = queries.shape[0]
    device = queries.device
    q = queries.float()
    best_s = torch.full((tq, k), NEG_INF, device=device)
    best_i = torch.zeros((tq, k), dtype=torch.int64, device=device)
    with topk.no_tf32():
        for c0 in range(0, _round_up(refs.shape[0], ref_tile), ref_tile):
            sims = _tile_sims(q, refs, c0, ref_tile, num_valid)
            s, i = torch.topk(sims, min(k, ref_tile), dim=1)
            s = torch.cat([best_s, s], dim=1)
            i = torch.cat([best_i, i + c0], dim=1)
            best_s, pos = torch.topk(s, k, dim=1)
            best_i = torch.gather(i, 1, pos)
    return best_s, best_i


def _row_topk_fast(queries, refs, num_valid: int, k: int, ref_tile: int, e: int):
    """The fast scan of the JAX searcher (`_row_topk_impl` with extract_e):
    per ref tile only its top e entries, by an argmax peel that takes the
    lowest column first among equal scores, and bound [Tq], the max over
    tiles of the e-th, which bounds every entry not surfaced. Returns
    (scores [Tq, k], indices [Tq, k] int64, bound), the row top-k of the
    surfaced entries ranked (score desc, column asc); needs e * tiles >= k."""
    tq = queries.shape[0]
    device = queries.device
    q = queries.float()
    tiles = _round_up(refs.shape[0], ref_tile) // ref_tile
    # as many tiles at a time as FAST_SCAN_SCORES allows: the deeper rounds
    # scan few rows, and one tile at a time would be launch-bound
    per_chunk = max(1, FAST_SCAN_SCORES // (max(tq, 1) * ref_tile))
    surf_s = torch.empty((tq, tiles, e), device=device)
    surf_i = torch.empty((tq, tiles, e), dtype=torch.int64, device=device)
    with topk.no_tf32():
        for t0 in range(0, tiles, per_chunk):
            t1 = min(tiles, t0 + per_chunk)
            sims = _tile_sims(q, refs, t0 * ref_tile, (t1 - t0) * ref_tile, num_valid)
            sims = sims.view(tq, t1 - t0, ref_tile)
            base = ref_tile * torch.arange(t0, t1, device=device)
            for p in range(e):
                a = sims.argmax(dim=2, keepdim=True)  # the first maximum
                surf_s[:, t0:t1, p] = sims.gather(2, a)[..., 0]
                surf_i[:, t0:t1, p] = a[..., 0] + base
                sims.scatter_(2, a, -float("inf"))
    bound = surf_s[:, :, e - 1].amax(dim=1)
    s, pos = torch.sort(surf_s.view(tq, tiles * e), dim=1, descending=True, stable=True)
    return s[:, :k], torch.gather(surf_i.view(tq, tiles * e), 1, pos[:, :k]), bound


class SimilaritySearcher:
    """Reusable searcher over a fixed reference matrix held on `device`
    (the card unless the caller names another): whole, or with a `mesh`,
    this rank's rows along `mesh_axis`."""

    def __init__(self, refs: np.ndarray, device="cuda", transfer_dtype=np.float32, mesh=None,
                 mesh_axis: str = "data"):
        self.device = resolve(device)
        self.num_refs = int(refs.shape[0])
        self.dim = int(refs.shape[1])
        self.transfer_dtype = np.dtype(transfer_dtype)
        if self.transfer_dtype not in (np.float16, np.float32):
            raise TypeError(f"transfer_dtype {self.transfer_dtype}: float16 or float32")
        self.mesh, self.mesh_axis = mesh, mesh_axis
        # transfer_dtype=np.float16 halves the corpus on the device; the
        # products are still f32 of the shipped values.
        if mesh is None:
            self.base, self.local_valid = 0, self.num_refs
            self.shard_rows = _round_up(max(self.num_refs, 1), 128)
            rows = refs
        else:
            nd = mesh.shape[mesh_axis]
            self.shard_rows = _round_up(max(self.num_refs, 1), nd * 128) // nd
            self.base = mesh.index(mesh_axis) * self.shard_rows
            self.local_valid = min(max(self.num_refs - self.base, 0), self.shard_rows)
            rows = np.zeros((self.shard_rows, self.dim), self.transfer_dtype)
            rows[: self.local_valid] = refs[self.base : self.base + self.local_valid]
        self.ref_tile = self._pick_tile(self.shard_rows, REF_TILE)
        self.refs = torch.from_numpy(
            np.ascontiguousarray(rows, dtype=self.transfer_dtype)).to(self.device)

    @staticmethod
    def _pick_tile(rows: int, want: int) -> int:
        tile = min(want, rows)
        return tile if rows % tile == 0 else math.gcd(rows, tile)

    # ------------------------------------------------------------------
    def _fused_active(self, k_pad: int) -> bool:
        """Whether B5 serves this row_topk call: the JAX rule without its
        TPU-only terms (backend, lane width, bf16-split footprint), on the
        rows this device scans (a mesh's shard: the same on every rank)."""
        rows = self.num_refs if self.mesh is None else self.shard_rows
        if EXTRACT_E <= 0 or rows < B5_MIN_REFS:
            return False
        nb = _round_up(rows, B5_TILE_R) // B5_TILE_R
        # With e=4 per block, rows seeking k comparable to nb*e would fail
        # the certificate almost surely and rescan; 8x headroom keeps the
        # flag rate negligible for the global-budget searches.
        return nb * B5_E >= 8 * k_pad

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(rows, dtype=self.transfer_dtype)).to(self.device)

    # ------------------------------------------------------------------
    def row_topk(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact per-row top-k: (scores [Nq, k] f32, indices [Nq, k] int32),
        each row sorted descending (tie resolution aside, as any selection).

        The scan extracts only e entries per ref block and carries an exact
        per-row bound on everything it did not surface; rows whose bound
        reaches their k-th score, or whose k-th slot holds no real
        candidate, are rescanned through the exact per-tile path, all
        query tiles' together (the JAX searcher rescans tile by tile; the
        rows come out the same). With a mesh every rank passes the same
        queries and gets the same result."""
        nq = queries.shape[0]
        k_eff = max(1, min(k, self.num_refs))
        # k rounded up to a power of two, as the JAX searcher runs it: the
        # B5 rule and the fast-scan gate read this width.
        k_pad = 1 << (k_eff - 1).bit_length()
        use_fused = self._fused_active(k_pad)
        num_tiles = max(self.shard_rows // self.ref_tile, 1)
        # the fast scan can surface at most e * num_tiles entries per row
        # (per shard, when sharded: each shard contributes its own k)
        use_fast = EXTRACT_E > 0 and EXTRACT_E * num_tiles >= 2 * k_pad
        out_s = np.empty((nq, k_eff), np.float32)
        out_i = np.empty((nq, k_eff), np.int32)
        suspects = [np.zeros(0, np.int64)]
        for start in range(0, nq, QUERY_TILE):
            s, i, bound = self._scan(queries[start : start + QUERY_TILE], k_pad, use_fused,
                                     use_fast)
            s = s[:, :k_eff].cpu().numpy()
            i = i[:, :k_eff].cpu().numpy().astype(np.int32)
            if bound is not None:
                # Suspect rows: some unsurfaced entry could reach the found
                # k-th score, or the k-th slot was never filled.
                suspects.append(start + np.flatnonzero(
                    (bound.cpu().numpy() >= s[:, k_eff - 1]) | (s[:, k_eff - 1] <= NEG_INF / 2)))
            out_s[start : start + len(s)] = s
            out_i[start : start + len(s)] = i
        suspect = np.concatenate(suspects)
        for start in range(0, suspect.size, QUERY_TILE):
            rows = suspect[start : start + QUERY_TILE]
            es, ei, _ = self._scan(queries[rows], k_pad, False, False)
            out_s[rows] = es[:, :k_eff].cpu().numpy()
            out_i[rows] = ei[:, :k_eff].cpu().numpy()
        return out_s, out_i

    def _scan(self, rows: np.ndarray, k_pad: int, use_fused: bool, use_fast: bool):
        """(scores [Tq, k_pad], indices [Tq, k_pad] int64, bound [Tq] or None
        on the exact path) of one query tile over the corpus: B5, the fast
        scan or the exact path over this device's rows, merged over the
        mesh where there is one."""
        q = self._to_device(rows)
        if use_fused:
            s, i, bound = topk.extract_topk(q, self.refs, self.local_valid, e=B5_E,
                                            tile_r=B5_TILE_R, k=k_pad)
        elif use_fast:
            s, i, bound = _row_topk_fast(q, self.refs, self.local_valid, k_pad, self.ref_tile,
                                         EXTRACT_E)
        else:
            s, i = _row_topk_exact(q, self.refs, self.local_valid, k_pad, self.ref_tile)
            bound = None
        i = i.long()
        if self.mesh is None:
            return s, i, bound
        # Every rank's winners, re-reduced alike on every rank: a stable
        # sort keeps equal scores in shard order, then column order.
        axis = self.mesh_axis
        s_all = torch.cat(self.mesh.all_gather(s.contiguous(), axis), dim=1)
        i_all = torch.cat(self.mesh.all_gather(i + self.base, axis), dim=1)
        s, pos = torch.sort(s_all, dim=1, descending=True, stable=True)
        i = torch.gather(i_all, 1, pos[:, :k_pad])
        if bound is not None:
            # An unseen entry on any shard is bounded by that shard's bound,
            # and the merged k-th is no lower than any shard's k-th, so the
            # max over shards certifies the merged result.
            bound = self.mesh.all_reduce_(bound.contiguous(), axis, "max")
        return s[:, :k_pad], i, bound

    # ------------------------------------------------------------------
    def global_topk(
        self, queries: np.ndarray, global_k: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact global top-`global_k` entries of the Q x R similarity
        matrix: (q_idx, r_idx, score) sorted by descending score, length
        min(global_k, Nq * num_refs)."""
        nq = queries.shape[0]
        total = nq * self.num_refs
        k = min(global_k, total)
        if k <= 0:
            z = np.zeros((0,), np.int64)
            return z, z, np.zeros((0,), np.float32)

        m = min(self.num_refs, max(16, -(-2 * k // nq)))
        # One (rows, scores, indices) per scan depth. Each round rescans a
        # subset of the previous round's rows deeper, and a row's list is
        # the one of the last round that holds it. (The JAX searcher grows
        # one [nq, m] matrix per round instead; the result is the same.)
        rounds = [(np.arange(nq), *self.row_topk(queries, m))]

        while True:
            live = [~np.isin(rows, later[0]) for (rows, *_), later in zip(rounds, rounds[1:])]
            live.append(np.ones(len(rounds[-1][0]), bool))
            if k >= nq * m:
                tau = NEG_INF / 2
            else:
                # at least nq * m_0 >= 2k scores: the k-th is a real one
                flat = np.concatenate([s[lv].reshape(-1) for (_, s, _), lv in zip(rounds, live)])
                tau = np.partition(flat, flat.size - k)[flat.size - k]
            if m >= self.num_refs:
                break
            rows, scores, _ = rounds[-1]
            suspect = rows[scores[:, -1] > tau]
            if not suspect.size:
                break
            # Rows whose candidate list may be truncated above tau: rescan deeper.
            m = min(self.num_refs, m * 2)
            rounds.append((suspect, *self.row_topk(queries[suspect], m)))

        q_idx, r_idx, s, col = [], [], [], []
        for (rows, scores, indices), lv in zip(rounds, live):
            r, c = np.nonzero((scores >= tau) & lv[:, None])
            q_idx.append(rows[r])
            r_idx.append(indices[r, c])
            s.append(scores[r, c])
            col.append(c)
        q_idx = np.concatenate(q_idx).astype(np.int64)
        r_idx = np.concatenate(r_idx).astype(np.int64)
        s = np.concatenate(s)
        # by score, then row, then place in the row's list: the JAX order
        order = np.lexsort((np.concatenate(col), q_idx, -s))[:k]
        return q_idx[order], r_idx[order], s[order]

    # ------------------------------------------------------------------
    def threshold_search(
        self, queries: np.ndarray, threshold: float, k0: int = 1024
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All (row, col, score) with score > threshold (exact range search):
        k-NN at k0 per row, rows whose k-th hit still clears the threshold
        rescanned at a doubled k until exact."""
        nq = queries.shape[0]
        k = max(1, min(k0, self.num_refs))
        active = np.arange(nq, dtype=np.int64)
        rows_out: List[np.ndarray] = []
        cols_out: List[np.ndarray] = []
        scores_out: List[np.ndarray] = []
        while active.size:
            scores, indices = self.row_topk(queries[active], k)
            # Resolved rows emit their hits at once; only overflow rows are
            # rescanned, so peak memory is O(|overflow| * k).
            if k >= self.num_refs:
                overflow = np.zeros(active.size, bool)
            else:
                overflow = scores[:, -1] > threshold
            done = ~overflow
            if done.any():
                s, idx = scores[done], indices[done]
                hit = s > threshold
                rows_out.append(np.repeat(active[done], hit.sum(axis=1)))
                cols_out.append(idx[hit].astype(np.int64))
                scores_out.append(s[hit])
            active = active[overflow]
            k = min(self.num_refs, k * 2)
        if not rows_out:
            z = np.zeros((0,), np.int64)
            return z, z, np.zeros((0,), np.float32)
        rows = np.concatenate(rows_out)
        cols = np.concatenate(cols_out)
        s = np.concatenate(scores_out)
        order = np.argsort(rows, kind="stable")
        return rows[order], cols[order], s[order]


def knn_search(
    queries: np.ndarray, refs: np.ndarray, k: int, device="cuda", mesh=None
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot per-row k-NN (inner product). See `SimilaritySearcher.row_topk`."""
    return SimilaritySearcher(refs, device=device, mesh=mesh).row_topk(queries, k)


def global_topk_search(
    queries: np.ndarray, refs: np.ndarray, global_k: int, device="cuda", mesh=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot exact global top-k search. See `SimilaritySearcher.global_topk`."""
    return SimilaritySearcher(refs, device=device, mesh=mesh).global_topk(queries, global_k)


def video_pair_max_scores(
    q_features: np.ndarray,
    q_video_idx: np.ndarray,
    r_features: np.ndarray,
    r_video_idx: np.ndarray,
    n_q_videos: int,
    n_r_videos: int,
    row_chunk: int = 16384,
    device="cuda",
) -> np.ndarray:
    """Dense [n_q_videos, n_r_videos] matrix of max frame similarities.

    Block by block: an f32 product (TF32 off), then two `scatter_reduce`
    amax passes by ref video and by query video, folded into one running
    max on the device, so device memory stays one block and one
    [n_q_videos + 1, n_r_videos + 1] matrix whatever the corpus size.
    `*_video_idx` rows holding -1 (padding) go to a discard bucket. Pairs
    with no frames come back -inf.
    """
    device = resolve(device)
    pad_q = np.where(q_video_idx < 0, n_q_videos, q_video_idx).astype(np.int64)
    pad_r = np.where(r_video_idx < 0, n_r_videos, r_video_idx).astype(np.int64)
    qf = torch.from_numpy(np.ascontiguousarray(q_features, np.float32))
    rf = torch.from_numpy(np.ascontiguousarray(r_features, np.float32))
    out = torch.full((n_q_videos + 1, n_r_videos + 1), -float("inf"), device=device)
    with topk.no_tf32():
        for q0 in range(0, qf.shape[0], row_chunk):
            q = qf[q0 : q0 + row_chunk].to(device)
            q_seg = torch.from_numpy(pad_q[q0 : q0 + row_chunk]).to(device)
            for r0 in range(0, rf.shape[0], row_chunk):
                r = rf[r0 : r0 + row_chunk].to(device)
                r_seg = torch.from_numpy(pad_r[r0 : r0 + row_chunk]).to(device)
                sims = q @ r.t()  # [cq, cr]
                by_ref = torch.full((len(q), n_r_videos + 1), -float("inf"), device=device)
                by_ref.scatter_reduce_(1, r_seg.expand(len(q), -1), sims, "amax")
                out.scatter_reduce_(0, q_seg[:, None].expand(-1, n_r_videos + 1), by_ref, "amax")
    return out[:n_q_videos, :n_r_videos].cpu().numpy()
