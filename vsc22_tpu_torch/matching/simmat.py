"""Similarity-matrix construction for the matching track.

Counterpart of `vsc22_tpu/matching/simmat.py` (reference contract
M1/infer/src/utils.py:20-75):
  - when FSD split a query into k segments (len(qfeat) = k * num_frames),
    keep the segment whose top-10 max similarities to the ref are highest;
  - each candidate contributes its sim matrix and the transpose;
  - classify inputs are zero-padded square images, refine inputs 224x224.

Two implementations of the same contract:
  - host functions (`select_best_split_segment`, `candidate_sim_matrices`,
    `pad_sim_matrix`): the reference's per-pair numpy arithmetic, kept as
    the semantics oracle;
  - `DeviceSimBuilder`: the serving path. Descriptors are packed once into
    two matrices on the device; per chunk of candidate pairs, batched torch
    ops gather both videos' rows, take the pair products (`bmm`), replay
    the split-segment selection (per-row max -> per-segment top-10 mean ->
    argmax) and emit the zero-padded square images, so the host ships only
    index arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.ops.topk import no_tf32


def select_best_split_segment(
    qfeat: np.ndarray, rfeat: np.ndarray, num_frames: int
) -> np.ndarray:
    """Pick the FSD split segment with the highest mean of top-10 max sims."""
    if num_frames == len(qfeat):
        return qfeat
    sim_mat = qfeat @ rfeat.T
    best_score, best = -np.inf, qfeat[:num_frames]
    for start in range(0, len(qfeat), num_frames):
        maxs = np.sort(sim_mat[start : start + num_frames].max(axis=1))
        score = maxs[-10:].mean()
        if score > best_score:
            best_score, best = score, qfeat[start : start + num_frames]
    return best


def candidate_sim_matrices(
    query: Dict[str, np.ndarray],
    ref: Dict[str, np.ndarray],
    candidates: Sequence[Tuple[str, str, float]],
    query_video_len_map: Dict[str, int],
) -> Tuple[List[np.ndarray], List[List]]:
    """Per candidate: (sim matrix, transposed sim matrix) + info rows."""
    features: List[np.ndarray] = []
    infos: List[List] = []
    for qid, rid, score in candidates:
        qfeat = select_best_split_segment(query[qid], ref[rid], query_video_len_map[qid])
        sim = qfeat @ ref[rid].T
        features.append(sim)
        infos.append([qid, rid, score])
        features.append(sim.T.copy())
        infos.append([qid, rid, score])
    return features, infos


def pad_sim_matrix(sim: np.ndarray, size: int, channels: int = 3) -> np.ndarray:
    """Zero-pad/truncate to [size, size, channels] (matrix stacked as channels)."""
    out = np.zeros((size, size, channels), np.float32)
    h = min(sim.shape[0], size)
    w = min(sim.shape[1], size)
    out[:h, :w, :] = sim[:h, :w, None]
    return out


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------

MAX_SEGS = 8  # FSD yields <= 4 scene streams in practice; 8 is headroom
_NEG = -1e30


def _bucket(x: int) -> int:
    """Power-of-two size bucket (>= 128), as the JAX builder sizes its
    programs: the images and offsets do not depend on it."""
    return max(128, 1 << (max(x, 1) - 1).bit_length())


def _pair_images(packed_q, packed_r, q_off, q_len, q_nf, r_off, r_len, *, res: int, fq: int,
                 fr: int):
    """Per candidate pair: gather rows, product, segment-select, emit image.

    packed_q / packed_r: [*, D] float32 descriptors on the device; the
    index vectors [B] int64 on the same device. Returns (images [B, res,
    res] float32, seg_offsets [B] int64), each image
    `pad_sim_matrix(select_best_split_segment(q, r) @ r.T, res)` of its
    pair."""
    dev = packed_q.device
    # fq covers the longest query; `res` more rows keep the slice in bounds.
    rows = torch.arange(fq + res, device=dev)
    qi = q_off[:, None] + rows
    qmask = qi < (q_off + q_len)[:, None]
    zero = torch.zeros((), device=dev)
    q = torch.where(qmask[..., None], packed_q[qi.clamp(0, packed_q.shape[0] - 1)], zero)
    ri = r_off[:, None] + torch.arange(fr, device=dev)
    rmask = ri < (r_off + r_len)[:, None]
    r = torch.where(rmask[..., None], packed_r[ri.clamp(0, packed_r.shape[0] - 1)], zero)
    with no_tf32():
        sims = torch.bmm(q, r.transpose(1, 2))  # [B, fq + res, fr]

    # Split-segment selection over the full ref axis (the reference takes
    # each row's max over every ref frame, not the truncated window).
    rowmax = sims.masked_fill(~rmask[:, None, :], _NEG).amax(dim=2)
    seg = rows[None, :] // q_nf.clamp(min=1)[:, None]
    valid_row = rows[None, :] < q_len[:, None]
    segs = torch.arange(MAX_SEGS, device=dev)
    in_seg = (seg[:, None, :] == segs[None, :, None]) & valid_row[:, None, :]
    vals = torch.where(in_seg, rowmax[:, None, :], torch.tensor(_NEG, device=dev))
    top = vals.topk(10, dim=2).values  # [B, MAX_SEGS, 10]
    finite = top > _NEG / 2
    n = finite.sum(dim=2).clamp(min=1)
    scores = torch.where(finite, top, zero).sum(dim=2) / n
    scores = torch.where(finite.any(dim=2), scores, torch.tensor(_NEG, device=dev))
    best = scores.argmax(dim=1)  # the first maximum, as jnp.argmax
    offset = best * q_nf  # single-segment videos give best == 0

    irow = torch.arange(res, device=dev)
    img = sims.gather(1, (offset[:, None] + irow)[:, :, None].expand(-1, -1, fr))[:, :, :res]
    row_ok = (offset[:, None] + irow < q_len[:, None]) & (irow[None, :] < q_nf[:, None])
    col_ok = irow[None, :] < r_len[:, None]
    return torch.where(row_ok[:, :, None] & col_ok[:, None, :], img, zero), offset


class DeviceSimBuilder:
    """Packed descriptors + batched candidate image construction on `device`.

    Built once per `matching_inference` call from the L2-normalized feature
    maps; `images()` then serves any candidate list at any resolution.
    `usable()` is False when a query has more than `MAX_SEGS` FSD segments:
    the caller then takes the host path, as the JAX pipeline does.
    """

    def __init__(
        self,
        query: Dict[str, np.ndarray],
        ref: Dict[str, np.ndarray],
        query_video_len_map: Dict[str, int],
        chunk: int = 32,
        device="cuda",
    ):
        self.chunk = chunk
        self.device = resolve(device)

        def pack(feats: Dict[str, np.ndarray]):
            ids = list(feats)
            lens = np.array([feats[v].shape[0] for v in ids], np.int64)
            offs = np.zeros(len(ids), np.int64)
            if len(ids) > 1:
                offs[1:] = np.cumsum(lens)[:-1]
            mat = (
                np.concatenate([feats[v] for v in ids], axis=0)
                if ids else np.zeros((1, 1), np.float32)
            )
            mat = torch.from_numpy(np.ascontiguousarray(mat, np.float32)).to(self.device)
            return mat, offs, lens, {v: i for i, v in enumerate(ids)}

        self.q_mat, self.q_off, self.q_len, self.q_index = pack(query)
        self.r_mat, self.r_off, self.r_len, self.r_index = pack(ref)
        self.q_nf = np.array(
            [max(int(query_video_len_map.get(v, self.q_len[i])), 1)
             for v, i in self.q_index.items()],
            np.int64,
        )
        self.fq = _bucket(int(self.q_len.max()) if self.q_len.size else 1)
        self.fr = _bucket(int(self.r_len.max()) if self.r_len.size else 1)

    def usable(self) -> bool:
        if self.q_len.size == 0:
            return True
        segs = -(-self.q_len // np.maximum(self.q_nf, 1))
        return int(segs.max()) <= MAX_SEGS

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def images(
        self, pairs: Sequence[Tuple[str, str]], res: int, chunk: int = None
    ) -> List[Tuple[torch.Tensor, torch.Tensor, int]]:
        """Image chunks for the pairs, in order: (imgs [chunk, res, res]
        float32, seg_offsets [chunk], n) on the device. Every chunk keeps
        the `chunk` batch size (tails padded with pair 0's indices, `n`
        marks the valid prefix), as the JAX builder's fixed program shape
        does; valid prefixes concatenate to the host path's per-pair
        `pad_sim_matrix` outputs."""
        chunk = chunk or self.chunk
        qi = np.array([self.q_index[q] for q, _ in pairs], np.int64)
        ri = np.array([self.r_index[r] for _, r in pairs], np.int64)
        fr = max(self.fr, _bucket(res))
        out = []
        for s in range(0, len(pairs), chunk):
            qs, rs = qi[s : s + chunk], ri[s : s + chunk]
            n = len(qs)
            if n < chunk:
                qs = np.concatenate([qs, np.zeros(chunk - n, np.int64)])
                rs = np.concatenate([rs, np.zeros(chunk - n, np.int64)])
            imgs, offs = _pair_images(
                self.q_mat, self.r_mat,
                self._to_device(self.q_off[qs]), self._to_device(self.q_len[qs]),
                self._to_device(self.q_nf[qs]),
                self._to_device(self.r_off[rs]), self._to_device(self.r_len[rs]),
                res=res, fq=self.fq, fr=fr,
            )
            out.append((imgs, offs, n))
        return out

    def crop_hw(self, pairs: Sequence[Tuple[str, str]], res: int, seg_offsets: np.ndarray):
        """(h, w) of each pair's true (untruncated) sim shape: h the rows of
        the selected segment (a partial trailing segment can be shorter than
        num_frames), both capped at `res`."""
        out = []
        for (q, r), off in zip(pairs, np.asarray(seg_offsets)):
            nf = int(self.q_nf[self.q_index[q]])
            ql = int(self.q_len[self.q_index[q]])
            seg_rows = max(min(nf, ql - int(off)), 0)
            out.append((min(seg_rows, res), min(int(self.r_len[self.r_index[r]]), res)))
        return out
