"""Matching-track inference, stages 3-6.

Counterpart of `vsc22_tpu/pipelines/matching_infer.py` (reference
M1/infer/infer_matching.py:60-293). Stage 1 (descriptors) is
`pipelines.batch_query.BatchedQueryPipeline` with `ved=None`; stage 2 is
query score-norm at beta 1.5, nk 10 (`retrieval.score_norm`). Here:
  3. recall: every (query, ref) video pair with a frame similarity above
     SEARCH_THRESHOLD = -0.1, scored by its max, sorted descending;
  4. classify filter: 160x160 padded sim images (+ transposes) through a
     2-fold MobileNetV3-Small ensemble; keep pairs with max prob > 0.0005;
  5. SAM refine: 224x224 padded sims through a 2-fold HRNet ensemble with
     transpose test-time augmentation, one probability heatmap per pair;
  6. decode at three (threshold, std_ratio) settings, union by max score.

Stages 3-5 run on `device` (the card unless the caller names another):
recall's products and per-pair maxima, the sim images
(`matching.simmat.DeviceSimBuilder`), both ensembles and their merges.
Only the RANSAC decode and the candidate bookkeeping stay on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vsc22_tpu_torch.core.device import resolve
from vsc22_tpu_torch.core.types import VideoFeature
from vsc22_tpu_torch.matching.decode import generate_matching_result
from vsc22_tpu_torch.matching.simmat import (
    DeviceSimBuilder,
    candidate_sim_matrices,
    select_best_split_segment,
)
from vsc22_tpu_torch.retrieval.packed import PackedFeatures
from vsc22_tpu_torch.retrieval.search import SimilaritySearcher, video_pair_max_scores

SEARCH_THRESHOLD = -0.1
MATCH_CLS_THRESHOLD = 0.0005
CLS_RESOLUTION = 160
REFINE_RESOLUTION = 224
DECODE_SETTINGS = ((0.35, 0.5), (0.1, 1.25), (0.001, 2.0))
DENSE_PAIR_LIMIT = 32 * 1024 * 1024  # largest |Q| x |R| recall aggregates densely


def _l2(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def recall_candidates(
    sn_queries: List[VideoFeature],
    sn_refs: List[VideoFeature],
    threshold: float = SEARCH_THRESHOLD,
    device="cuda",
) -> List[Tuple[str, str, float]]:
    """Stage 3: every (query, ref) video pair with any frame sim > threshold,
    scored by its max frame similarity, sorted descending (stably).

    Up to DENSE_PAIR_LIMIT pairs, the [|Q|, |R|] matrix of per-pair maxima
    comes from the products and two segment-max passes on the device
    (`video_pair_max_scores`); past it, the per-frame hit list of the exact
    threshold search is aggregated on the host."""
    packed_refs = PackedFeatures.from_video_features(sn_refs)
    packed_q = PackedFeatures.from_video_features(sn_queries)
    vq, vr = len(packed_q.video_ids), len(packed_refs.video_ids)
    if vq * vr <= DENSE_PAIR_LIMIT:
        mat = video_pair_max_scores(
            packed_q.features, packed_q.video_idx,
            packed_refs.features, packed_refs.video_idx, vq, vr, device=device,
        )
        qi, ri = np.nonzero(mat > threshold)
        s = mat[qi, ri]
        order = np.argsort(-s, kind="stable")
        return [
            (packed_q.video_ids[int(qi[o])], packed_refs.video_ids[int(ri[o])], float(s[o]))
            for o in order
        ]
    searcher = SimilaritySearcher(packed_refs.features[: packed_refs.num_rows], device=device)
    rows, cols, scores = searcher.threshold_search(
        packed_q.features[: packed_q.num_rows], threshold
    )
    if len(cols) == 0:
        return []
    q_vid = packed_q.video_idx[rows].astype(np.int64)
    r_vid = packed_refs.video_idx[cols].astype(np.int64)
    keys = q_vid * vr + r_vid
    uniq, inv = np.unique(keys, return_inverse=True)
    best = np.full(uniq.shape[0], -np.inf, np.float64)
    np.maximum.at(best, inv, scores)
    uq, ur = np.divmod(uniq, vr)
    out = [
        (packed_q.video_ids[int(a)], packed_refs.video_ids[int(b)], float(s))
        for a, b, s in zip(uq, ur, best)
    ]
    out.sort(key=lambda t: -t[2])
    return out


def _three_channels(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W] planes -> [B, H, W, 3] float32, the plane broadcast to the
    three identical channels the models were trained on."""
    return images.float()[..., None].expand(*images.shape, 3)


@dataclasses.dataclass
class ClassifyEnsemble:
    """k-fold MobileNetV3 candidate filter over padded sim-matrix images:
    the mean over folds of each model's class-1 softmax probability."""

    models: Sequence[torch.nn.Module]
    resolution: int = CLS_RESOLUTION
    batch: int = 256
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve(self.device)

    @torch.no_grad()
    def _probs(self, images: torch.Tensor) -> torch.Tensor:
        x = _three_channels(images)
        return torch.stack(
            [torch.softmax(m(x), dim=1)[:, 1] for m in self.models]).mean(dim=0)

    def predict(self, sim_mats: Sequence[np.ndarray]) -> np.ndarray:
        """Host path: each matrix zero-padded into a float16 plane (sims lie
        in [-1, 1]), shipped per batch of `batch`."""
        n = len(sim_mats)
        probs = np.zeros(n, np.float32)
        for start in range(0, n, self.batch):
            chunk = sim_mats[start : start + self.batch]
            block = np.zeros((self.batch, self.resolution, self.resolution), np.float16)
            for j, s in enumerate(chunk):
                h = min(s.shape[0], self.resolution)
                w = min(s.shape[1], self.resolution)
                block[j, :h, :w] = s[:h, :w]
            p = self._probs(torch.from_numpy(block).to(self.device))
            probs[start : start + len(chunk)] = p[: len(chunk)].cpu().numpy()
        return probs

    def predict_device(self, chunks) -> Tuple[np.ndarray, np.ndarray]:
        """Probabilities for `DeviceSimBuilder.images` chunks: each chunk's
        images join their transposes in one forward, and every chunk is
        launched before any is fetched. Returns (probs of the images [N],
        probs of their transposes [N]) in the pairs' order."""
        pending = [
            (self._probs(torch.cat([imgs, imgs.transpose(1, 2)])), n) for imgs, _, n in chunks
        ]
        po, pt = [], []
        for p, n in pending:
            p = p.cpu().numpy()
            c = p.shape[0] // 2
            po.append(p[:c][:n])
            pt.append(p[c:][:n])
        empty = np.zeros((0,), np.float32)
        return (np.concatenate(po) if po else empty, np.concatenate(pt) if pt else empty)


@dataclasses.dataclass
class RefineEnsemble:
    """k-fold SAM-HRNet heatmaps with transpose test-time augmentation: each
    fold runs the images and their transposes as one batch, and the merge
    ((p + pt^T).mean(folds) / 2, float32) happens on the device."""

    models: Sequence[torch.nn.Module]
    resolution: int = REFINE_RESOLUTION
    batch: int = 16
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve(self.device)

    @torch.no_grad()
    def _merged(self, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        both = _three_channels(torch.cat([images, images.transpose(1, 2)]))
        probs = torch.stack([torch.softmax(m(both), dim=-1)[..., 1] for m in self.models])
        p, pt = probs[:, :b], probs[:, b:].transpose(2, 3)
        return ((p + pt).mean(dim=0) / 2.0).float()

    def predict(
        self, meta: Sequence[Tuple[str, str, np.ndarray, np.ndarray]]
    ) -> List[Tuple[str, str, np.ndarray, np.ndarray]]:
        """Host path. meta rows: (qid, rid, qfeat, rfeat); returns (qid, rid,
        prob_map, raw_sim) with maps cropped back to the true sim shape."""
        out = []
        for start in range(0, len(meta), self.batch):
            chunk = meta[start : start + self.batch]
            sims = [q @ r.T for _, _, q, r in chunk]
            images = np.zeros((self.batch, self.resolution, self.resolution), np.float16)
            for j, s in enumerate(sims):
                h = min(s.shape[0], self.resolution)
                w = min(s.shape[1], self.resolution)
                images[j, :h, :w] = s[:h, :w]
            acc = self._merged(torch.from_numpy(images).to(self.device)).cpu().numpy()
            for i, (qid, rid, qf, rf) in enumerate(chunk):
                h = min(qf.shape[0], self.resolution)
                w = min(rf.shape[0], self.resolution)
                out.append((qid, rid, acc[i, :h, :w], sims[i][:h, :w]))
        return out

    def predict_device(
        self, builder: DeviceSimBuilder, pairs: Sequence[Tuple[str, str]]
    ) -> List[Tuple[str, str, np.ndarray, np.ndarray]]:
        """Heatmaps from sim images built on the device (`DeviceSimBuilder`):
        the [224, 224] inputs never exist on the host. Every chunk is
        launched before any is fetched."""
        chunks = builder.images(pairs, self.resolution, chunk=self.batch)
        pending = [(self._merged(imgs), imgs, offs, n) for imgs, offs, n in chunks]
        out = []
        idx = 0
        for merged, imgs, offs, n in pending:
            acc = merged.cpu().numpy()
            raw = imgs.cpu().numpy()
            chunk_pairs = pairs[idx : idx + n]
            hw = builder.crop_hw(chunk_pairs, self.resolution, offs[:n].cpu().numpy())
            for i, ((qid, rid), (h, w)) in enumerate(zip(chunk_pairs, hw)):
                out.append((qid, rid, acc[i, :h, :w], raw[i, :h, :w]))
            idx += n
        return out


def matching_inference(
    queries: List[VideoFeature],
    refs: List[VideoFeature],
    sn_queries: List[VideoFeature],
    sn_refs: List[VideoFeature],
    query_video_len_map: Dict[str, int],
    classify: ClassifyEnsemble,
    refine: RefineEnsemble,
    cls_threshold: float = MATCH_CLS_THRESHOLD,
    cls_keep_fraction: float = None,
    max_candidates: int = None,
    timer=None,
    use_device_sims: bool = None,
    device="cuda",
) -> List[List]:
    """Stages 3-6. Returns match rows
    [query_id, ref_id, query_start, query_end, ref_start, ref_end, score].

    `cls_keep_fraction` additionally keeps only the top fraction of the
    candidate pairs by classify probability (a load setting for untrained
    filters, whose threshold alone selects nothing); `max_candidates` cuts
    the recall list. `timer.stage(name)` contexts, where a timer is given,
    wrap the stages `recall`, `pack_descriptors`, `classify_simmats`,
    `classify_predict`, `refine` and `decode`. The sim images are built on
    `device` unless `use_device_sims` is False or a query has more than
    `simmat.MAX_SEGS` FSD segments (then on the host, as in JAX).
    """
    device = resolve(device)
    stage = timer.stage if timer is not None else (lambda _: contextlib.nullcontext())

    with stage("recall"):
        candidates = recall_candidates(sn_queries, sn_refs, device=device)
        if max_candidates is not None:
            candidates = candidates[:max_candidates]

    query_map = {v.video_id: _l2(v.feature) for v in queries}
    ref_map = {v.video_id: _l2(v.feature) for v in refs}

    builder = None
    if use_device_sims is not False:
        with stage("pack_descriptors"):
            builder = DeviceSimBuilder(query_map, ref_map, query_video_len_map, device=device)
            if not builder.usable():
                builder = None

    # Stage 4: classify filter (sim + transpose per candidate).
    best_prob: Dict[Tuple[str, str], float] = {}
    if builder is not None:
        with stage("classify_simmats"):
            chunks = builder.images([(q, r) for q, r, _ in candidates], classify.resolution,
                                    chunk=max(classify.batch // 2, 1))
        with stage("classify_predict"):
            po, pt = classify.predict_device(chunks)
        for (qid, rid, _), p1, p2 in zip(candidates, po, pt):
            key = (qid, rid)
            best_prob[key] = max(best_prob.get(key, 0.0), float(p1), float(p2))
    else:
        with stage("classify_simmats"):
            feats, infos = candidate_sim_matrices(
                query_map, ref_map, candidates, query_video_len_map)
        with stage("classify_predict"):
            probs = classify.predict(feats)
        for (qid, rid, _), p in zip(infos, probs):
            key = (qid, rid)
            best_prob[key] = max(best_prob.get(key, 0.0), float(p))
    selected = [(q, r, p) for (q, r), p in best_prob.items() if p > cls_threshold]
    if cls_keep_fraction is not None and selected:
        keep_n = max(1, int(cls_keep_fraction * len(best_prob)))
        selected = sorted(selected, key=lambda t: -t[2])[:keep_n]

    # Stage 5: SAM refinement.
    with stage("refine"):
        if builder is not None:
            refined = refine.predict_device(builder, [(qid, rid) for qid, rid, _ in selected])
        else:
            refined = refine.predict([
                (qid, rid,
                 select_best_split_segment(query_map[qid], ref_map[rid],
                                           query_video_len_map[qid]),
                 ref_map[rid])
                for qid, rid, _ in selected
            ])

    # Stage 6: decode at three operating points; union by max score.
    with stage("decode"):
        best: Dict[Tuple, float] = {}
        for threshold, std_ratio in DECODE_SETTINGS:
            for qid, rid, qs, rs, qe, re, score in generate_matching_result(
                refined, threshold=threshold, std_ratio=std_ratio
            ):
                key = (qid, rid, float(qs), float(qe), float(rs), float(re))
                best[key] = max(best.get(key, -np.inf), score)
    return [[qid, rid, qs, qe, rs, re, score] for (qid, rid, qs, qe, rs, re), score in best.items()]
