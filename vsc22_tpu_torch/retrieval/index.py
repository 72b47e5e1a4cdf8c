"""Video-level retrieval index over the device searcher.

Counterpart of `vsc22_tpu/retrieval/index.py`. A positive ``global_k`` runs
the VSC-rules "global score budget" search (exact global top-k over all
query-frame x ref-frame pairs); a negative ``global_k`` runs plain
per-frame k-NN with k = -global_k. The searcher lives on `device`, the card
unless the caller names another.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from vsc22_tpu_torch.core.types import CandidatePair, PairMatch, PairMatches, VideoFeature
from vsc22_tpu_torch.retrieval.packed import PackedFeatures
from vsc22_tpu_torch.retrieval.search import SimilaritySearcher


class VideoIndex:
    """Inner-product index over per-frame descriptors of many videos."""

    def __init__(self, dim: int, device="cuda", transfer_dtype=None):
        self.dim = dim
        self.device = device
        self.transfer_dtype = transfer_dtype  # None -> searcher default (f32)
        self._videos: List[VideoFeature] = []
        self._packed: Optional[PackedFeatures] = None
        self._searcher: Optional[SimilaritySearcher] = None

    def add(self, db: List[VideoFeature]) -> None:
        for vf in db:
            if vf.dimensions() != self.dim:
                raise ValueError(
                    f"feature dim {vf.dimensions()} != index dim {self.dim}"
                )
        self._videos.extend(db)
        self._packed = None
        self._searcher = None

    def _ensure_built(self):
        if self._searcher is None:
            self._packed = PackedFeatures.from_video_features(self._videos)
            kw = {}
            if self.transfer_dtype is not None:
                kw["transfer_dtype"] = self.transfer_dtype
            self._searcher = SimilaritySearcher(
                self._packed.features[: self._packed.num_rows], device=self.device, **kw
            )
        return self._packed, self._searcher

    def _search_rows(self, queries: List[VideoFeature], global_k: int):
        packed_refs, searcher = self._ensure_built()
        packed_q = PackedFeatures.from_video_features(queries)
        q_feats = packed_q.features[: packed_q.num_rows]

        if global_k < 0:
            scores, indices = searcher.row_topk(q_feats, -global_k)
            nq, k = scores.shape
            q_rows = np.repeat(np.arange(nq, dtype=np.int64), k)
            r_rows = indices.reshape(-1).astype(np.int64)
            s = scores.reshape(-1)
        else:
            q_rows, r_rows, s = searcher.global_topk(q_feats, global_k)
        return packed_q, packed_refs, q_rows, r_rows, s

    def search(self, queries: List[VideoFeature], global_k: int) -> List[PairMatches]:
        """Search all query frames; group frame matches by (query, ref) video."""
        packed_q, packed_refs, q_rows, r_rows, s = self._search_rows(queries, global_k)
        return self._group_matches(packed_q, packed_refs, q_rows, r_rows, s)

    def search_max_aggregated(
        self, queries: List[VideoFeature], global_k: int, limit: Optional[int] = None
    ) -> List[CandidatePair]:
        """Search + max-aggregate per video pair, vectorized: the same result
        as MaxScoreAggregation over `search()` without one PairMatch per
        frame hit. Candidates sorted by descending score; only the first
        `limit` are built, where given."""
        packed_q, packed_refs, q_rows, r_rows, s = self._search_rows(queries, global_k)
        q_vid = packed_q.video_idx[q_rows].astype(np.int64)
        r_vid = packed_refs.video_idx[r_rows].astype(np.int64)
        keys = q_vid * len(packed_refs.video_ids) + r_vid
        unique_keys, inverse = np.unique(keys, return_inverse=True)
        best = np.full(len(unique_keys), -np.inf, np.float32)
        np.maximum.at(best, inverse, s.astype(np.float32))
        order = np.argsort(-best, kind="stable")[:limit]
        uq = unique_keys[order]
        nrv = len(packed_refs.video_ids)
        # ids looked up in bulk: the budget search yields millions of pairs
        q_ids = np.asarray(packed_q.video_ids, dtype=object)[uq // nrv]
        r_ids = np.asarray(packed_refs.video_ids, dtype=object)[uq % nrv]
        return list(map(CandidatePair, q_ids.tolist(), r_ids.tolist(), best[order].tolist()))

    @staticmethod
    def _group_matches(
        packed_q: PackedFeatures,
        packed_r: PackedFeatures,
        q_rows: np.ndarray,
        r_rows: np.ndarray,
        scores: np.ndarray,
    ) -> List[PairMatches]:
        q_vid = packed_q.video_idx[q_rows]
        q_frame = packed_q.frame_idx[q_rows]
        r_vid = packed_r.video_idx[r_rows]
        r_frame = packed_r.frame_idx[r_rows]

        pair_nns: Dict[Tuple[int, int], List[PairMatch]] = defaultdict(list)
        for qv, qf, rv, rf, sc in zip(q_vid, q_frame, r_vid, r_frame, scores):
            match = PairMatch(
                query_timestamps=packed_q.get_timestamps(qv, qf),
                ref_timestamps=packed_r.get_timestamps(rv, rf),
                score=float(sc),
            )
            pair_nns[(int(qv), int(rv))].append(match)

        return [
            PairMatches(packed_q.video_ids[qv], packed_r.video_ids[rv], matches)
            for (qv, rv), matches in pair_nns.items()
        ]


class ScoreAggregation(ABC):
    @abstractmethod
    def aggregate(self, match: PairMatches) -> float:
        ...

    def score(self, match: PairMatches) -> CandidatePair:
        return CandidatePair(
            query_id=match.query_id, ref_id=match.ref_id, score=self.aggregate(match)
        )


class MaxScoreAggregation(ScoreAggregation):
    """Video-pair score = max over its frame-level match scores."""

    def aggregate(self, match: PairMatches) -> float:
        return float(max(m.score for m in match.matches))


class CandidateGeneration:
    """refs -> index; queries -> ranked CandidatePair list."""

    def __init__(
        self,
        references: List[VideoFeature],
        aggregation: ScoreAggregation,
        device="cuda",
        transfer_dtype=None,
    ):
        self.aggregation = aggregation
        self.index = VideoIndex(
            references[0].dimensions(), device=device, transfer_dtype=transfer_dtype
        )
        self.index.add(references)

    def query(
        self, queries: List[VideoFeature], global_k: int, limit: Optional[int] = None
    ) -> List[CandidatePair]:
        """Ranked candidates, the first `limit` of them where given (the
        budget search yields millions of video pairs; a caller that keeps
        the best few need not build the rest)."""
        if isinstance(self.aggregation, MaxScoreAggregation):
            return self.index.search_max_aggregated(queries, global_k, limit)
        matches = self.index.search(queries, global_k=global_k)
        candidates = [self.aggregation.score(m) for m in matches]
        return sorted(candidates, key=lambda c: c.score, reverse=True)[:limit]
