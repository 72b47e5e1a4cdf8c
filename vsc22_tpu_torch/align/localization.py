"""Localization glue: CandidatePair -> Match via temporal alignment.

Counterpart of `vsc22_tpu/align/localization.py`. The per-pair similarity
maps are small host products of the two videos' frame descriptors; the
alignment (TN, `align/vta.py`) runs on the host, in worker processes when
asked.
"""

from __future__ import annotations

import abc
from typing import List

import numpy as np

from vsc22_tpu_torch.align.vta import build_vta_model
from vsc22_tpu_torch.core.types import CandidatePair, Match, VideoFeature


class Localization(abc.ABC):
    @abc.abstractmethod
    def localize(self, candidate: CandidatePair) -> List[Match]:
        ...

    def localize_all(self, candidates: List[CandidatePair]) -> List[Match]:
        matches = []
        for candidate in candidates:
            matches.extend(self.localize(candidate))
        return matches


class LocalizationWithMetadata(Localization):
    def __init__(self, queries: List[VideoFeature], refs: List[VideoFeature]):
        self.queries = {m.video_id: m for m in queries}
        self.refs = {m.video_id: m for m in refs}

    def similarity(self, candidate: CandidatePair) -> np.ndarray:
        a = self.queries[candidate.query_id].feature
        b = self.refs[candidate.ref_id].feature
        return np.matmul(a, b.T)


class VCSLLocalization(LocalizationWithMetadata):
    def __init__(self, queries, refs, model_type: str, similarity_bias: float = 0.0, **kwargs):
        super().__init__(queries, refs)
        self.model = build_vta_model(model_type, **kwargs)
        self.similarity_bias = similarity_bias

    def similarity(self, candidate: CandidatePair) -> np.ndarray:
        """Optional positive bias: some aligners dislike negative sims."""
        return super().similarity(candidate) + self.similarity_bias

    def localize_all(self, candidates: List[CandidatePair]) -> List[Match]:
        sims = [(f"{c.query_id}-{c.ref_id}", self.similarity(c)) for c in candidates]
        results = self.model.forward_sim(sims)
        assert len(results) == len(candidates)
        matches = []
        for candidate, (key, sim), result in zip(candidates, sims, results):
            query = self.queries[candidate.query_id]
            ref = self.refs[candidate.ref_id]
            assert key == result[0]
            for box in result[1]:
                x1, y1, x2, y2 = box
                match = Match(
                    query_id=candidate.query_id,
                    ref_id=candidate.ref_id,
                    query_start=query.get_timestamps(x1)[0],
                    query_end=query.get_timestamps(x2)[1],
                    ref_start=ref.get_timestamps(y1)[0],
                    ref_end=ref.get_timestamps(y2)[1],
                    score=0.0,
                )
                matches.append(match._replace(score=self.score(candidate, match, box, sim)))
        return matches

    def localize(self, candidate: CandidatePair) -> List[Match]:
        return self.localize_all([candidate])

    def score(self, candidate: CandidatePair, match: Match, box, similarity) -> float:
        return 1.0


class VCSLLocalizationMaxSim(VCSLLocalization):
    """Score = max similarity inside the box, minus the additive bias."""

    def score(self, candidate: CandidatePair, match: Match, box, similarity) -> float:
        x1, y1, x2, y2 = box
        return float(similarity[x1:x2, y1:y2].max() - self.similarity_bias)


class VCSLLocalizationCandidateScore(VCSLLocalization):
    """Score = the retrieval candidate's aggregated pair score."""

    def score(self, candidate: CandidatePair, match: Match, box, similarity) -> float:
        return candidate.score
