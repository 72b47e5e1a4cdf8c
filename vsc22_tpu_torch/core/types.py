"""Host-side data types of the query and eval paths.

A copy of `vsc22_tpu/core/types.py`: `VideoMetadata`, `VideoFeature`,
`Dataset`, `format_video_id`, `PairMatch`, `PairMatches`, `CandidatePair`,
`Axis` and `Match`. The port keeps its own copy so that importing it loads
nothing of the JAX package (whose `__init__` also tunes the host allocator).
The JAX copy writes and reads CSV through pandas; this one uses the stdlib
`csv` module, with the same schema, column order and id formatting, so
files written by either package read back identically in the other
(`tests/test_torch_eval.py`). `tests/test_torch_import.py` holds the two
copies to the same fields and checks.
"""

from __future__ import annotations

import csv
import dataclasses
import enum
import math
from typing import Collection, Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np


class Dataset(enum.Enum):
    """Which corpus a video belongs to; used to prefix integer ids."""

    QUERIES = "Q"
    REFS = "R"


def format_video_id(video_id: Union[str, int], dataset: Optional[Dataset]) -> str:
    """Render a video id as the canonical 'Q000123' / 'R000456' string form.

    Integer ids require a dataset to supply the prefix; string ids are
    validated against the dataset prefix when one is given.
    """
    if isinstance(video_id, (int, np.integer)):
        if dataset is None:
            raise ValueError("integer video_id needs a Dataset to supply its prefix")
        return f"{dataset.value}{int(video_id):06d}"
    video_id = str(video_id)
    if dataset is not None and not video_id.startswith(dataset.value):
        raise ValueError(f"video id {video_id!r} does not belong to dataset {dataset}")
    return video_id


def _csv_video_id(cell: str, dataset: Dataset) -> str:
    """A CSV id cell as `format_video_id` sees it after pandas' parse: a
    cell of digits is an integer id."""
    cell = cell.strip()
    return format_video_id(int(cell) if cell.isdigit() else cell, dataset)


def _csv_float(cell: str) -> float:
    return float(cell) if cell.strip() else math.nan


def _read_rows(file) -> List[Dict[str, str]]:
    if hasattr(file, "read"):
        return list(csv.DictReader(file))
    with open(file, newline="") as f:
        return list(csv.DictReader(f))


def _write_rows(file, header: List[str], rows: Iterable[list]) -> None:
    def write(f):
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)

    if hasattr(file, "write"):
        write(file)
    else:
        with open(file, "w", newline="") as f:
            write(f)


@dataclasses.dataclass
class VideoMetadata:
    """Identity + per-frame timestamps of one video's descriptor sequence.

    ``timestamps`` is either shape [N] (an instant per descriptor) or [N, 2]
    (start/end spans per descriptor).
    """

    video_id: str
    timestamps: np.ndarray

    def __len__(self) -> int:
        return int(self.timestamps.shape[0])

    def get_timestamps(self, idx: int) -> Tuple[float, float]:
        t = self.timestamps[idx]
        if self.timestamps.ndim == 1:
            return (float(t), float(t))
        return (float(t[0]), float(t[1]))


@dataclasses.dataclass
class VideoFeature(VideoMetadata):
    """Per-video descriptor matrix [N, D] plus its metadata."""

    feature: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.feature.shape[0] != len(self.timestamps):
            raise ValueError(
                f"feature rows ({self.feature.shape[0]}) != timestamps "
                f"({len(self.timestamps)}) for video {self.video_id}"
            )

    def metadata(self) -> VideoMetadata:
        return VideoMetadata(video_id=self.video_id, timestamps=self.timestamps)

    def dimensions(self) -> int:
        return int(self.feature.shape[1])


class PairMatch(NamedTuple):
    """One frame-level match between a query frame and a reference frame."""

    query_timestamps: Tuple[float, float]
    ref_timestamps: Tuple[float, float]
    score: float


@dataclasses.dataclass
class PairMatches:
    """All frame-level matches for one (query video, ref video) pair."""

    query_id: str
    ref_id: str
    matches: List[PairMatch]

    def records(self) -> Iterable[Dict]:
        for m in self.matches:
            yield {
                "query_id": self.query_id,
                "ref_id": self.ref_id,
                "query_start": m.query_timestamps[0],
                "query_end": m.query_timestamps[1],
                "ref_start": m.ref_timestamps[0],
                "ref_end": m.ref_timestamps[1],
                "score": m.score,
            }


@dataclasses.dataclass
class CandidatePair:
    """A scored (query video, ref video) retrieval candidate."""

    query_id: str
    ref_id: str
    score: float

    # --- CSV interop (schema: query_id,ref_id,score) ---

    @classmethod
    def write_csv(cls, candidates: Collection["CandidatePair"], file) -> None:
        _write_rows(
            file, ["query_id", "ref_id", "score"],
            ([format_video_id(c.query_id, Dataset.QUERIES),
              format_video_id(c.ref_id, Dataset.REFS), repr(float(c.score))]
             for c in candidates),
        )

    @classmethod
    def read_csv(cls, file) -> List["CandidatePair"]:
        return [
            CandidatePair(
                query_id=_csv_video_id(row["query_id"], Dataset.QUERIES),
                ref_id=_csv_video_id(row["ref_id"], Dataset.REFS),
                score=_csv_float(row["score"]),
            )
            for row in _read_rows(file)
        ]

    @classmethod
    def from_matches(cls, matches: Collection["Match"]) -> List["CandidatePair"]:
        """Collapse segment matches to pair candidates by max score."""
        best: Dict[Tuple[str, str], float] = {}
        for m in matches:
            key = (m.query_id, m.ref_id)
            best[key] = max(m.score, best.get(key, float("-inf")))
        return [CandidatePair(q, r, s) for (q, r), s in best.items()]


class Axis(enum.Enum):
    """The two time axes of a match: query time and reference time."""

    QUERY = enum.auto()
    REF = enum.auto()


class Match(NamedTuple):
    """A ground-truth or predicted copied segment (spans on both axes)."""

    query_id: str
    ref_id: str
    score: float
    query_start: float
    query_end: float
    ref_start: float
    ref_end: float

    def pair_id(self) -> Tuple[str, str]:
        return (self.query_id, self.ref_id)

    def interval(self, axis: "Axis") -> Tuple[float, float]:
        if axis == Axis.QUERY:
            return (self.query_start, self.query_end)
        return (self.ref_start, self.ref_end)

    def intersection_area(self, other: "Match") -> float:
        qi = min(self.query_end, other.query_end) - max(self.query_start, other.query_start)
        ri = min(self.ref_end, other.ref_end) - max(self.ref_start, other.ref_start)
        return max(qi, 0.0) * max(ri, 0.0)

    def overlaps(self, other: "Match") -> bool:
        return self.intersection_area(other) > 0.0

    # --- CSV interop (column order matches the submission schema) ---

    _CSV_COLUMNS = ("query_id", "ref_id", "query_start", "query_end", "ref_start", "ref_end",
                    "score")

    @classmethod
    def write_csv(cls, matches: Collection["Match"], file) -> None:
        _write_rows(
            file, list(cls._CSV_COLUMNS),
            ([m.query_id, m.ref_id] + [repr(float(getattr(m, c))) for c in cls._CSV_COLUMNS[2:]]
             for m in matches),
        )

    @classmethod
    def read_csv(cls, file, is_gt: bool = False, check: bool = True) -> List["Match"]:
        out = []
        for row in _read_rows(file):
            rec = {
                "query_id": _csv_video_id(row["query_id"], Dataset.QUERIES),
                "ref_id": _csv_video_id(row["ref_id"], Dataset.REFS),
            }
            for field in cls._fields[2:]:
                rec[field] = 1.0 if field == "score" and is_gt else _csv_float(row[field])
            if check:
                for field in cls._fields[2:]:
                    if math.isnan(rec[field]):
                        raise ValueError(f"NaN in column {field}")
            out.append(Match(**rec))
        return out
