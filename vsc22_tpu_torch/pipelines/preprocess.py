"""Video discovery for the offline pipelines.

Counterpart of the discovery half of `vsc22_tpu/pipelines/preprocess.py`:
`VIDEO_EXTENSIONS` and `discover_videos`. Its frame store
(`build_frame_store`) comes with the port's data layer (`data/store.py`).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

VIDEO_EXTENSIONS = (".mp4", ".mkv", ".avi", ".mov", ".webm")


def discover_videos(videos_dir: str) -> List[Tuple[str, str]]:
    """(stem, path) of every video file under `videos_dir`, sorted by path."""
    out = []
    for p in sorted(Path(videos_dir).rglob("*")):
        if p.suffix.lower() in VIDEO_EXTENSIONS:
            out.append((p.stem, str(p)))
    return out
