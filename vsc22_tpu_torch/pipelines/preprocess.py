"""Offline preprocessing: videos -> 1-fps frame store (+ optional jpg zips).

Counterpart of `vsc22_tpu/pipelines/preprocess.py`: decode every video
at `fps` with a per-video timeout (`data/frames.read_frames`; a video that
fails is skipped), and pack its frames as JPEGs into a record store with a
vid -> [start, end) interval index (`data/store.py`), the training data
layer's input. `discover_videos` also serves the offline CLIs.

Usage:
  python -m vsc22_tpu_torch.pipelines.preprocess --videos DIR --store out.rec \
      [--fps 1] [--jpg_zips DIR] [--workers 8]
"""

from __future__ import annotations

import argparse
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vsc22_tpu_torch.data.frames import encode_jpeg, read_frames
from vsc22_tpu_torch.data.store import FrameStore, RecordStoreWriter, ZipFrameStore, write_meta
from vsc22_tpu_torch.utils.hostmem import tune_host_allocator

logger = logging.getLogger("preprocess")

VIDEO_EXTENSIONS = (".mp4", ".mkv", ".avi", ".mov", ".webm")


def encode_jpegs(frames: Sequence[np.ndarray], quality: int = 90) -> List[bytes]:
    """RGB uint8 frames as JPEG bytes."""
    return [encode_jpeg(f, quality) for f in frames]


def build_frame_store(
    video_paths: Sequence[Tuple[str, str]],
    store_path: str,
    fps: float = 1.0,
    workers: int = 8,
    timeout_s: float = 60.0,
    jpg_zip_root: Optional[str] = None,
    quality: int = 90,
) -> FrameStore:
    """Decode `(vid, path)` pairs in parallel and write the record store.

    Videos that fail to decode are skipped (reference contract). Store order
    follows the input order of the videos that succeeded.
    """
    zip_store = ZipFrameStore(jpg_zip_root) if jpg_zip_root else None

    def decode(item):
        vid, path = item
        frames = read_frames(path, fps=fps, timeout_s=timeout_s)
        if not frames:
            logger.warning("skipping %s (decode failed/empty)", vid)
            return vid, None
        if zip_store is not None:
            zip_store.write_video(vid, frames, quality)
        return vid, encode_jpegs(frames, quality)

    vids, intervals = [], []
    with RecordStoreWriter(store_path) as writer:
        cursor = 0
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for vid, jpegs in pool.map(decode, video_paths):
                if jpegs is None:
                    continue
                start = cursor
                for data in jpegs:
                    writer.append(data)
                    cursor += 1
                vids.append(vid)
                intervals.append((start, cursor))
    write_meta(store_path + ".meta.npz", vids, intervals)
    return FrameStore(store_path)


def discover_videos(videos_dir: str) -> List[Tuple[str, str]]:
    """(stem, path) of every video file under `videos_dir`, sorted by path."""
    out = []
    for p in sorted(Path(videos_dir).rglob("*")):
        if p.suffix.lower() in VIDEO_EXTENSIONS:
            out.append((p.stem, str(p)))
    return out


def main(argv=None):
    tune_host_allocator()
    parser = argparse.ArgumentParser()
    parser.add_argument("--videos", required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--fps", type=float, default=1.0)
    parser.add_argument("--jpg_zips", default=None)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--timeout", type=float, default=60.0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    videos = discover_videos(args.videos)
    logger.info("found %d videos", len(videos))
    store = build_frame_store(
        videos,
        args.store,
        fps=args.fps,
        workers=args.workers,
        timeout_s=args.timeout,
        jpg_zip_root=args.jpg_zips,
    )
    logger.info("store built: %d videos, %d frames", len(store.vids), len(store.store))
    return store


if __name__ == "__main__":
    main()
