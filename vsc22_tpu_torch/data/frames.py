"""Video decode: fixed-rate frame sampling.

Counterpart of `vsc22_tpu/data/frames.py`, with the same backends in the
same order: an `ffmpeg` binary when one is on the PATH (the reference's
`-r fps` resampling), else OpenCV's `cv2.VideoCapture` (nearest-timestamp
selection). Both import OpenCV lazily (ffmpeg's JPEGs are read with
`cv2.imread`), so the rest of the port needs no OpenCV. Frames are RGB
uint8 [H, W, 3].

A video that fails to decode or times out gives `[]` and the caller skips
it, as in the JAX package. Where no backend exists at all, `read_frames`
raises `RuntimeError` instead: the JAX function's catch-all would turn a
missing decoder into an empty corpus.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np


def ffmpeg_binary() -> Optional[str]:
    return shutil.which("ffmpeg")


def _cv2():
    """OpenCV, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def read_frames_opencv(
    path: str, fps: float = 1.0, max_frames: int = 100000, timeout_s: float = 60.0
) -> List[np.ndarray]:
    """Sample frames at `fps` by nearest-timestamp selection (RGB uint8)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return []
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    if native_fps <= 0:
        native_fps = 25.0
    step = native_fps / fps
    frames: List[np.ndarray] = []
    next_pick = 0.0
    idx = 0
    deadline = time.monotonic() + timeout_s
    try:
        while len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if idx >= round(next_pick):
                frames.append(frame[:, :, ::-1].copy())
                next_pick += step
            idx += 1
            if time.monotonic() > deadline:
                return []
    finally:
        cap.release()
    return frames


def read_frames_ffmpeg(path: str, fps: float = 1.0, timeout_s: float = 60.0) -> List[np.ndarray]:
    """ffmpeg subprocess resample to `fps` (the reference decode path)."""
    import cv2

    binary = ffmpeg_binary()
    if binary is None:
        raise RuntimeError("ffmpeg binary not available")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [binary, "-nostdin", "-y", "-i", path, "-r", str(fps), f"{tmp}/%07d.jpg"]
        try:
            subprocess.run(cmd, capture_output=True, timeout=timeout_s, check=True)
        except (subprocess.TimeoutExpired, subprocess.CalledProcessError):
            return []
        frames = []
        for p in sorted(Path(tmp).glob("*.jpg")):
            img = cv2.imread(str(p))
            if img is not None:
                frames.append(img[:, :, ::-1].copy())
        return frames


def available_backends() -> List[str]:
    """The backends this machine can run, in the order `read_frames` tries
    them: "ffmpeg" (needs the binary and OpenCV to read its JPEGs), then
    "opencv"."""
    if _cv2() is None:
        return []
    return (["ffmpeg"] if ffmpeg_binary() is not None else []) + ["opencv"]


def read_frames(
    path: str,
    fps: float = 1.0,
    backend: Optional[str] = None,
    timeout_s: float = 60.0,
) -> List[np.ndarray]:
    """Decode `path` at `fps`; an empty list when this video fails (skip
    semantics). Raises `RuntimeError` when no backend exists."""
    backends = available_backends()
    if not backends:
        raise RuntimeError(
            "no video decoder: read_frames needs an ffmpeg binary on the PATH or "
            "OpenCV (cv2), and this machine has neither"
        )
    if backend is None:
        backend = backends[0]
    if backend not in backends:
        raise RuntimeError(f"decode backend {backend!r} is not available here: {backends}")
    try:
        if backend == "ffmpeg":
            return read_frames_ffmpeg(path, fps, timeout_s)
        return read_frames_opencv(path, fps, timeout_s=timeout_s)
    except Exception:
        return []
