"""Frame stores: the native record store and the jpg-zip layout.

Counterpart of `vsc22_tpu/data/store.py`, in the same file formats, so
that a store written by either package reads in the other:
  - the record store, one file: the magic `VSCREC01`, a u64 record count
    N, N + 1 u64 offsets into the payload, the payload (see
    `csrc/recordstore.cpp`), with a sidecar `<store>.meta.npz` holding
    `vids` and `intervals` (each video's [start, end) record range);
  - per-video zips of '%07d.jpg' frames under `<root>/<id[-2:]>/<id>.zip`.

`RecordStore` reads through the host library `csrc/recordstore.cpp`
(mmap'd, GIL-free batch reads), built with g++ at first use by
`kernels/build.host_library`. Where the library cannot be built or the
file cannot be opened it raises: the JAX class's quiet numpy fallback is
`NumpyRecordReader` here, the plain version that only the tests read
with. Frames are JPEG bytes, coded by `data/frames.encode_jpeg` and
`decode_jpeg` (OpenCV).
"""

from __future__ import annotations

import ctypes
import os
import struct
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vsc22_tpu_torch.data.frames import decode_jpeg, encode_jpeg

MAGIC = b"VSCREC01"

_I64, _PTR = ctypes.c_int64, ctypes.c_void_p
# entry point -> (restype, argtypes)
_SIGNATURES = {
    "rs_open": (_PTR, [ctypes.c_char_p]),
    "rs_close": (None, [_PTR]),
    "rs_num_records": (_I64, [_PTR]),
    "rs_record_size": (_I64, [_PTR, _I64]),
    "rs_read": (_I64, [_PTR, _I64, _PTR, _I64]),
    "rs_read_batch": (_I64, [_PTR, _PTR, _I64, _PTR, _PTR, ctypes.c_int]),
}


def library() -> ctypes.CDLL:
    """The record store's host library, built first if needed; raises if
    it cannot be built."""
    from vsc22_tpu_torch.kernels import build

    lib = build.host_library("recordstore")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


class RecordStoreWriter:
    """Streams records into the store file; call close() to finalize."""

    def __init__(self, path: str):
        self.path = path
        self._tmp_payload = open(path + ".payload.tmp", "wb")
        self._offsets: List[int] = [0]

    def append(self, data: bytes) -> int:
        self._tmp_payload.write(data)
        self._offsets.append(self._offsets[-1] + len(data))
        return len(self._offsets) - 2

    def close(self) -> None:
        self._tmp_payload.close()
        count = len(self._offsets) - 1
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", count))
            f.write(np.asarray(self._offsets, np.uint64).tobytes())
            with open(self.path + ".payload.tmp", "rb") as payload:
                while True:
                    chunk = payload.read(1 << 22)
                    if not chunk:
                        break
                    f.write(chunk)
        os.remove(self.path + ".payload.tmp")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordStore:
    """Read-only record store through the native library."""

    def __init__(self, path: str):
        self.path = path
        self._lib = library()
        self._handle = self._lib.rs_open(path.encode())
        if not self._handle:
            raise ValueError(f"{path} cannot be opened as a record store")
        self._count = int(self._lib.rs_num_records(self._handle))

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, i: int) -> bytes:
        if not 0 <= i < self._count:
            raise IndexError(i)
        size = self._lib.rs_record_size(self._handle, i)
        buf = ctypes.create_string_buffer(size)
        got = self._lib.rs_read(self._handle, i, buf, size)
        if got != size:
            raise IOError(f"short read for record {i}")
        return buf.raw

    def read_batch(self, indices: Sequence[int], num_threads: int = 4) -> List[bytes]:
        """The records at `indices`, copied by the library's thread pool."""
        indices = np.asarray(indices, np.int64)
        sizes = np.asarray(
            [self._lib.rs_record_size(self._handle, int(i)) for i in indices], np.int64
        )
        if (sizes < 0).any():
            raise IndexError("record index out of range")
        out_offsets = np.zeros(len(indices), np.int64)
        np.cumsum(sizes[:-1], out=out_offsets[1:])
        out = np.empty(int(sizes.sum()), np.uint8)
        rc = self._lib.rs_read_batch(
            self._handle,
            indices.ctypes.data_as(ctypes.c_void_p),
            len(indices),
            out.ctypes.data_as(ctypes.c_void_p),
            out_offsets.ctypes.data_as(ctypes.c_void_p),
            num_threads,
        )
        if rc != len(indices):
            raise IOError("batch read failed")
        return [out[o : o + s].tobytes() for o, s in zip(out_offsets, sizes)]

    def close(self):
        if self._handle:
            self._lib.rs_close(self._handle)
            self._handle = None

    @property
    def using_native(self) -> bool:
        """Always True: this reader has only the native route (the plain
        one, `NumpyRecordReader`, is for the tests)."""
        return True


class NumpyRecordReader:
    """The plain version of `RecordStore`: the same reads through a numpy
    memmap (the JAX class's fallback). Only the tests use it."""

    def __init__(self, path: str):
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        if bytes(raw[:8]) != MAGIC:
            raise ValueError(f"{path} is not a record store")
        (count,) = struct.unpack("<Q", bytes(raw[8:16]))
        self._count = int(count)
        self._offsets = np.frombuffer(raw[16 : 16 + 8 * (count + 1)].tobytes(), np.uint64)
        self._payload = raw[16 + 8 * (count + 1) :]

    def __len__(self) -> int:
        return self._count

    def __getitem__(self, i: int) -> bytes:
        if not 0 <= i < self._count:
            raise IndexError(i)
        start, end = int(self._offsets[i]), int(self._offsets[i + 1])
        return self._payload[start:end].tobytes()

    def read_batch(self, indices: Sequence[int], num_threads: int = 4) -> List[bytes]:
        return [self[int(i)] for i in np.asarray(indices, np.int64)]


class FrameStore:
    """Video-aware layer over a RecordStore: meta maps vid -> [start, end)."""

    def __init__(self, store_path: str, meta_path: Optional[str] = None):
        self.store = RecordStore(store_path)
        meta_path = meta_path or store_path + ".meta.npz"
        self._paths = (store_path, meta_path)
        meta = np.load(meta_path, allow_pickle=False)
        self.vids = [str(v) for v in meta["vids"]]
        self.intervals = meta["intervals"].astype(np.int64)
        self.vid_to_interval: Dict[str, Tuple[int, int]] = {
            v: (int(s), int(e)) for v, (s, e) in zip(self.vids, self.intervals)
        }

    def __reduce__(self):
        """Pickles as its paths and reopens where it is unpickled (a spawned
        loader worker), since the mapping cannot travel."""
        return FrameStore, self._paths

    def num_frames(self, vid: str) -> int:
        s, e = self.vid_to_interval[vid]
        return e - s

    def get_frame_bytes(self, vid: str, frame: int) -> bytes:
        s, e = self.vid_to_interval[vid]
        if not 0 <= frame < e - s:
            raise IndexError(f"{vid}[{frame}]")
        return self.store[s + frame]

    def get_frame(self, vid: str, frame: int) -> np.ndarray:
        """Frame `frame` of `vid`, RGB uint8 [H, W, 3]."""
        return decode_jpeg(self.get_frame_bytes(vid, frame))

    @staticmethod
    def build(
        store_path: str,
        videos: Sequence[Tuple[str, Sequence[bytes]]],
        meta_path: Optional[str] = None,
    ) -> "FrameStore":
        """Write (vid, [jpeg bytes...]) streams into a new store + meta."""
        vids, intervals = [], []
        with RecordStoreWriter(store_path) as w:
            cursor = 0
            for vid, frames in videos:
                start = cursor
                for data in frames:
                    w.append(data)
                    cursor += 1
                vids.append(vid)
                intervals.append((start, cursor))
        write_meta(meta_path or store_path + ".meta.npz", vids, intervals)
        return FrameStore(store_path, meta_path)


def write_meta(path: str, vids: Sequence[str], intervals: Sequence[Tuple[int, int]]) -> None:
    """The sidecar index of a frame store: `vids` and their [start, end)."""
    np.savez(path, vids=np.asarray(vids), intervals=np.asarray(intervals, np.int64))


class ZipFrameStore:
    """Per-video jpg zips, reference layout: <root>/<id[-2:]>/<id>.zip."""

    def __init__(self, root: str):
        self.root = Path(root)

    def path_for(self, vid: str) -> Path:
        return self.root / vid[-2:] / f"{vid}.zip"

    def write_video(self, vid: str, frames: Sequence[np.ndarray], quality: int = 90):
        path = self.path_for(vid)
        path.parent.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(path, "w") as zf:
            for i, frame in enumerate(frames):
                zf.writestr(f"{i:07d}.jpg", encode_jpeg(frame, quality))

    def read_video(self, vid: str) -> List[np.ndarray]:
        with zipfile.ZipFile(self.path_for(vid), "r") as zf:
            return [decode_jpeg(zf.read(name)) for name in sorted(zf.namelist())]

    def has_video(self, vid: str) -> bool:
        return self.path_for(vid).exists()
