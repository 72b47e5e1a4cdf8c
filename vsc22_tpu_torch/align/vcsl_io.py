"""VCSL-style dataset IO: keyed readers/writers + item/pair datasets.

Counterpart of `vsc22_tpu/align/vcsl_io.py`, a copy (host code; cv2 is
imported only where an image is read or written).

Parity target (reference, for cross-checking — original implementation):
  D1/infer/vcsl/utils/ioutil.py:16-285 — a (store_type, data_type) reader/
  writer registry (local|oss x bytes|image|numpy|json) plus an async
  writer pool; D1/infer/vcsl/datasets.py:15-112 — ItemDataset (uuid ->
  file read), PairDataset (pair list or query x gallery product, row-major)
  and ImageItemDataset (transform chain).

Only the LOCAL store is implemented: the reference's OSS (Aliyun object
store) client has no counterpart here and is unused in the inference
path. Datasets are plain sequence objects (len/indexing).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "build_reader",
    "build_writer",
    "ItemDataset",
    "PairDataset",
    "ImageItemDataset",
    "AsyncWriter",
]


# ---------------------------------------------------------------------------
# Readers / writers (local store; data types: bytes | image | numpy | json)
# ---------------------------------------------------------------------------


class _BytesIO:
    @staticmethod
    def read(path: str):
        with open(path, "rb") as f:
            return f.read()

    @staticmethod
    def write(path: str, data) -> None:
        with open(path, "wb") as f:
            f.write(data)


class _ImageIO:
    """BGR uint8 arrays via cv2 (the reference's convention)."""

    @staticmethod
    def read(path: str):
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"unreadable image: {path}")
        return img

    @staticmethod
    def write(path: str, data) -> None:
        import cv2

        if not cv2.imwrite(path, data):
            raise IOError(f"failed to write image: {path}")


class _NumpyIO:
    @staticmethod
    def read(path: str):
        return np.load(path, allow_pickle=False)

    @staticmethod
    def write(path: str, data) -> None:
        np.save(path, np.asarray(data))


class _JsonIO:
    @staticmethod
    def read(path: str):
        with open(path, "r") as f:
            return json.load(f)

    @staticmethod
    def write(path: str, data) -> None:
        with open(path, "w") as f:
            json.dump(data, f)


_DATA_TYPES = {
    "bytes": _BytesIO,
    "image": _ImageIO,
    "numpy": _NumpyIO,
    "json": _JsonIO,
}


def _resolve(store_type: str, data_type: str):
    if store_type != "local":
        raise NotImplementedError(
            f"store_type={store_type!r}: only 'local' is supported (the "
            "reference's 'oss' object-store client is deliberately omitted)"
        )
    try:
        return _DATA_TYPES[data_type]
    except KeyError:
        raise ValueError(
            f"data_type={data_type!r}; expected one of {sorted(_DATA_TYPES)}"
        ) from None


def build_reader(store_type: str = "local", data_type: str = "bytes", **_):
    return _resolve(store_type, data_type).read


def build_writer(store_type: str = "local", data_type: str = "bytes", **_):
    return _resolve(store_type, data_type).write


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


class ItemDataset:
    """(uuid, file) list -> (uuid, loaded value) by index."""

    def __init__(
        self,
        data_list: Sequence[Tuple[str, str]],
        root: str = "",
        store_type: str = "local",
        data_type: str = "bytes",
        trans_key_func: Callable[[str], str] = lambda x: x,
        **kwargs,
    ):
        self.uuids, self.files = zip(*data_list) if data_list else ((), ())
        self.root = root
        self.trans_key_func = trans_key_func
        self.read = build_reader(store_type, data_type, **kwargs)

    def _path(self, key: str) -> str:
        path = self.trans_key_func(key)
        return os.path.join(self.root, path) if self.root else path

    def __getitem__(self, idx: int) -> Tuple[str, Any]:
        return self.uuids[idx], self.read(self._path(self.files[idx]))

    def __len__(self) -> int:
        return len(self.files)


class PairDataset:
    """(query_id, gallery_id, query value, gallery value) by index.

    Either an explicit `pair_list` + `file_dict` (id -> file), or the
    row-major product of `query_list` x `gallery_list` (both (id, file)
    sequences) — the reference's two modes (datasets.py:71-91).
    """

    def __init__(
        self,
        query_list: Optional[Sequence[Tuple[str, str]]] = None,
        gallery_list: Optional[Sequence[Tuple[str, str]]] = None,
        pair_list: Optional[Sequence[Tuple[str, str]]] = None,
        file_dict: Optional[Dict[str, str]] = None,
        root: str = "",
        store_type: str = "local",
        data_type: str = "bytes",
        trans_key_func: Callable[[str], str] = lambda x: x,
        **kwargs,
    ):
        self.query_list = query_list
        self.gallery_list = gallery_list
        self.pair_list = pair_list
        self.file_dict = file_dict
        self.root = root
        self.trans_key_func = trans_key_func
        self.read = build_reader(store_type, data_type, **kwargs)

    def _path(self, key: str) -> str:
        path = self.trans_key_func(key)
        return os.path.join(self.root, path) if self.root else path

    def __getitem__(self, idx: int) -> Tuple[str, str, Any, Any]:
        if self.pair_list:
            qid, gid = self.pair_list[idx]
            qfile, gfile = self.file_dict[qid], self.file_dict[gid]
        else:
            i, j = divmod(idx, len(self.gallery_list))
            qid, qfile = self.query_list[i]
            gid, gfile = self.gallery_list[j]
        return qid, gid, self.read(self._path(qfile)), self.read(self._path(gfile))

    def __len__(self) -> int:
        if self.pair_list:
            return len(self.pair_list)
        return len(self.query_list) * len(self.gallery_list)


class ImageItemDataset(ItemDataset):
    def __init__(
        self,
        data_list: Sequence[Tuple[str, str]],
        root: str = "",
        transforms: Optional[List[Callable]] = None,
        store_type: str = "local",
        **kwargs,
    ):
        super().__init__(
            data_list, root=root, store_type=store_type, data_type="image", **kwargs
        )
        self.transforms = transforms

    def __getitem__(self, idx: int):
        key, value = super().__getitem__(idx)
        for t in self.transforms or ():
            value = t(value)
        return key, value


# ---------------------------------------------------------------------------
# Async writer pool
# ---------------------------------------------------------------------------


class AsyncWriter:
    """Queue-fed writer pool (reference ioutil.py:253-285). Threads, not
    processes: the writes are IO-bound, and a forked process would inherit
    the parent's CUDA context."""

    _EOF = (None, None)

    def __init__(self, pool_size: int, store_type: str = "local",
                 data_type: str = "bytes", **config):
        self.write = build_writer(store_type=store_type, data_type=data_type, **config)
        self.in_queue: "queue.Queue" = queue.Queue()

        def worker_loop():
            while True:
                path, data = self.in_queue.get()
                if path is None and data is None:
                    break
                self.write(path, data)

        self.workers = [
            threading.Thread(target=worker_loop, daemon=True)
            for _ in range(pool_size)
        ]
        for w in self.workers:
            w.start()

    def consume(self, item: Tuple[str, Any]) -> None:
        self.in_queue.put(item)

    def stop(self) -> None:
        for _ in self.workers:
            self.in_queue.put(self._EOF)
        for w in self.workers:
            w.join()
