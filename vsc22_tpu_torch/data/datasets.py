"""Training datasets: frame-pair samplers over the frame store, and loaders.

Counterpart of `vsc22_tpu/data/datasets.py`, sample for sample: the same
draws from the same `np.random.Generator` in the same order, so that a
seed gives the same batches in both packages.
  - `FramePairDataset`: each sample is ONE frame seen through two views,
    a "hard" pipeline for the query view (one of two, by `probs`) and the
    "easy" one for the key view (the reference's VideoLmdbDataSet);
  - `LabeledFramePairDataset`: for videos in the matching ground truth,
    temporally aligned (query, ref) frames from a random tenth of the
    annotated span; annotated and Q-prefixed frames get only the light
    "native" pipeline (LabelVideoLmdbDataSet);
  - `FeatureSequenceDataset`: per-video feature sequences padded to
    max_frames with a "has any GT match" label, for video-score training;
  - `OverlayImagePairDataset` (DISC-style overlay pairs) and
    `ConcatDataset`.

`_resize_norm_host` calls OpenCV's INTER_CUBIC resize exactly as the JAX
module does (on uint8, IPP's route where OpenCV takes it), so that the
trainer sees the same pixels.

The loaders replace torch's DataLoader + DistributedSampler: the epoch's
order is a (seed, epoch)-seeded permutation that every process draws
alike, each taking its (process_index, process_count) stride. `DataLoader`
collates in threads (each worker's generator seeded by (seed, epoch,
worker id); which worker takes which batch depends on timing, so its
batches are reproducible with one worker only); `ProcessDataLoader` in
spawned processes, worker w taking batches w::num_workers, reproducible
at any worker count.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import cv2
import numpy as np

from vsc22_tpu_torch.data.augment import (
    build_easy_pipeline,
    build_hard_pipelines,
    build_native_pipeline,
)
from vsc22_tpu_torch.data.store import FrameStore
from vsc22_tpu_torch.data.presets import PRESETS


def _resize_norm_host(img: np.ndarray, width: int, preset: str) -> np.ndarray:
    """Host-side final transform: resize + normalize (matches device op)."""
    mean, std = PRESETS[preset]
    x = cv2.resize(img, (width, width), interpolation=cv2.INTER_CUBIC)
    x = x.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


class FramePairDataset:
    """Self-supervised pair sampler: one frame, hard view + easy view."""

    def __init__(
        self,
        store: FrameStore,
        width: int = 256,
        preset: str = "vit",
        vids: Optional[Sequence[str]] = None,
        probs: Tuple[float, float] = (0.8, 0.2),
        crop: float = 0.8,
        mixup: float = 0.1,
        frame_source=None,
    ):
        self.store = store
        self.width = width
        self.preset = preset
        vids = list(vids) if vids else list(store.vids)
        self.vid_index: List[Tuple[str, int]] = []
        for vid in vids:
            for f in range(store.num_frames(vid)):
                self.vid_index.append((vid, f))
        self.vid_ordinal = {vid: i for i, vid in enumerate(vids)}
        if frame_source is None:
            frame_source = self._random_frame
        self.hard_pipelines = build_hard_pipelines(width, crop, mixup, frame_source)
        self.hard_probs = probs
        self.easy_pipeline = build_easy_pipeline(width, crop)
        self.native_pipeline = build_native_pipeline(width, crop)

    def _random_frame(self, rng: np.random.Generator) -> Optional[np.ndarray]:
        vid, f = self.vid_index[int(rng.integers(len(self.vid_index)))]
        return self.store.get_frame(vid, f)

    def __len__(self) -> int:
        return len(self.vid_index)

    def transform_q(self, img: np.ndarray, rng) -> np.ndarray:
        pipe = self.hard_pipelines[
            int(rng.choice(len(self.hard_pipelines), p=self.hard_probs))
        ]
        return _resize_norm_host(pipe(img, rng), self.width, self.preset)

    def transform_k(self, img: np.ndarray, rng) -> np.ndarray:
        return _resize_norm_host(self.easy_pipeline(img, rng), self.width, self.preset)

    def transform_n(self, img: np.ndarray, rng) -> np.ndarray:
        return _resize_norm_host(self.native_pipeline(img, rng), self.width, self.preset)

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        vid, frame = self.vid_index[idx]
        img = self.store.get_frame(vid, frame)
        return dict(
            img_a=self.transform_q(img, rng),
            img_b=self.transform_k(img, rng),
            vid_a=self.vid_ordinal[vid],
            vid_b=self.vid_ordinal[vid],
        )


class LabeledFramePairDataset(FramePairDataset):
    """Adds supervised temporally-aligned pairs from matching ground truth.

    annotations: rows (query_id, ref_id, q_start, q_end, r_start, r_end) in
    seconds (frame indices at 1 fps).
    """

    def __init__(self, store: FrameStore, annotations: Sequence[Sequence], **kwargs):
        super().__init__(store, **kwargs)
        self.ann: Dict[str, List] = {}
        known = set(store.vids)
        for row in annotations:
            q_id, r_id = str(row[0]), str(row[1])
            if q_id in known and r_id in known:
                self.ann.setdefault(q_id, []).append(row)
                self.ann.setdefault(r_id, []).append(row)

    def sample_ann_frames(self, row, rng) -> Tuple[Tuple[str, int], Tuple[str, int]]:
        """A (query, ref) frame pair from one random tenth of the GT span."""
        q_vid, r_vid, q_start, q_end, r_start, r_end = row[:6]
        bin_idx = int(rng.integers(10))
        q_bins = np.round(np.linspace(q_start, q_end, 11)).astype(np.int64)
        r_bins = np.round(np.linspace(r_start, r_end, 11)).astype(np.int64)
        q_lo, q_hi = int(q_bins[bin_idx]), int(q_bins[bin_idx + 1])
        r_lo, r_hi = int(r_bins[bin_idx]), int(r_bins[bin_idx + 1])
        q_idx = int(rng.integers(q_lo, q_hi + 1)) if q_lo < q_hi else q_lo
        r_idx = int(rng.integers(r_lo, r_hi + 1)) if r_lo < r_hi else r_lo
        q_idx = min(q_idx, self.store.num_frames(str(q_vid)) - 1)
        r_idx = min(r_idx, self.store.num_frames(str(r_vid)) - 1)
        return (str(q_vid), q_idx), (str(r_vid), r_idx)

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        vid, frame = self.vid_index[idx]
        if vid in self.ann:
            row = self.ann[vid][int(rng.integers(len(self.ann[vid])))]
            (qv, qf), (rv, rf) = self.sample_ann_frames(row, rng)
            img_a = self.store.get_frame(qv, qf)
            img_b = self.store.get_frame(rv, rf)
            return dict(
                img_a=self.transform_n(img_a, rng),
                img_b=self.transform_n(img_b, rng),
                vid_a=self.vid_ordinal.get(qv, -1),
                vid_b=self.vid_ordinal.get(rv, -1),
            )
        img = self.store.get_frame(vid, frame)
        ordinal = self.vid_ordinal[vid]
        if vid.startswith("Q"):
            return dict(
                img_a=self.transform_n(img, rng),
                img_b=self.transform_n(img, rng),
                vid_a=ordinal,
                vid_b=ordinal,
            )
        if rng.random() < 0.5:
            img_a = self.transform_k(img, rng)
        else:
            img_a = self.transform_q(img, rng)
        return dict(
            img_a=img_a,
            img_b=self.transform_k(img, rng),
            vid_a=ordinal,
            vid_b=ordinal,
        )


class FeatureSequenceDataset:
    """Per-video feature sequences for video-score (VED) training.

    features: vid -> [N, D] array; positives: vids with any GT match.
    Sequences are truncated/zero-padded to max_frames (the VSM masks padding).
    """

    def __init__(
        self,
        features: Dict[str, np.ndarray],
        positive_vids: Sequence[str],
        max_frames: int = 256,
    ):
        self.vids = sorted(features)
        self.features = features
        self.positives = set(positive_vids)
        self.max_frames = max_frames

    def __len__(self) -> int:
        return len(self.vids)

    def sample(self, idx: int, rng=None) -> Dict:
        vid = self.vids[idx]
        feats = self.features[vid][: self.max_frames]
        out = np.zeros((self.max_frames, feats.shape[1]), np.float32)
        out[: len(feats)] = feats
        return dict(feats=out, label=float(vid in self.positives), vid=vid)


class DataLoader:
    """Threaded prefetch batch iterator with multi-host index sharding.

    Epoch order is seeded (epoch, seed) so every process draws the same
    permutation and takes its own stride — the DistributedSampler contract.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        order = (
            np.random.default_rng((self.seed, epoch)).permutation(n)
            if self.shuffle
            else np.arange(n)
        )
        return order[self.process_index :: self.process_count]

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices(epoch)
        n_batches = len(indices) // self.batch_size
        if not self.drop_last and len(indices) % self.batch_size:
            n_batches += 1
        if n_batches == 0:
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=2 * self.num_workers)
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]
        task_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            task_q.put((bi, b))

        results: Dict[int, Dict] = {}
        lock = threading.Lock()

        def worker(worker_id: int):
            rng = np.random.default_rng((self.seed, epoch, worker_id))
            while True:
                try:
                    bi, batch_idx = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    samples = [self.dataset.sample(int(i), rng) for i in batch_idx]
                    collated = {
                        k: np.stack([s[k] for s in samples])
                        for k in samples[0]
                        if not isinstance(samples[0][k], str)
                    }
                    out_q.put((bi, collated))
                except Exception as exc:  # surface in the consumer, don't deadlock
                    out_q.put((bi, exc))

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        next_bi = 0
        received = 0
        while received < n_batches:
            bi, collated = out_q.get()
            if isinstance(collated, Exception):
                raise RuntimeError(f"dataloader worker failed on batch {bi}") from collated
            received += 1
            with lock:
                results[bi] = collated
            while next_bi in results:
                yield results.pop(next_bi)
                next_bi += 1
        for t in threads:
            t.join()


def _collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    return {
        k: np.stack([s[k] for s in samples])
        for k in samples[0]
        if not isinstance(samples[0][k], str)
    }


def _process_loader_worker(
    factory, worker_id, num_workers, batch_size, seed, epoch, shuffle,
    process_index, process_count, drop_last, out_q,
):
    """Spawned worker: rebuilds the dataset from `factory`, derives the same
    deterministic epoch order as the parent, and collates its stride of
    batches (worker_id::num_workers)."""
    try:
        ds = factory()
        n = len(ds)
        order = (
            np.random.default_rng((seed, epoch)).permutation(n)
            if shuffle
            else np.arange(n)
        )
        indices = order[process_index::process_count]
        n_batches = len(indices) // batch_size
        if not drop_last and len(indices) % batch_size:
            n_batches += 1
        rng = np.random.default_rng((seed, epoch, worker_id))
        for bi in range(worker_id, n_batches, num_workers):
            b = indices[bi * batch_size : (bi + 1) * batch_size]
            samples = [ds.sample(int(i), rng) for i in b]
            out_q.put((bi, _collate(samples)))
        out_q.put(("done", worker_id))
    except Exception:  # pragma: no cover - surfaced in the consumer
        import traceback

        out_q.put(("error", traceback.format_exc()))


class ProcessDataLoader:
    """Process-pool aug prefetcher for CPU-heavy pipelines.

    The threaded `DataLoader` is GIL-bound on the hard-aug pipelines
    (cv2/PIL release the GIL only partially); at pod-scale training the
    host must run augs on all cores. Workers are spawned processes that
    rebuild the dataset from a picklable `dataset_factory` (mmap stores
    re-open per process; forking a process that has initialised CUDA is
    unsafe, so spawn + factory, never pickled live datasets), take every
    num_workers-th batch of the shared deterministic epoch order, and
    stream collated batches back through one queue; the parent re-orders.

    Same (seed, epoch) permutation and (process_index, process_count)
    sharding contract as `DataLoader`; per-sample aug RNG differs (seeded
    by worker id, as in the threaded loader).
    """

    def __init__(
        self,
        dataset_factory,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        drop_last: bool = True,
        dataset_len: Optional[int] = None,
    ):
        self.factory = dataset_factory
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        if dataset_len is None:
            dataset_len = len(dataset_factory())
        self.dataset_len = dataset_len

    def _n_batches(self) -> int:
        n_local = len(range(self.process_index, self.dataset_len, self.process_count))
        n = n_local // self.batch_size
        if not self.drop_last and n_local % self.batch_size:
            n += 1
        return n

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        import multiprocessing as mp

        n_batches = self._n_batches()
        if n_batches == 0:
            return
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue(maxsize=4 * self.num_workers)
        procs = [
            ctx.Process(
                target=_process_loader_worker,
                args=(
                    self.factory, w, self.num_workers, self.batch_size,
                    self.seed, epoch, self.shuffle, self.process_index,
                    self.process_count, self.drop_last, out_q,
                ),
                daemon=True,
            )
            for w in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        try:
            results: Dict[int, Dict] = {}
            next_bi = 0
            done = 0
            while done < self.num_workers or next_bi < n_batches:
                tag, payload = out_q.get()
                if tag == "done":
                    done += 1
                elif tag == "error":
                    raise RuntimeError(f"loader worker failed:\n{payload}")
                else:
                    results[tag] = payload
                while next_bi in results:
                    yield results.pop(next_bi)
                    next_bi += 1
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()


class OverlayImagePairDataset(FramePairDataset):
    """DISC-style overlay pair generator (reference ImageLmdbDataSet,
    videolmdb_dataset.py:327-374 — auxiliary, absent from final configs):
    the query view alpha-blends a second random frame over the anchor, the
    key view is the anchor; binary `label` marks whether an overlay happened.
    """

    def __init__(self, store: FrameStore, overlay_prob: float = 0.5, **kwargs):
        super().__init__(store, **kwargs)
        self.overlay_prob = overlay_prob

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        vid, frame = self.vid_index[idx]
        img = self.store.get_frame(vid, frame)
        label = 0
        img_a = img
        if rng.uniform() < self.overlay_prob:
            other = self._random_frame(rng)
            other = cv2.resize(other, (img.shape[1], img.shape[0]))
            alpha = rng.uniform(0.3, 0.7)
            img_a = (
                img.astype(np.float32) * (1 - alpha) + other.astype(np.float32) * alpha
            ).astype(np.uint8)
            label = 1
        return dict(
            img_a=self.transform_n(img_a, rng),
            img_b=self.transform_n(img, rng),
            vid_a=self.vid_ordinal[vid],
            vid_b=self.vid_ordinal[vid],
            label=label,
        )


class ConcatDataset:
    """Concatenation of pair datasets (reference --concat_dataset option,
    descriptor_train.py:131-134 — e.g. the VSC corpus + the DISC corpus)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def sample(self, idx: int, rng: np.random.Generator) -> Dict:
        d = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[d].sample(idx - int(self._offsets[d]), rng)
