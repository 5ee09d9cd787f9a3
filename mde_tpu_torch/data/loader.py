"""Threaded host loader with a device prefetch (a copy of mde_tpu/data/loader.py).

Replaces the reference's ``DataLoader(num_workers=4, pin_memory=True,
persistent_workers=True)`` (src/main.py:622-646). Worker *threads* (PNG decode and
np.load release the GIL) fill a bounded queue of ready uint8/float32 numpy
batches, yielded as numpy arrays. Given a ``device``, the loader yields torch
tensors on it instead; for a CUDA device each batch goes through pinned host
memory and a non-blocking copy on a side stream, issued one batch ahead, so
the copy of batch i+1 overlaps the step on batch i and the host never waits
on a per-step blocking ``.to(device)``.

``process_shard=(process, count)`` is the multi-process mode of the
original: every process computes the same global batch order (the
constructor's arguments match across processes) and decodes only its rows
of each batch (``parallel.mesh.local_rows``: with ``accum_steps``
microbatches, its share of each). ``batch_size`` stays the global batch
size. A batch whose microbatches do not split over ``count`` (a remainder)
is yielded whole on every process and tagged ``_replicated``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import local_rows
from .dataset import DepthDataset

_ARRAYS = ("rgb", "depth")


def _copy_to_device(batch: dict, device: torch.device, stream) -> tuple[dict, object]:
    """Start the pinned, non-blocking copies of ``batch`` on ``stream``;
    returns the batch with device tensors and the event that marks the end."""
    out = dict(batch)
    with torch.cuda.stream(stream):
        for key in _ARRAYS:
            if key in batch:
                out[key] = torch.from_numpy(batch[key]).pin_memory().to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def _cuda_prefetch(batches: Iterator[dict], device: torch.device) -> Iterator[dict]:
    """Yield each batch on ``device`` once its copy has been ordered before
    the current stream's next work, with the next batch's copy already issued."""
    stream = torch.cuda.Stream(device)
    pending = None
    for batch in batches:
        issued = _copy_to_device(batch, device, stream)
        if pending is not None:
            yield _ready(*pending, device)
        pending = issued
    if pending is not None:
        yield _ready(*pending, device)


def _ready(batch: dict, done, device) -> dict:
    current = torch.cuda.current_stream(device)
    current.wait_event(done)
    for key in _ARRAYS:
        if key in batch:  # allocated on the copy stream, used on the current one
            batch[key].record_stream(current)
    return batch


class HostLoader:
    def __init__(
        self,
        dataset: DepthDataset,
        indices: Optional[Sequence[int]] = None,
        batch_size: int = 4,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        prefetch_depth: int = 2,
        cache: bool = False,
        device=None,
        process_shard: Optional[tuple[int, int]] = None,
        accum_steps: int = 1,
    ):
        self.dataset = dataset
        # None: numpy batches; a torch device: tensors on it (see module docstring).
        self.device = None if device is None else torch.device(device)
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        self._rng = np.random.default_rng(seed)
        # Optional in-RAM decode cache: the full CIL train set is ~17 GB of
        # raw uint8+f32 (24k x 426x560), far below typical host RAM; epochs
        # after the first skip PNG/NPY decode entirely.
        self.cache = cache
        self._cache: dict[int, tuple] = {}
        self._cache_lock = threading.Lock()
        # Whole-batch decode through native/depthio.cpp when its library is
        # built and the host has more than one core, the original's default
        # (benchmarks/data_pipeline_bench.py: on one core the per-sample
        # decode is faster). The cache (above) dominates both after epoch 1.
        self._native_hw = "unprobed" if (os.cpu_count() or 1) > 1 else None
        if process_shard is not None:
            p, n = process_shard
            if not (0 <= p < n):
                raise ValueError(f"process_shard {process_shard}: need 0 <= id < count")
        self.process_shard = process_shard
        self.accum_steps = int(accum_steps)

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def num_samples(self) -> int:
        if self.drop_last:
            return len(self) * self.batch_size
        return len(self.indices)

    def _batch_indices(self) -> list[tuple[np.ndarray, bool]]:
        """Batches as (indices, replicated) pairs; ``replicated`` marks a
        process-sharded batch yielded whole on every process."""
        order = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.process_shard is None:
            return [(b, False) for b in batches]
        p, n = self.process_shard
        out = []
        for b in batches:
            rows = local_rows(len(b), self.accum_steps, p, n)
            out.append((b, True) if rows is None else (b[rows], False))
        return out

    def _native_size(self):
        """Probe + cache the image size for the native batch decoder; None
        disables the native path (lib missing or probe failed)."""
        if self._native_hw == "unprobed":
            self._native_hw = None
            try:
                from . import native

                if native.available():
                    rgb_path, _ = self.dataset.paths(int(self.indices[0]))
                    self._native_hw = native.png_info(rgb_path)
            except (IOError, OSError, IndexError):
                self._native_hw = None
        return self._native_hw

    def _assemble(self, idxs: np.ndarray) -> dict:
        names = [self.dataset.entries[int(i)] for i in idxs]
        if self.cache:
            with self._cache_lock:
                cached = [self._cache.get(int(i)) for i in idxs]
            if all(c is not None for c in cached):
                batch = {"rgb": np.stack([c[0] for c in cached]), "names": names}
                if self.dataset.has_gt:
                    batch["depth"] = np.stack([c[1] for c in cached])
                return batch
        hw = self._native_size()
        if hw is not None:
            from . import native

            paths = [self.dataset.paths(int(i)) for i in idxs]
            try:
                # The C++ pool already parallelizes across the batch; decoding
                # here stays single-threaded per call.
                rgb, depth = native.load_batch(
                    [p[0] for p in paths],
                    [p[1] for p in paths] if self.dataset.has_gt else None,
                    hw[0], hw[1], workers=1,
                )
                batch = {"rgb": rgb, "names": names}
                if depth is not None:
                    batch["depth"] = depth
                self._store_cache(idxs, batch)
                return batch
            except IOError:
                pass  # odd-sized or unsupported file: fall through to PIL
        rgbs, depths = [], []
        for i in idxs:
            rgb, depth, _ = self.dataset.load(int(i))
            rgbs.append(rgb)
            depths.append(depth)
        batch = {"rgb": np.stack(rgbs), "names": names}
        if self.dataset.has_gt:
            batch["depth"] = np.stack(depths)
        self._store_cache(idxs, batch)
        return batch

    def _store_cache(self, idxs, batch) -> None:
        if not self.cache:
            return
        with self._cache_lock:
            for pos, i in enumerate(idxs):
                if int(i) not in self._cache:
                    self._cache[int(i)] = (
                        batch["rgb"][pos],
                        batch["depth"][pos] if "depth" in batch else None,
                    )

    def __iter__(self) -> Iterator[dict]:
        if self.device is None:
            return self._host_batches()
        if self.device.type == "cuda":
            return _cuda_prefetch(self._host_batches(), self.device)
        return ({k: torch.from_numpy(v) if k in _ARRAYS else v for k, v in b.items()}
                for b in self._host_batches())

    def _host_batches(self) -> Iterator[dict]:
        batches = self._batch_indices()
        if not batches:
            return
        task_q: queue.Queue = queue.Queue()
        for pos, (idxs, replicated) in enumerate(batches):
            task_q.put((pos, idxs, replicated))
        # Bound host memory: at most prefetch_depth + num_workers batches may be
        # decoded but not yet consumed.
        inflight = threading.Semaphore(self.prefetch_depth + self.num_workers)
        # Per-slot result store so batches are yielded in order even though
        # workers finish out of order.
        results: dict[int, dict] = {}
        results_cv = threading.Condition()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                inflight.acquire()
                try:
                    pos, idxs, replicated = task_q.get_nowait()
                except queue.Empty:
                    inflight.release()
                    return
                batch = self._assemble(idxs)
                if replicated:
                    batch["_replicated"] = True
                with results_cv:
                    results[pos] = batch
                    results_cv.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(self.num_workers, len(batches)))
        ]
        for t in threads:
            t.start()
        try:
            for pos in range(len(batches)):
                with results_cv:
                    while pos not in results:
                        results_cv.wait(timeout=60.0)
                    batch = results.pop(pos)
                inflight.release()
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=1.0)
