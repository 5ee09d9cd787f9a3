"""Tracing and profiling helpers (port of mde_tpu/train/profiling.py).

- ``trace(logdir)``: a context manager around ``torch.profiler`` (the CPU, and
  the CUDA devices when there are any) that writes one Chrome trace
  (``trace_<time>_<pid>.json``) into ``logdir`` when the block ends.
- ``StepTimer``: per-step wall-clock statistics that skip the first
  ``warmup`` steps. PyTorch returns before the card has finished, so
  ``stop`` is given the step's outputs and synchronises the device of each
  CUDA tensor among them before it reads the clock.
- ``device_memory_stats``: memory in use, its peak and the device's size,
  one dict a CUDA device, under the keys of the JAX module.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block; yields ``logdir`` (default: ``mde_tpu_torch_trace``
    in the temporary directory), where the trace is written on exit."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "mde_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    name = f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (tensors, or dicts, lists
    and tuples of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0: Optional[float] = None
        self._seen = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *block_on):
        """Seconds since ``start``, once every CUDA device holding a tensor of
        ``block_on`` has finished its queued work; kept after the warm-up."""
        for device in _cuda_devices(block_on, set()):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "min_s": float(arr.min()),
        }


def device_memory_stats() -> list[dict]:
    """One dict a CUDA device: ``bytes_in_use`` (``memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``) and ``bytes_limit`` (the
    device's total memory). Without a card, one ``"cpu"`` entry whose
    numbers are None, as JAX reports its CPU device."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                 "bytes_limit": None}]
    stats = []
    for i in range(torch.cuda.device_count()):
        device = torch.device("cuda", i)
        stats.append({
            "device": str(device),
            "bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
        })
    return stats
