"""The port's profiling helpers against mde_tpu/train/profiling.py, on the CPU.

- ``StepTimer``: the same warm-up rule and the same summary (keys and
  values) as the JAX timer on one scripted clock; ``stop`` synchronises the
  CUDA devices of the tensors it is given (nested in dicts and lists) and
  nothing for CPU tensors.
- ``device_memory_stats``: the JAX module's keys; without a card one
  ``"cpu"`` entry of Nones, and with one (torch.cuda's readers stubbed) the
  allocator's numbers under those keys.
- ``trace`` writes a Chrome trace of the block into its directory.
"""

import json
import time

import jax.numpy as jnp
import pytest
import torch

from mde_tpu.train import profiling as jax_profiling
from mde_tpu_torch.train import profiling


def _scripted_clock(monkeypatch, deltas):
    """time.perf_counter returning start/stop pairs ``deltas`` apart."""
    ticks = []
    for i, d in enumerate(deltas):
        ticks += [10.0 * i, 10.0 * i + d]
    it = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("warmup,steps", [(2, 5), (0, 3), (3, 2)])
def test_step_timer_matches_jax(monkeypatch, warmup, steps):
    deltas = [0.5, 0.25, 0.125, 0.375, 0.0625][:steps]  # exact in binary
    summaries = []
    for timer, out in ((profiling.StepTimer(warmup), torch.ones(2)),
                       (jax_profiling.StepTimer(warmup), jnp.ones(2))):
        _scripted_clock(monkeypatch, deltas)
        got = []
        for _ in deltas:
            timer.start()
            got.append(timer.stop(out))
        assert got == deltas  # every step is timed; the warm-up ones are not kept
        assert timer.times == deltas[warmup:]
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    if steps > warmup:
        assert set(summaries[0]) == {"steps", "mean_s", "p50_s", "p95_s", "min_s"}
    else:
        assert summaries[0] == {"steps": 0}


def test_step_timer_synchronises_the_cuda_devices_it_is_given(monkeypatch):
    """CPU tensors synchronise nothing; each CUDA device among the outputs once."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timer = profiling.StepTimer(warmup=0)
    timer.start()
    timer.stop(torch.ones(1), {"loss": torch.zeros(()), "parts": [torch.ones(2)]})
    assert synced == []

    class OnCard(torch.Tensor):  # a CPU tensor that says it lies on a card
        is_cuda = True

        @property
        def device(self):
            return torch.device("cuda", int(self.item()))

    def on_card(index):
        return torch.Tensor._make_subclass(OnCard, torch.tensor(float(index)))

    timer.start()
    timer.stop(on_card(0), {"a": [on_card(1), on_card(0)]})
    assert sorted(d.index for d in synced) == [0, 1]


def test_device_memory_stats_keys_match_jax_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = profiling.device_memory_stats()
    want = jax_profiling.device_memory_stats()
    assert [set(s) for s in got] == [set(want[0])]
    assert got == [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                    "bytes_limit": None}]


def test_device_memory_stats_reads_the_allocator(monkeypatch):
    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 100 + d.index)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: 200 + d.index)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    got = profiling.device_memory_stats()
    assert [set(s) for s in got] == [set(jax_profiling.device_memory_stats()[0])] * 2
    assert got[1] == {"device": "cuda:1", "bytes_in_use": 101, "peak_bytes_in_use": 201,
                      "bytes_limit": 80 * 2**30}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert logdir == str(tmp_path / "trace") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
