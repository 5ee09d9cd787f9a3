"""The benchmark's own spans, and the device trace of a traced run.

Spans are recorded by the benchmark around its calls into the program (a
client's request, the loader's ``next``, the train step's call), on the
host's wall clock (``time.time_ns``), kept in memory. A traced run (``--trace
1``) also records ``torch.profiler`` over a steady sub-window of the
measured window; ``DeviceTrace`` reduces it to what the per-layer readers
and the result's ``breakdown`` need: every device activity's interval and
name (kernels, copies, sets), merged into busy intervals, and the idle gaps
between them, each named by the benchmark span that was open on the host at
its middle. The profiler's clock is tied to the spans' by a marker recorded
on both.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

MARK = "gpubench.clock_mark"


class Spans:
    """(name, start ns, end ns) of every span, from any thread."""

    def __init__(self):
        self.items: list = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append((name, t0, t1))

    def between(self, name: str, t0: int, t1: int) -> list:
        """Durations (s) of the spans ``name`` that started in [t0, t1)."""
        return [(b - a) / 1e9 for n, a, b in self.items if n == name and t0 <= a < t1]


def per_interval(times: list, t0: int, t1: int, step_ns: float) -> list:
    """How many of ``times`` fall in each ``step_ns`` from ``t0`` to ``t1``."""
    out = [0] * max(1, int(-(-(t1 - t0) // step_ns)))
    for t in times:
        if t0 <= t < t1:
            out[int((t - t0) // step_ns)] += 1
    return out


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """The device activities of a ``torch.profiler`` window, on the spans'
    clock (ns)."""

    def __init__(self, prof, host_mark_ns: int, t0: int, t1: int):
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        offset = 0
        for e in events:
            if e.name() == MARK:
                offset = host_mark_ns - e.start_ns()
                break
        self.t0, self.t1 = t0, t1  # the window, on the spans' clock
        self.ops = []  # (name, start, end)
        for e in events:
            # device activities: kernels, copies, sets (not the annotations
            # that mirror host ranges on the device's timeline)
            if (e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
                    and not e.is_user_annotation()):
                a = e.start_ns() + offset
                self.ops.append((e.name(), a, a + e.duration_ns()))
        clipped = [(max(a, t0), min(b, t1)) for _, a, b in self.ops if b > t0 and a < t1]
        self.busy = _merge(clipped)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def device_seconds(self, names) -> float:
        """Device seconds inside the window of the activities whose name
        contains one of ``names``."""
        return sum(min(b, self.t1) - max(a, self.t0) for n, a, b in self.ops
                   if b > self.t0 and a < self.t1 and any(k in n for k in names)) / 1e9

    def count(self, names) -> int:
        """Activities inside the window whose name contains one of ``names``."""
        return sum(1 for n, a, b in self.ops
                   if b > self.t0 and a < self.t1 and any(k in n for k in names))

    def top_ops(self, k: int = 10) -> list:
        total = defaultdict(int)
        for n, a, b in self.ops:
            total[n[:160]] += b - a
        return [[n, ns / 1e9] for n, ns in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def gaps(self, spans: Spans, k: int = 10) -> list:
        """The ``k`` longest idle gaps, each named by the host span open at its
        middle (the latest started), or "no span"."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        out = []
        for ns, a, b in sorted(gaps, reverse=True)[:k]:
            mid = (a + b) // 2
            open_ = [(s0, n) for n, s0, s1 in spans.items if s0 <= mid <= s1]
            out.append([max(open_)[1] if open_ else "no span", ns / 1e9])
        return out


def idle_pct(run):
    """The share (%) of a run's traced sub-window in which no operation ran
    on the card (kernels, copies and sets); None in an untraced run."""
    trace = run.record.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block, CPU and (where there is a card) CUDA;
    yields (profiler, a holder whose ``mark_ns`` is the marker's host
    time). The work in flight is not synchronised first: that would idle
    the device at the window's start."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Mark", (), {})()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        holder.mark_ns = time.time_ns()
        with record_function(MARK):
            pass
        yield prof, holder
