"""Closed-loop serving traffic: ``clients`` threads, each sending its next
frame as soon as its last reply came, through the server's request body
(``DepthService.predict_bytes``, the body of its HTTP POST handler, without
the socket).

Parameters (the cell's ``params``):
- ``clients``: client threads;
- ``frames``: the pool of distinct uint8 frames at the native size, made from
  the seed (smooth colour fields under noise), each sent as ``.npy`` bytes; each client draws its sequence of
  frames from its own seeded generator;
- ``max_batch``, ``window_ms``, ``pipeline``: the service's batcher, as the
  server's command line sets them;
- ``warmup_s``: seconds of the same traffic after the service's own warm-up
  (every bucket once) and before the window;
- ``sample_per_client``: replies each client keeps for the output check, a
  seeded reservoir over its requests in the window;
- ``trace_s``: the length of the profiled sub-window of a traced run, in
  the window's middle.

A request belongs to the window when it is sent inside it; its latency runs
from the call to the reply. The window's replies, which its rate counts, are
those that came inside it, whenever they were sent. At the window's close no client sends again, and every request
in flight is waited for. The output check runs each kept reply's frame
through the reference (``pipeline.predict``), in blocks of ``max_batch``.
"""

from __future__ import annotations

import io
import threading
import time

import numpy as np
import torch

from ..harness import compare
from ..harness.trace import DeviceTrace, per_interval, profiled
from ..harness.weights import subseed
from ..reference import pipeline

WAIT_AFTER_CLOSE_S = 60.0


class _Client:
    def __init__(self, index: int, seed: int, n_frames: int, keep: int):
        self.rng = np.random.default_rng(subseed(seed, f"client{index}"))
        self.pick = np.random.default_rng(subseed(seed, f"sample{index}"))
        self.n_frames, self.keep = n_frames, keep
        self.records = []  # (start ns, end ns, ok, sent in the window, rows) from the window on
        self.kept = []  # (frame index, reply) of the window: a reservoir
        self.seen = 0
        self.rows = {}  # replies of the window by the rows of their device step
        self.thread = None


class Driver:
    mode = "serve"

    def __init__(self, run, model):
        self.run, self.model = run, model
        self.p = run.params
        self.window_open = self.window_close = None
        self.stop = threading.Event()

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from mde_tpu_torch.tools.common import set_float32_precision
        from mde_tpu_torch.tools.serve import DepthService

        run, p = self.run, self.p
        set_float32_precision()  # as build_service does: TF32 off
        h, w = (int(s) for s in run.cfg.framework.native_size)
        self.frames = _frames(int(p["frames"]), h, w, subseed(run.seed, "frames"), run.device)
        self.bodies = []
        for frame in self.frames:
            buf = io.BytesIO()
            np.save(buf, frame)
            self.bodies.append(buf.getvalue())
        self.service = DepthService(self.model, run.cfg, run.device, max_batch=int(p["max_batch"]),
                                    window_ms=float(p["window_ms"]),
                                    pipeline=bool(p["pipeline"]))
        self.service.warmup()
        run.mark("buckets warmed")
        buf = io.BytesIO()
        np.save(buf, np.zeros((h, w), np.float32))
        self.reply_bytes = len(buf.getvalue())  # a (426, 560) float32 .npy
        self.clients = [_Client(i, run.seed, len(self.bodies), int(p["sample_per_client"]))
                        for i in range(int(p["clients"]))]
        for c in self.clients:
            c.thread = threading.Thread(target=self._client, args=(c,), daemon=True)
            c.thread.start()
        time.sleep(float(p["warmup_s"]))

    def _client(self, c: _Client) -> None:
        spans = self.run.spans
        while not self.stop.is_set():
            frame = int(c.rng.integers(c.n_frames))
            t0 = time.time_ns()
            timed = self.window_open is not None and t0 >= self.window_open
            if timed and self.window_close is not None and t0 >= self.window_close:
                return
            body, rows = None, 0
            with spans.span("request"):
                try:
                    body, rows = self.service.predict_bytes(self.bodies[frame])
                except Exception:  # a failed request counts as missing
                    body = None
            t1 = time.time_ns()
            ok = body is not None and len(body) == self.reply_bytes
            if self.window_open is not None and t1 >= self.window_open:
                c.records.append((t0, t1, ok, timed, rows))
            if timed and ok:  # a seeded reservoir of the window's replies
                c.rows[rows] = c.rows.get(rows, 0) + 1
                slot = len(c.kept) if len(c.kept) < c.keep else int(c.pick.integers(c.seen + 1))
                if slot < c.keep:
                    reply = (frame, np.load(io.BytesIO(body)))
                    if slot == len(c.kept):
                        c.kept.append(reply)
                    else:
                        c.kept[slot] = reply
                c.seen += 1

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        run = self.run
        stats = self.service.batcher.stats
        before = dict(stats)
        self.window_open = t0 = time.time_ns()
        run.window_started(t0)
        if run.trace:
            trace_s = min(float(self.p["trace_s"]), seconds / 2)
            time.sleep(max(0.0, (seconds - trace_s) / 2))
            with profiled() as (prof, mark):
                traced_before = dict(stats)
                time.sleep(trace_s)
                traced_after = dict(stats)
                t_end = time.time_ns()
            run.record["trace"] = DeviceTrace(prof, mark.mark_ns, mark.mark_ns, t_end)
            traced = (mark.mark_ns, t_end)
            self.detail = {"trace_frames": traced_after["requests"] - traced_before["requests"],
                           "trace_steps": traced_after["device_steps"] - traced_before["device_steps"],
                           "flash_calls": run.record["trace"].count(("flash_attention_kernel",))}
        time.sleep(max(0.0, (t0 + seconds * 1e9 - time.time_ns()) / 1e9))
        self.window_close = t1 = time.time_ns()
        after = dict(stats)
        deadline = time.monotonic() + WAIT_AFTER_CLOSE_S
        for c in self.clients:
            c.thread.join(timeout=max(0.0, deadline - time.monotonic()))
        self.stop.set()
        records = [r for c in self.clients for r in c.records]
        window_s = (t1 - t0) / 1e9
        done = [r for r in records if r[2] and r[1] <= t1]
        sent = [r for r in records if r[3]]
        latencies = sorted((r[1] - r[0]) / 1e6 if r[2] else float("inf") for r in sent)
        if any(c.thread.is_alive() for c in self.clients):
            latencies.append(float("inf"))  # a request that never came back
        self.attempted = len(sent)
        self.failed = sum(1 for r in sent if not r[2])
        rows = {}
        for c in self.clients:
            for k, v in c.rows.items():
                rows[k] = rows.get(k, 0) + v
        self.detail = {**getattr(self, "detail", {}), "replies_by_rows": dict(sorted(rows.items())),
                       "replies_by_5s": per_interval([r[1] for r in done], t0, t1, 5e9)}
        buckets = self.service.batcher.buckets
        run.record.update(window_s=window_s, frames=len(done), batch=1,
                          batcher={k: after[k] - before[k] for k in ("requests", "device_steps")},
                          replies=sum(rows.values()), rows_run=_rows_run(rows, buckets))
        if run.trace:  # the rows of the steps whose replies came in the traced sub-window
            traced_rows = {}
            for r in done:
                if traced[0] <= r[1] < traced[1]:
                    traced_rows[r[4]] = traced_rows.get(r[4], 0) + 1
            run.record["trace_rows"] = _rows_run(traced_rows, buckets)
        return {"serve_fps": len(done) / window_s,
                "serve_p95_ms": _percentile(latencies, 95)}

    def release(self) -> None:
        self.close()
        self.kept = [k for c in self.clients for k in c.kept]
        del self.model

    def close(self) -> None:
        """Stop the clients and the service (also after a failure)."""
        self.stop.set()
        for c in getattr(self, "clients", ()):
            c.thread.join(timeout=WAIT_AFTER_CLOSE_S)
        service = self.__dict__.pop("service", None)
        if service is not None:
            service.close()

    # -- the output check ----------------------------------------------------
    def candidate(self) -> list:
        """The program's kept replies."""
        return [torch.from_numpy(r) for _, r in self.kept]

    def reference(self, state: dict, precision) -> list:
        """The reference's depth map of each kept reply's frame, computed
        under ``precision``."""
        run = self.run
        ref = run.reference_model(state)
        cfg = run.cfg.framework
        block = int(self.p["max_batch"])
        frames = [f for f, _ in self.kept]
        out = []
        with precision():
            for i in range(0, len(frames), block):
                x = torch.from_numpy(self.frames[frames[i:i + block]]).to(run.device)
                out.extend(pipeline.predict(ref, x, cfg.input_size, cfg.native_size).cpu())
        return out

    @staticmethod
    def numbers(candidate: list, reference: list) -> dict:
        gaps = [compare.map_gap(a, b) for a, b in zip(candidate, reference)]
        return {"map_gap": max(gaps) if gaps else float("inf")}


def _frames(n: int, h: int, w: int, seed: int, device) -> np.ndarray:
    """``n`` (h, w, 3) uint8 frames from ``seed``, made on ``device``: a
    smooth colour field (a random 6x8 grid, bilinear) under a little noise,
    so that each frame's depth map is its own."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand((n, 3, 6, 8), generator=gen, device=device)
    noise = torch.rand((n, 3, h, w), generator=gen, device=device)
    field = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    frames = (field * 0.9 + noise * 0.1) * 255.0
    return frames.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()


def _rows_run(replies_by_rows: dict, buckets) -> float:
    """The rows that the device steps of these replies ran: a step of n
    requests gives n replies and runs the least bucket that holds n."""
    return sum(count / n * min(b for b in buckets if b >= n)
               for n, count in replies_by_rows.items() if n > 0)


def _percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``th percentile; inf where a value is inf."""
    if not values:
        return float("inf")
    rank = max(1, int(np.ceil(q / 100 * len(values))))
    return float(values[rank - 1])
