"""Dynamic-batching depth-inference server (port of mde_tpu/tools/serve.py).

A long-lived serving process around the predict step
(train/trainer.py::make_predict_step: preprocess -> forward -> align-corners
resize to the native 426x560):

- **Batch buckets** (1, 2, 4, ... max_batch): every request group is
  zero-padded up to the nearest bucket, so the device sees a fixed set of
  shapes, each warmed at startup.
- **Dynamic batcher**: concurrent requests coalesce into one device step (the
  first request opens a bounded ``window_ms`` collection window); results fan
  back out to each waiter.
- **Double-buffered dispatch**: the step is enqueued on the current CUDA
  stream and returns at once; the batcher admits and dispatches the next
  batch before it copies the previous result back.
- **Host pipeline off the device path**: PNG/NPY decode and any host-side
  resize to the native geometry run on the HTTP worker threads.

HTTP surface (stdlib ThreadingHTTPServer):
  POST /predict  body = PNG bytes or .npy bytes (H, W, 3) uint8
                 -> 200, application/x-npy float32 (426, 560) depth map
                 (X-Batch-Size header reports the coalesced device batch)
  GET  /healthz  -> 200, JSON {status, model, buckets, stats}

Run: ``python -m mde_tpu_torch.tools.serve [--config ...] [--device cuda]
[--port 8000]``. With ``--exported MODEL.mdex`` it serves an archive of
``python -m mde_tpu_torch.tools.export_model`` (train/export.py) instead: no
model is built and no checkpoint read, and the batcher's buckets are the
archive's.
"""

from __future__ import annotations

import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..train.checkpoint import checkpoint_path
from ..train.trainer import make_predict_step
from .common import (bootstrap_model, live_missing_keys, parse_config, resolve_paths,
                     set_float32_precision)

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_NPY_MAGIC = b"\x93NUMPY"


def _buckets(max_batch: int) -> tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class _Item:
    __slots__ = ("img", "event", "result", "error", "batch_size")

    def __init__(self, img: np.ndarray):
        self.img = img
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.batch_size = 0


class DynamicBatcher:
    """Coalesces concurrent single-image requests into bucketed device steps.

    ``predict_many`` receives a uint8 (N, H, W, 3) stack with N equal to one
    of ``buckets`` and returns (N, h', w') float32; only the first
    ``n_valid`` rows are delivered (the tail is zero padding).

    Double-buffering: when ``predict_dispatch``/``predict_fetch`` are given
    (an async pair — dispatch enqueues the device computation and returns a
    handle, fetch blocks on the handle's results), the batcher admits and
    dispatches the NEXT batch while the previous one is still in flight on
    the device, then delivers the previous results. CUDA launches are async,
    so the device never sits idle between coalesced steps under load. With only
    the synchronous ``predict_many``, dispatch degrades to compute-and-hold
    (same semantics, no overlap).
    """

    def __init__(
        self,
        predict_many: Callable[[np.ndarray], np.ndarray],
        max_batch: int = 8,
        window_ms: float = 5.0,
        item_shape: Optional[tuple] = None,
        item_dtype=np.uint8,
        request_timeout_s: float = 300.0,
        predict_dispatch: Optional[Callable] = None,
        predict_fetch: Optional[Callable] = None,
    ):
        self._predict_many = predict_many
        if predict_dispatch is not None:
            if predict_fetch is None:
                raise ValueError("predict_dispatch requires predict_fetch")
            self._dispatch_fn, self._fetch_fn = predict_dispatch, predict_fetch
        else:
            self._dispatch_fn = predict_many
            self._fetch_fn = lambda handle: handle
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1000.0
        self.buckets = _buckets(self.max_batch)
        # Per-item contract, enforced at submit() so one bad request fails
        # alone instead of poisoning whoever it got coalesced with (and so a
        # float image can't be silently value-truncated into the uint8 batch).
        self.item_shape = tuple(item_shape) if item_shape is not None else None
        self.item_dtype = np.dtype(item_dtype)
        # A waiter that gives up leaves its item in flight, so the device
        # step runs for nobody: keep the default generous.
        self.request_timeout_s = float(request_timeout_s)
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "device_steps": 0, "max_coalesced": 0}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(
        self, img: np.ndarray, timeout: Optional[float] = None
    ) -> tuple[np.ndarray, int]:
        """Blocking: returns (depth, coalesced_batch_size) for one image."""
        img = np.asarray(img)
        if self.item_shape is not None and img.shape != self.item_shape:
            raise ValueError(f"expected image shape {self.item_shape}, got {img.shape}")
        if img.dtype != self.item_dtype:
            raise ValueError(f"expected dtype {self.item_dtype}, got {img.dtype}")
        item = _Item(img)
        self._q.put(item)
        if not item.event.wait(timeout if timeout is not None else self.request_timeout_s):
            raise TimeoutError("prediction timed out")
        if item.error is not None:
            raise item.error
        return item.result, item.batch_size

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5.0)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    _FAILED = object()  # dispatch already failed + delivered its errors

    def _run(self):
        pending = None  # (items, handle): dispatched, results not yet fetched
        while True:
            if pending is None:
                first = self._q.get()
            else:
                # A batch is in flight on the device: wait briefly for the
                # head of the next batch so it can be dispatched back-to-back;
                # if no traffic arrives, deliver the in-flight results.
                try:
                    first = self._q.get(timeout=self.window_s)
                except queue.Empty:
                    self._complete(*pending)
                    pending = None
                    continue
            if first is None:
                if pending is not None:
                    self._complete(*pending)
                return
            items = [first]
            deadline = time.monotonic() + self.window_s
            closing = False
            while len(items) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    closing = True
                    break
                items.append(nxt)
            handle = self._dispatch(items)
            if pending is not None:
                self._complete(*pending)  # overlap: next batch already queued
            pending = None if handle is self._FAILED else (items, handle)
            if closing:
                if pending is not None:
                    self._complete(*pending)
                return

    def _dispatch(self, items: Sequence[_Item]):
        """Pad ``items`` to a bucket and enqueue the device step. EVERYTHING
        is inside the try: an exception anywhere (allocation included) must
        fail these waiters, not kill the batcher thread — a dead thread would
        leave every later request timing out while /healthz still answers
        ok."""
        try:
            bucket = self._bucket_for(len(items))
            batch = np.zeros((bucket,) + items[0].img.shape, dtype=items[0].img.dtype)
            for i, it in enumerate(items):
                batch[i] = it.img  # shapes/dtypes pre-validated in submit()
            return self._dispatch_fn(batch)
        except BaseException as e:
            self._deliver(items, None, e)
            return self._FAILED

    def _complete(self, items: Sequence[_Item], handle):
        """Block on the in-flight handle and deliver results (or the error)."""
        try:
            preds = np.asarray(self._fetch_fn(handle))
        except BaseException as e:  # propagate to every waiter, keep serving
            self._deliver(items, None, e)
            return
        self._deliver(items, preds, None)

    def _deliver(self, items: Sequence[_Item], preds, error):
        n = len(items)
        for i, it in enumerate(items):
            if error is not None:
                it.error = error
            else:
                it.result = preds[i]
                it.batch_size = n
        with self._lock:
            self.stats["requests"] += n
            self.stats["device_steps"] += 1
            self.stats["max_coalesced"] = max(self.stats["max_coalesced"], n)
        for it in items:
            it.event.set()


class DepthService:
    """Model + bucketed predict step on ``device``; owns decode to native size.
    With ``predict_many`` (an exported archive's ``ExportedPredictor.predict``)
    there is no model: that function is the device step, run synchronously."""

    def __init__(self, model, cfg, device="cuda", max_batch: int = 8,
                 window_ms: float = 5.0, request_timeout_s: float = 300.0,
                 pipeline: bool = True, predict_many=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.native = tuple(int(s) for s in cfg.framework.native_size)
        self.model_name = str(cfg.experiment.model_name)
        self.model = model
        self._predict_impl = predict_many
        dispatch = fetch = None
        if predict_many is None:
            self._step = make_predict_step(model, cfg)
        if predict_many is None and pipeline:
            # async dispatch/fetch pair: the batcher admits and dispatches
            # batch k+1 while batch k is still in flight on the device.
            dispatch, fetch = self._predict_dispatch, self._predict_fetch
        self.batcher = DynamicBatcher(
            self._predict_many, max_batch, window_ms,
            item_shape=(*self.native, 3), item_dtype=np.uint8,
            request_timeout_s=request_timeout_s,
            predict_dispatch=dispatch, predict_fetch=fetch,
        )

    # -- device path -------------------------------------------------------
    def _predict_dispatch(self, rgb_u8: np.ndarray) -> torch.Tensor:
        """Copy the bucket to the device and enqueue the step; returns the
        (not yet computed) output tensor."""
        return self._step(torch.from_numpy(rgb_u8).to(self.device))

    def _predict_fetch(self, handle: torch.Tensor) -> np.ndarray:
        return handle.cpu().numpy()

    def _predict_many(self, rgb_u8: np.ndarray) -> np.ndarray:
        if self._predict_impl is not None:
            return np.asarray(self._predict_impl(rgb_u8))
        return self._predict_fetch(self._predict_dispatch(rgb_u8))

    def warmup(self):
        """Run every bucket once, so no request pays for first-use set-up
        (kernel build, allocator growth, cuDNN algorithm choice)."""
        h, w = self.native
        for b in self.batcher.buckets:
            self._predict_many(np.zeros((b, h, w, 3), np.uint8))

    # -- host path ---------------------------------------------------------
    def decode(self, body: bytes) -> np.ndarray:
        """PNG or .npy request bytes -> (H_native, W_native, 3) uint8.

        Every malformed-payload failure surfaces as ValueError (-> HTTP 400):
        PIL raises OSError/SyntaxError subclasses on corrupt PNGs, numpy its
        own zoo on bad .npy — a request must never take down its connection."""
        try:
            if body.startswith(_PNG_MAGIC):
                from PIL import Image

                img = Image.open(io.BytesIO(body)).convert("RGB")
                if (img.height, img.width) != self.native:
                    img = img.resize((self.native[1], self.native[0]), Image.BILINEAR)
                return np.asarray(img, np.uint8)
            if body.startswith(_NPY_MAGIC):
                arr = np.load(io.BytesIO(body))
                if arr.ndim != 3 or arr.shape[-1] != 3:
                    raise ValueError(f"expected (H, W, 3) array, got {arr.shape}")
                if arr.dtype != np.uint8:
                    # NO silent coercion: casting a normalized float image (or
                    # an int16/32 one) to uint8 truncates it to garbage that
                    # would then be served with a 200.
                    raise ValueError(
                        f"expected uint8 image array, got dtype {arr.dtype}"
                    )
                if arr.shape[:2] != self.native:
                    from PIL import Image

                    img = Image.fromarray(arr)
                    img = img.resize((self.native[1], self.native[0]), Image.BILINEAR)
                    return np.asarray(img, np.uint8)
                return arr
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(f"could not decode payload: {e}") from e
        raise ValueError("unsupported payload: expected PNG or .npy bytes")

    def predict_bytes(self, body: bytes) -> tuple[bytes, int]:
        """Decode -> batched predict -> .npy response bytes, coalesced size."""
        img = np.ascontiguousarray(self.decode(body))
        depth, coalesced = self.batcher.submit(img)
        buf = io.BytesIO()
        np.save(buf, np.asarray(depth, np.float32))
        return buf.getvalue(), coalesced

    def close(self):
        self.batcher.close()


def make_handler(service: DepthService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str, extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, b"not found", "text/plain")
                return
            payload = {
                "status": "ok",
                "model": service.model_name,
                "native_size": list(service.native),
                "buckets": list(service.batcher.buckets),
                "stats": dict(service.batcher.stats),
            }
            self._send(200, json.dumps(payload).encode(), "application/json")

        # Generous for any native-size PNG/NPY; bounds a hostile/buggy
        # Content-Length before the body is buffered.
        MAX_BODY = 32 * 1024 * 1024

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._send(400, b"bad Content-Length", "text/plain")
                return
            if length < 0:
                # rfile.read(-1) would block until connection EOF, pinning
                # this handler thread forever on a client that never closes.
                self._send(400, b"bad Content-Length", "text/plain")
                return
            if length > self.MAX_BODY:
                self._send(413, b"payload too large", "text/plain")
                return
            body = self.rfile.read(length)
            try:
                out, coalesced = service.predict_bytes(body)
            except ValueError as e:
                self._send(400, str(e).encode(), "text/plain")
                return
            except TimeoutError as e:
                self._send(503, str(e).encode(), "text/plain")
                return
            except Exception as e:  # device/runtime failure: a 500, never a
                self._send(500, f"{type(e).__name__}: {e}".encode(), "text/plain")
                return  # dropped connection
            self._send(200, out, "application/x-npy",
                       {"X-Batch-Size": str(coalesced)})

    return Handler


def build_service(cfg, device="cuda", max_batch: int = 8, window_ms: float = 5.0,
                  warmup: bool = True, request_timeout_s: float = 300.0,
                  allow_uninitialized: bool = False, pipeline: bool = True) -> DepthService:
    set_float32_precision()
    paths = resolve_paths(cfg)
    ckpt = checkpoint_path(paths["results_dir"], cfg.experiment.model_name)
    if not os.path.exists(ckpt) and not allow_uninitialized:
        # A long-lived server quietly answering with untrained weights (e.g.
        # after a typo'd model_name) is far worse than refusing to start.
        raise FileNotFoundError(
            f"checkpoint {ckpt} not found; refusing to serve a randomly "
            "initialized model (pass allow_uninitialized=True / "
            "--allow-uninitialized to override)"
        )
    model, report = bootstrap_model(cfg, device, checkpoint=ckpt)
    if report is not None:
        missing = live_missing_keys(model, report)
        if missing:
            raise ValueError(
                f"checkpoint {ckpt} leaves {len(missing)} weights of the model "
                f"unset (e.g. {missing[:3]}); refusing to serve it")
    service = DepthService(model, cfg, device, max_batch=max_batch,
                           window_ms=window_ms, request_timeout_s=request_timeout_s,
                           pipeline=pipeline)
    if warmup:
        service.warmup()
    return service


def build_service_from_exported(cfg, artifact_path: str, device="cuda", window_ms: float = 5.0,
                                warmup: bool = True,
                                request_timeout_s: float = 300.0) -> DepthService:
    """Serve an archive of train/export.py on ``device``: no model is built and
    no checkpoint read. The batcher's buckets are exactly the archive's, its
    native size must be the config's, and the model name is the archive's.
    TF32 is turned off as in ``build_service``: it is a process setting that
    an exported graph does not carry."""
    from ..train.export import load_exported

    set_float32_precision()
    predictor = load_exported(artifact_path, device)
    meta = predictor.meta
    if list(meta["native_size"]) != [int(s) for s in cfg.framework.native_size]:
        raise ValueError(f"artifact native_size {meta['native_size']} != config "
                         f"{list(cfg.framework.native_size)}")
    service = DepthService(None, cfg, device, max_batch=max(predictor.batch_sizes),
                           window_ms=window_ms, request_timeout_s=request_timeout_s,
                           predict_many=predictor.predict)
    if tuple(service.batcher.buckets) != tuple(predictor.batch_sizes):
        service.close()
        raise ValueError(
            f"artifact buckets {predictor.batch_sizes} don't match the batcher's "
            f"{service.batcher.buckets}; re-export with the standard bucket ladder "
            "(tools/export_model.py does)")
    service.model_name = str(meta["model_name"])
    if warmup:
        service.warmup()
    return service


def main():
    def extra(p):
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--port", type=int, default=8000)
        p.add_argument("--max-batch", type=int, default=8)
        p.add_argument("--window-ms", type=float, default=5.0)
        p.add_argument("--no-warmup", action="store_true")
        p.add_argument("--exported", default=None, metavar="MODEL.mdex",
                       help="serve an exported archive (python -m "
                            "mde_tpu_torch.tools.export_model) instead of building the model "
                            "and loading a checkpoint")
        p.add_argument("--request-timeout", type=float, default=300.0,
                       help="seconds a request waits for its device step")
        p.add_argument("--allow-uninitialized", action="store_true",
                       help="serve random weights when no checkpoint exists "
                            "(dev/smoke only)")
        p.add_argument("--no-pipeline", action="store_true",
                       help="disable double-buffered batch dispatch (batches "
                            "then run strictly one at a time)")

    cfg, args = parse_config("Depth inference server", extra=extra)
    if args.exported:
        service = build_service_from_exported(cfg, args.exported, args.device, args.window_ms,
                                              warmup=not args.no_warmup,
                                              request_timeout_s=args.request_timeout)
    else:
        service = build_service(cfg, args.device, args.max_batch, args.window_ms,
                                warmup=not args.no_warmup,
                                request_timeout_s=args.request_timeout,
                                allow_uninitialized=args.allow_uninitialized,
                                pipeline=not args.no_pipeline)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))

    import signal

    def _term(signum, frame):  # production supervisors stop with SIGTERM
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    print(f"serving {service.model_name} on http://{args.host}:{args.port} "
          f"(device {service.device}, buckets {service.batcher.buckets})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
        server.server_close()


if __name__ == "__main__":
    main()
