"""Smoke run of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build    nvcc builds the port's kernels from mde_tpu_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card, at the
              serving and training paths' shapes: errors and CUDA-event median
              times (K1 float32 and bf16, K3, K2 forward and backward);
  4. serve    the flagship (MiDaS-small + DINOv2 ViT-S/14 at full width, random
              weights from a seed, saved and loaded as a checkpoint) behind the
              port's HTTP server, answering concurrent .npy requests; replies are
              checked for shape and finiteness, against the plain-version predict
              step on the card and against the CPU; the kernels' launch counters
              must have risen while the requests were served;
  5. train    the flagship at full width, batch 4: (a) one float32 train step
              through the kernels against the same step through the plain
              versions (loss and gradients); (b) two bf16 autocast steps; (c) the
              training CLI for 2 epochs on generated data, with its checkpoint
              and test predictions checked and every training kernel launched;
              (d) the train step's CUDA-event times, peak memory and the
              profiler's split of its device time.
Then a line with every kernel's numbers, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once where no CUDA device is visible.
"""

from __future__ import annotations

import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
K1_SOURCE = "mde_tpu_torch/csrc/window_attention.cu"
K3_SOURCE = "mde_tpu_torch/csrc/preprocess.cu"
K2_SOURCE = "mde_tpu_torch/csrc/si_loss.cu"
K1_REPLACES = "mde_tpu/ops/pallas_kernels.py:202"
K2_REPLACES = "mde_tpu/ops/pallas_kernels.py:111"
K2_BWD_REPLACES = "mde_tpu/ops/pallas_kernels.py:130"
K3_REPLACES = "mde_tpu/ops/pallas_kernels.py:240"
TOL_KERNEL = 1e-5  # kernel vs plain, float32, same inputs
TOL_K2 = 1e-5  # K2 sums relative; backward max-abs over the plain gradient's max-abs
TOL_K1_BF16 = 1e-2  # max-abs, about one bf16 ulp at |out| ~ 2
# Kernel path vs plain path, one float32 train step: the loss, and the
# gradients' rel-L2 globally and per top-level module, the noise band of the
# flagship's gradient (tests/test_train_parity.py:444-457).
TOL_TRAIN_LOSS = 1e-4
TOL_GRAD_GLOBAL, TOL_GRAD_SUBTREE = 0.15, 0.3
TOL_BF16_LOSS = 2e-2  # bf16 step-0 loss vs the float32 one, relative
TRAIN_SHAPE = (4, 426, 560)  # batch, native height and width
TOL_SERVED = 1e-4  # served reply vs plain-version predict step on the card
# The same, relative to the reply's spread (max - min): random weights give
# depths close to a constant, so an absolute bound alone would say little.
TOL_SERVED_SPREAD = 1e-3
N_CLIENTS, N_PER_CLIENT = 6, 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return kind, smi


def phase_build() -> None:
    from mde_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    emit({"phase": "build", "library": so.name, "seconds": time.perf_counter() - t0,
          "nvcc_seconds": kernels.build_seconds})


def phase_kernels() -> dict:
    from mde_tpu_torch.ops import kernels as K
    from mde_tpu_torch.ops.window_attention import _window_key_validity

    g = torch.Generator().manual_seed(SEED)
    dev = "cuda"
    results = {}
    k1_cases = [
        # the flagship: 56x72 grid padded to 64x80, ragged right/bottom windows
        ("flagship", (2, 20, 256, 32), 8, _window_key_validity(56, 72, 64, 80, 16)),
        ("aligned", (1, 4, 64, 32), 4, _window_key_validity(16, 16, 16, 16, 8)),
    ]
    for label, shape, heads, mask in k1_cases:
        q, k, v = (torch.randn(shape, generator=g).to(dev) for _ in range(3))
        m = torch.from_numpy(mask).to(dev)
        got = K.window_attention(q, k, v, heads, m)
        want = K.window_attention_plain(q, k, v, heads, m)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: K.window_attention(q, k, v, heads, m))
        plain_ms = cuda_ms(lambda: K.window_attention_plain(q, k, v, heads, m))
        emit({"phase": "kernels", "kernel": "window_attention", "case": label,
              "shape": list(shape), "heads": heads, "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms})
        check(bool(torch.isfinite(got).all()), f"window_attention {label}: non-finite output")
        check(err <= TOL_KERNEL, f"window_attention {label}: max-abs {err} > {TOL_KERNEL}")
        results.setdefault("window_attention", dict(max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # K1 bf16 at the train step's flagship shape, against the plain version
    # fed the same bf16 inputs (it computes in float32 and rounds once).
    shape, heads, mask = (4, 20, 256, 32), 8, _window_key_validity(56, 72, 64, 80, 16)
    q, k, v = (torch.randn(shape, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    m = torch.from_numpy(mask).to(dev)
    got = K.window_attention(q, k, v, heads, m)
    want = K.window_attention_plain(q, k, v, heads, m)
    torch.cuda.synchronize()
    check(got.dtype == torch.bfloat16, f"window_attention bf16: output {got.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    ms = cuda_ms(lambda: K.window_attention(q, k, v, heads, m))
    plain_ms = cuda_ms(lambda: K.window_attention_plain(q, k, v, heads, m))
    emit({"phase": "kernels", "kernel": "window_attention_bf16", "case": "flagship_train",
          "shape": list(shape), "heads": heads, "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms})
    check(bool(torch.isfinite(got).all()), "window_attention bf16: non-finite output")
    check(err <= TOL_K1_BF16, f"window_attention bf16: max-abs {err} > {TOL_K1_BF16}")
    results["window_attention_bf16"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # K2 at the train step's shape (n = 126 * 2048 a sample), and at ragged
    # shapes whose last chunk is masked by index (one chunk, several chunks),
    # with the target's gradient too. Times at the train step's shape only.
    for label, shape in (("flagship_train", (4, 448, 576)), ("ragged", (3, 1001)),
                         ("ragged_chunks", (2, 5000))):
        results.update(_check_k2(K, label, shape, g, timed=label == "flagship_train"))

    rgb = torch.randint(0, 256, (4, 426, 560, 3), dtype=torch.uint8, generator=g).to(dev)
    got = K.preprocess_u8(rgb, (448, 576))
    want = K.preprocess_u8_plain(rgb, (448, 576))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ms = cuda_ms(lambda: K.preprocess_u8(rgb, (448, 576)))
    plain_ms = cuda_ms(lambda: K.preprocess_u8_plain(rgb, (448, 576)))
    emit({"phase": "kernels", "kernel": "preprocess_u8", "case": "flagship",
          "shape": [4, 426, 560, 3], "out": list(got.shape), "max_abs_err": err, "ms": ms,
          "plain_ms": plain_ms})
    check(tuple(got.shape) == (4, 3, 448, 576), f"preprocess_u8: shape {tuple(got.shape)}")
    check(err <= TOL_KERNEL, f"preprocess_u8: max-abs {err} > {TOL_KERNEL}")
    results["preprocess_u8"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


def _check_k2(K, label: str, shape, g, timed: bool) -> dict:
    """K2 forward and backward against the plain version: positive depths and
    a log-ratio with a non-zero mean and a spread, so neither sum is near zero
    or constant. Returns the numbers of a timed case."""
    dev, b = "cuda", shape[0]
    target = torch.rand(shape, generator=g) * 9.9 + 0.1
    pred = target * torch.exp(0.3 + 0.5 * torch.randn(shape, generator=g))
    pred, target = pred.to(dev), target.to(dev)
    s1, s2 = K.si_loss_sums(pred, target)
    r1, r2 = K.si_loss_sums_plain(pred, target)
    torch.cuda.synchronize()
    rel = max(((s1 - r1).abs() / r1.abs()).max().item(), ((s2 - r2).abs() / r2.abs()).max().item())
    err = max((s1 - r1).abs().max().item(), (s2 - r2).abs().max().item())
    fwd = dict(max_abs_err=err, max_rel_err=rel)
    if timed:
        fwd.update(ms=cuda_ms(lambda: K.si_loss_sums(pred, target)),
                   plain_ms=cuda_ms(lambda: K.si_loss_sums_plain(pred, target)))
    emit({"phase": "kernels", "kernel": "si_loss_sums", "case": label, "shape": list(shape),
          "sums": [r1.tolist(), r2.tolist()], **fwd})
    check(rel <= TOL_K2, f"si_loss_sums {label}: relative error {rel} > {TOL_K2}")

    # The train step never needs the target's gradient; the ragged cases check it too.
    need_target = not timed
    g1 = torch.randn(b, generator=g).to(dev)
    g2 = torch.randn(b, generator=g).to(dev)
    got = K._si_loss_sums_backward(pred, target, g1, g2, 1e-6, need_target)
    leaves = [x.clone().requires_grad_() for x in (pred, target)]
    a1, a2 = K.si_loss_sums_plain(*leaves)
    want = torch.autograd.grad((a1 * g1).sum() + (a2 * g2).sum(),
                               leaves if need_target else leaves[:1])
    torch.cuda.synchronize()
    err = max((x - y).abs().max().item() for x, y in zip(got, want))
    rel = max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(got, want))
    bwd = dict(max_abs_err=err, max_rel_err=rel)
    if timed:
        bwd.update(
            ms=cuda_ms(lambda: K._si_loss_sums_backward(pred, target, g1, g2, 1e-6, False)),
            plain_ms=cuda_ms(
                lambda: K.si_loss_sums_backward_plain(pred, target, g1, g2, 1e-6, False)))
    emit({"phase": "kernels", "kernel": "si_loss_sums_backward", "case": label,
          "shape": list(shape), "dtarget": need_target, **bwd})
    check(rel <= TOL_K2, f"si_loss_sums backward {label}: max-abs over max-abs {rel} > {TOL_K2}")
    return {"si_loss_sums": fwd, "si_loss_sums_backward": bwd} if timed else {}


def _post(url: str, body: bytes):
    req = urllib.request.Request(url + "/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def phase_serve() -> dict:
    from http.server import ThreadingHTTPServer

    from mde_tpu_torch.core import config
    from mde_tpu_torch.models.factory import build_model
    from mde_tpu_torch.ops import kernels as K
    from mde_tpu_torch.tools.common import bootstrap_model
    from mde_tpu_torch.tools.serve import build_service, make_handler
    from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
    from mde_tpu_torch.train.trainer import make_predict_step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg = config.defaults()  # the flagship: 448x576 input, DINOv2 at 224x280
        cfg.paths.results_dir = tmp
        ckpt = checkpoint_path(tmp, cfg.experiment.model_name)
        model = build_model(cfg.model, "cpu", torch.Generator().manual_seed(SEED))
        save_checkpoint(ckpt, model)
        del model

        t0 = time.perf_counter()
        service = build_service(cfg, "cuda", max_batch=8, window_ms=5.0, warmup=True)
        start_s = time.perf_counter() - t0
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
        server_thread = threading.Thread(target=server.serve_forever, daemon=True)
        server_thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            rng = np.random.default_rng(SEED)
            h, w = service.native
            images = rng.integers(0, 256, (N_CLIENTS * N_PER_CLIENT, h, w, 3), dtype=np.uint8)
            bodies = []
            for img in images:
                buf = io.BytesIO()
                np.save(buf, img)
                bodies.append(buf.getvalue())
            replies = [None] * len(bodies)
            errors = []
            barrier = threading.Barrier(N_CLIENTS)

            def client(c: int):
                try:
                    barrier.wait(timeout=60)
                    for i in range(c, len(bodies), N_CLIENTS):
                        replies[i] = _post(url, bodies[i])
                except Exception as e:  # reported below; a thread must not die silently
                    errors.append(f"client {c}: {type(e).__name__}: {e}")

            K.window_attention.launches = 0
            K.preprocess_u8.launches = 0
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            serve_s = time.perf_counter() - t0
            launches = {"window_attention": K.window_attention.launches,
                        "preprocess_u8": K.preprocess_u8.launches}
            check(not errors, f"client errors: {errors}")
            check(all(not t.is_alive() for t in threads), "a client thread did not finish")

            depths, batch_sizes = [], []
            for status, body, headers in replies:
                check(status == 200, f"HTTP {status}: {body[:200]!r}")
                d = np.load(io.BytesIO(body))
                check(d.shape == (426, 560) and d.dtype == np.float32,
                      f"reply {d.shape} {d.dtype}, want (426, 560) float32")
                check(bool(np.isfinite(d).all()), "non-finite depth in a reply")
                depths.append(d)
                batch_sizes.append(int(headers["X-Batch-Size"]))
            check(max(batch_sizes) > 1, f"no request was coalesced: {batch_sizes}")
            for name, n in launches.items():
                check(n > 0, f"{name} was not launched while the requests were served")

            # The same weights, run through the plain versions on the card and on the CPU.
            ref_model, report = bootstrap_model(cfg, "cuda", checkpoint=ckpt)
            check(report is not None and not report["shape_mismatch"], "checkpoint reload failed")
            plain_step = make_predict_step(ref_model, cfg, plain=True)
            x = torch.from_numpy(images[:1]).cuda()
            plain = plain_step(x).cpu().numpy()[0]
            served_err = float(np.abs(plain - depths[0]).max())
            spread = float(plain.max() - plain.min())
            check(served_err <= TOL_SERVED and served_err <= TOL_SERVED_SPREAD * spread,
                  f"served reply vs plain predict step: max-abs {served_err}, spread {spread}")
            cpu_model, _ = bootstrap_model(cfg, "cpu", checkpoint=ckpt)
            cpu = make_predict_step(cpu_model, cfg)(torch.from_numpy(images[:1])).numpy()[0]
            cpu_err = float(np.abs(cpu - depths[0]).max())
            check(np.allclose(depths[0], cpu, rtol=2e-3, atol=2e-4),
                  f"served reply vs CPU predict step: max-abs {cpu_err}")

            bucket_ms = {}
            for b in service.batcher.buckets:
                batch = np.zeros((b, h, w, 3), np.uint8)
                times = []
                for _ in range(5):
                    t1 = time.perf_counter()
                    service._predict_many(batch)  # ends in a device-to-host copy
                    times.append((time.perf_counter() - t1) * 1e3)
                bucket_ms[str(b)] = statistics.median(times)
            out = {"phase": "serve", "requests": len(replies), "clients": N_CLIENTS,
                   "start_s": start_s, "serve_s": serve_s, "batch_sizes": batch_sizes,
                   "stats": dict(service.batcher.stats), "launches": launches,
                   "served_vs_plain_max_abs": served_err, "served_vs_cpu_max_abs": cpu_err,
                   "depth_mean": float(np.mean(depths)), "depth_spread": spread,
                   "predict_ms_by_bucket": bucket_ms}
            emit(out)
            return launches
        finally:
            server.shutdown()
            server.server_close()
            service.close()

def _rel_l2(a: torch.Tensor, b: torch.Tensor, floor: float = 0.0) -> float:
    return ((a - b).norm() / max(b.norm().item(), floor)).item()


def _grad_gaps(model_k, model_p) -> dict:
    """Gradient rel-L2 of the kernel path against the plain path, globally and
    per top-level module (denominator floored at 1% of the global norm, as
    tests/test_train_parity.py:564-566, so a near-zero subtree cannot flag)."""
    plain = dict(model_p.named_parameters())
    grads = {}
    for name, p in model_k.named_parameters():
        if p.grad is not None:
            grads.setdefault(name.split(".", 1)[0], []).append(
                (p.grad.double().flatten(), plain[name].grad.double().flatten()))
    allk = torch.cat([gk for pairs in grads.values() for gk, _ in pairs])
    allp = torch.cat([gp for pairs in grads.values() for _, gp in pairs])
    gnorm = allp.norm().item()
    out = {"global": _rel_l2(allk, allp, 1e-12)}
    for top, pairs in sorted(grads.items()):
        out[top] = _rel_l2(torch.cat([gk for gk, _ in pairs]), torch.cat([gp for _, gp in pairs]),
                           1e-2 * gnorm)
    return out


def _profile_step(step, step_ms: float) -> dict:
    """One step under torch.profiler: the kernels' device time against the
    step's CUDA-event time (``step_ms``, measured without the profiler, whose
    own overhead stretches the traced step), and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    if not rows:
        return {"device_ms": "not measured"}
    device_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    ours = {o: [0.0, 0] for o in ("window_attention_kernel", "si_partial_kernel",
                                  "si_finish_kernel", "si_backward_kernel")}
    for name, ms, n in rows:
        for o, acc in ours.items():
            if o in name:
                acc[0] += ms
                acc[1] += n
    return {"device_ms": device_ms, "busy_share_of_step": device_ms / step_ms,
            "launches": sum(r[2] for r in rows),
            "our_kernels": ours,
            "our_kernels_share": sum(ms for ms, _ in ours.values()) / device_ms,
            "top": [[name[:90], ms, n] for name, ms, n in rows[:12]]}


def phase_train() -> dict:
    from mde_tpu_torch.core import config
    from mde_tpu_torch.data import synthetic
    from mde_tpu_torch.data.transforms import preprocess_train
    from mde_tpu_torch.models.factory import build_model
    from mde_tpu_torch.ops import kernels as K
    from mde_tpu_torch.tools import main as train_cli
    from mde_tpu_torch.tools.common import bootstrap_model, live_missing_keys
    from mde_tpu_torch.train.checkpoint import checkpoint_path, load_training_checkpoint
    from mde_tpu_torch.train.checkpoint import TRAINING_KEYS
    from mde_tpu_torch.train.trainer import (forward_backward, make_optimizer, make_train_step,
                                             step_generator)

    cfg = config.defaults()  # the flagship, bf16 compute
    cfg32 = config.defaults()
    cfg32.framework.compute_dtype = "float32"
    model = build_model(cfg.model, "cpu", torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # Start the depth head comfortably positive, as tests/test_train_parity.py
        # does: at random init most pre-ReLU depths sit at the ReLU cliff, where
        # the loss gradient is ~1/(pred + 1e-6) and the comparison says nothing.
        model.depth_head[1].bias.add_(2.0)
    model = model.cuda()
    init_state = copy.deepcopy(model.state_dict())
    rng = np.random.default_rng(SEED)
    samples = [synthetic.make_sample(rng, *TRAIN_SHAPE[1:]) for _ in range(TRAIN_SHAPE[0])]
    rgb_u8 = torch.from_numpy(np.stack([s_[0] for s_ in samples])).cuda()
    depth_raw = torch.from_numpy(np.stack([s_[1] for s_ in samples])).cuda()
    out = {"phase": "train", "batch": TRAIN_SHAPE[0], "input_size": list(cfg.framework.input_size)}

    # (a) one float32 step, kernels vs plain, on the same jittered inputs
    rgb, depth = preprocess_train(rgb_u8, depth_raw, (448, 576), generator=step_generator(SEED, 0, 0))
    model_plain = copy.deepcopy(model)
    for counter in ("launches", "bf16_launches"):
        setattr(K.window_attention, counter, 0)
    K.si_loss_sums.launches = K.si_loss_sums.backward_launches = 0
    loss_k, _ = forward_backward(model, cfg32, rgb, depth)
    launches_a = {"window_attention": K.window_attention.launches,
                  "si_loss_sums": K.si_loss_sums.launches,
                  "si_loss_sums_backward": K.si_loss_sums.backward_launches}
    loss_p, _ = forward_backward(model_plain, cfg32, rgb, depth, plain=True)
    check(K.si_loss_sums.launches == launches_a["si_loss_sums"],
          "the plain path launched a kernel")
    loss_k, loss_p = loss_k.item(), loss_p.item()
    gaps = _grad_gaps(model, model_plain)
    out["a_fp32_kernels_vs_plain"] = {"loss_kernels": loss_k, "loss_plain": loss_p,
                                      "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                                      "grad_rel_l2": gaps, "launches": launches_a}
    emit({"phase": "train", "check": "a", **out["a_fp32_kernels_vs_plain"]})
    check(all(np.isfinite([loss_k, loss_p])), f"non-finite loss {loss_k}, {loss_p}")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS * abs(loss_p),
          f"train loss kernels {loss_k} vs plain {loss_p}")
    check(gaps["global"] < TOL_GRAD_GLOBAL, f"global gradient rel-L2 {gaps['global']}")
    bad = {k: v for k, v in gaps.items() if k != "global" and v >= TOL_GRAD_SUBTREE}
    check(not bad, f"subtree gradient rel-L2 above {TOL_GRAD_SUBTREE}: {bad}")
    check(all(n > 0 for n in launches_a.values()), f"a kernel was not launched: {launches_a}")
    make_optimizer(model, cfg32).step()
    del model_plain

    # (b) two bf16 autocast steps from the same weights
    model.load_state_dict(init_state)
    K.window_attention.bf16_launches = 0
    step16 = make_train_step(model, cfg, make_optimizer(model, cfg))
    losses16 = [step16(rgb_u8, depth_raw, step_generator(SEED, 0, i))["loss"].item()
                for i in range(2)]
    out["b_bf16"] = {"losses": losses16, "fp32_step0_loss": loss_k,
                     "step0_rel": abs(losses16[0] - loss_k) / abs(loss_k),
                     "bf16_launches": K.window_attention.bf16_launches}
    emit({"phase": "train", "check": "b", **out["b_bf16"]})
    check(all(np.isfinite(losses16)), f"non-finite bf16 losses {losses16}")
    check(K.window_attention.bf16_launches > 0, "the bf16 window attention was not launched")
    check(abs(losses16[0] - loss_k) <= TOL_BF16_LOSS * abs(loss_k),
          f"bf16 step-0 loss {losses16[0]} vs float32 {loss_k}")

    # (d) the train step's times and peak memory, each dtype in turn
    timing = {}
    for name, c in (("fp32", cfg32), ("bf16", cfg)):
        model.load_state_dict(init_state)
        step = make_train_step(model, c, make_optimizer(model, c))
        gen = step_generator(SEED, 1, 0)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(rgb_u8, depth_raw, gen), reps=8, warmup=2)
        timing[name] = {"step_ms": ms, "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                        "profile": _profile_step(lambda: step(rgb_u8, depth_raw, gen), ms)}
    out["d_timing"] = timing
    emit({"phase": "train", "check": "d", "train_step_ms": {k: v["step_ms"] for k, v in timing.items()},
          "peak_mib": {k: v["peak_mib"] for k, v in timing.items()},
          "profile": {k: v["profile"] for k, v in timing.items()}})
    del model, step, step16

    # (c) the training CLI, end to end, on generated data
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data = os.path.join(tmp, "data")
        synthetic.generate(data, n_train=16, n_test=4, size=TRAIN_SHAPE[1:], seed=SEED)
        results, preds = os.path.join(tmp, "results"), os.path.join(tmp, "predictions")
        argv = ["--device", "cuda", "--data-dir", data, "--set", "training.n_epoch=2",
                "--set", f"paths.results_dir={results}", "--set", f"paths.predictions_dir={preds}",
                "--set", "experiment.wandb_disable=true"]
        counters = ((K.window_attention, "launches"), (K.window_attention, "bf16_launches"),
                    (K.si_loss_sums, "launches"), (K.si_loss_sums, "backward_launches"),
                    (K.preprocess_u8, "launches"))
        for fn, attr in counters:
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        history = train_cli.main(argv)
        cli_s = time.perf_counter() - t0
        launches = {"window_attention": K.window_attention.launches,
                    "window_attention_bf16": K.window_attention.bf16_launches,
                    "si_loss_sums": K.si_loss_sums.launches,
                    "si_loss_sums_backward": K.si_loss_sums.backward_launches,
                    "preprocess_u8": K.preprocess_u8.launches}
        ckpt = checkpoint_path(results, cfg.experiment.model_name)
        check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
        payload = load_training_checkpoint(ckpt)
        check(set(TRAINING_KEYS) <= set(payload), f"checkpoint keys {sorted(payload)}")
        _, report = bootstrap_model(cfg, "cuda", checkpoint=ckpt)
        missing = live_missing_keys(report)
        check(not report["shape_mismatch"] and not missing,
              f"checkpoint reload: {report['shape_mismatch'][:5]} {missing[:5]}")
        files = sorted(os.listdir(preds))
        arrays = [np.load(os.path.join(preds, f)) for f in files]
        out["c_cli"] = {"seconds": cli_s, "history": history, "launches": launches,
                        "predictions": len(files), "checkpoint_epoch": payload["epoch"]}
        emit({"phase": "train", "check": "c", **out["c_cli"]})
        check(len(history["train_loss"]) == 2, f"epochs run: {history}")
        check(all(np.isfinite(history["train_loss"] + history["val_loss"])),
              f"non-finite losses {history}")
        check(len(arrays) == 4 and all(a.shape == (426, 560) and np.isfinite(a).all()
                                       for a in arrays),
              f"predictions {[(f, a.shape) for f, a in zip(files, arrays)]}")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched during the training run")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 1
    os.environ["WANDB_MODE"] = "disabled"  # no experiment tracker may reach the network
    kind, _ = phase_device()
    phase_build()
    kernels = phase_kernels()
    served = phase_serve()
    trained = phase_train()
    rows = []
    for name, source, replaces in (
            ("window_attention", K1_SOURCE, K1_REPLACES),
            ("window_attention_bf16", K1_SOURCE, K1_REPLACES),
            ("preprocess_u8", K3_SOURCE, K3_REPLACES),
            ("si_loss_sums", K2_SOURCE, K2_REPLACES),
            ("si_loss_sums_backward", K2_SOURCE, K2_BWD_REPLACES)):
        by_path = {"serve": served.get(name, 0), "train": trained[name]}
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(by_path.values()), "launches_by_path": by_path,
                     **kernels[name]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
