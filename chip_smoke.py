"""Smoke run of the PyTorch port's serving, training, tool and augmentation
paths on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --k4-backward-only   # K4's backward checks and times alone
    python3 chip_smoke.py --k2-only            # K2's checks and times alone
    python3 chip_smoke.py --parallel-only      # the data-parallel phase alone
    python3 chip_smoke.py --zoo-only           # the zoo phase alone

Two models, each at full width with random weights from a seed: the flagship
(MiDaS-small + DINOv2 ViT-S/14 branch, 448x576) and Depth-Anything-V2-S
(DINOv2 ViT-S/14 trunk + DPT head at 448x588, selected by the two ``--set``
overrides in ``DA2_SETS``); then the rest of the model zoo (phase 9). Every
LayerScale gamma is drawn in [0.2, 0.8]: fresh ones are 1e-5 and would hide
what the attention computes.

Phases, each printing JSON lines:
  1. device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build    nvcc builds the port's kernels from mde_tpu_torch/csrc;
  3. kernels  each kernel against its plain PyTorch version on the card, at the
              serving and training paths' shapes: errors, per-call CUDA-event
              median times (``ms``, host launch included), device times over
              50 back-to-back launches (``device_ms``), the least time the card
              could take for the same work (``bound_ms``, bytes or operations
              over the H100's published peaks; K1's forward also one
              exponential a pair at the SFUs' rate and the card's maximum SM
              clock), ``bound_share`` against the profiler's time where it was
              measured, one PyTorch call computing the same function as a
              yardstick (``library_ms``; the port never calls it), and the
              kernel time per call from the profiler (``profiler_ms``). K1
              float32 (timed at predict batch 2 and serving bucket 1) and bf16;
              K1's forward and backward kernels in both types at six shapes:
              the forward's output against the plain version, the same bits
              twice and with and without its row statistics, which are checked
              against the plain version's (-FLT_MAX exactly in a window with no
              valid key), the forward's time both ways, and the backward fed
              those statistics against autograd through the plain version; K3
              at both models' sizes, serving bucket 1 (timed too) and four
              shapes of its other paths (unaligned rows, a ragged width, rows
              too wide to stage, an output larger than one cooperative grid),
              the same bits twice; K3's train form (the colour jitter inside)
              at the same shapes and over all 24 orders, with the plan each
              shape chose (one cooperative launch, or two launches at the last
              two shapes), and the wrapper refusing
              draws on the card or an order that is not a permutation; K2
              forward and backward,
              K4 float32 and bf16 at six shapes, and K4's backward kernel in
              both types at eleven shapes (DA-V2-S and DA-V2-B training,
              DA-V2-L, the flagship's branch, ragged, one block, and N one
              below, at and one above 64 and 128 rows) against autograd
              through the plain version, with each pass's profiler time,
              ptxas's registers and spills and the launch plan (rows and
              shared bytes a block, blocks an SM) at DA-V2-S's shape; K4
              in both directions also at DPT_Large's and DPT_Hybrid's
              training shapes ((4, 1009, 16|12, 64), profiled, a row's
              ``dpt`` entry);
  4. serve    for each model: a checkpoint behind the port's HTTP server,
              built with both TF32 flags at torch's defaults (the server must
              turn them off), answering concurrent .npy requests with no K1
              statistics written; replies are checked for shape
              and finiteness, against the plain-version predict step on the card
              and against the CPU; the path's kernels, and no other, must have
              been launched while the requests were served; the predict step's
              host time by bucket, at buckets 1 and 8 against the plain
              versions, and its CUDA-event time and profiler split there;
  5. train    for each model at batch 4: (a) the train preprocessing through
              its kernel against its plain version on the same draws, then one
              float32 train step through the kernels against the same step
              through the plain versions (loss and gradients); (b) two bf16
              autocast steps; (d) the train step's CUDA-event times, peak
              memory and the profiler's split of its device time, with its
              counts of launches and of pageable host-to-card copies (and no
              pinned one: K3's draws go by value); (c) the
              training CLI for 2 epochs on generated data, with its checkpoint
              and test predictions checked and every kernel of the path
              launched. DA-V2's train steps must launch K4's backward once per
              attention block a step, and no softmax backward; the flagship's
              frozen DINOv2 launches none, and its steps launch K1's backward
              once per cross-attention a step and run no plain K1 recompute.
  6. tools    for each model, inside train (c)'s directory (the working
              directory changed there and back) on the checkpoint (c) wrote:
              the evaluation tool (its printed metrics finite and equal to
              evaluate() on the reloaded model, its trainable count the JAX
              tool's), the prediction tool (four finite native-size .npy
              equal to (c)'s, and a predictions.csv whose rows decode to
              "%.2f" of their rounded values) and the visualisation tool on
              two samples (its PNGs; where matplotlib is absent, its arrays
              and a line that says so), each timed; they launch K1's, K3's
              eval form's, K4's and K2's forwards and no backward;
  7. augment  the flagship's PairAug path at batch 4: (a) the pipeline on
              the card against the CPU with the same draws and noise, with
              the step's gates and with every stage on; (b) its CUDA-event
              time, launches and copies; (c) three bf16 train steps with
              augmentation: True, one K2 forward and backward a step, K1's
              forward and backward, no K3 train form; (d) the augmented step
              against the default one in turns with the port's StepTimer,
              peak memory from device_memory_stats, and at most two pageable
              host-to-card copies a step;
  8. export   for each model, inside train (c)'s directory: the export CLI
              writes an archive (flagship buckets 1-8 on (c)'s checkpoint,
              DA-V2-S 1-2 on the serve phase's weights), with its seconds a
              bucket and its MB beside the state_dict's; a fresh interpreter
              loads it with no model code and predicts each bucket, held
              against the live predict step with the same launches (K3 1,
              K1 1, K4 12 a call; no plain version's operation); host ms in
              turns against the live step; then build_service_from_exported
              serves it over HTTP to concurrent clients. Before the models,
              op_dispatch: the host us of a call through each torch.library
              op against its CUDA implementation called directly.
  9. zoo      the rest of the factory's models at full width and 448x576,
              each selected by its ``--set``s (``ZOO``): MiDaS-small,
              MiDaS-small + LocalBins + DGR, the flagship + LocalBins,
              U-Net, MiDaS (ResNeXt101), DPT_Large and DPT_Hybrid. Serve:
              build_service at buckets (1, 2) over HTTP, two frames, the
              replies and the kernels' predict step against the
              plain-version one, host ms by bucket. Train: two float32 and
              two bf16 train steps at batch 4 against the same steps with
              plain=True on the same weights and draws (losses, gradient
              rel-L2, CUDA-event ms, peak MiB, launches a step). For
              ``ZOO_CLI`` the training CLI for one epoch and the evaluation
              tool on its checkpoint. Path ``zoo_<model>``: all of it.
 10. parallel data-parallel training (mde_tpu_torch/parallel): W ranks, one
              card each over NCCL where there are two cards or more, else
              two ranks sharing card 0 over gloo (named on the line), each
              a process of parallel.launch: three train steps at global
              batch 4 of the flagship in float32 (TF32 off) and bf16 and of
              DA-V2-S in bf16, at learning rate 0, against the one-process
              step on the same batches and generators (every step's loss,
              the last step's averaged gradient, the state after), each
              rank's launches a step (PARALLEL_STEP_LAUNCHES) and its step
              ms beside the one process's; the same runs as a world of one
              over NCCL through the same DDP code and the cross-process
              BatchNorm, the noise witness a bf16 gradient is held to; two
              flagship steps in float64 at the config's learning rate (the
              plain versions), the update under DDP against one process's;
              the cross-process BatchNorm alone in bf16 at the flagship's
              first BN layer against the layer in float64, beside cuDNN's; fit with
              generate_test_predictions on W ranks (equal histories, one
              checkpoint, a prediction an image); then the training CLI at
              W, which starts its ranks.
              Path ``parallel``: the ranks' train steps, summed over ranks.
Then a line with every kernel's numbers and its launches by path (a train
path's are those of its checks (a), (b) and (c); a tools path's those of its
three tools; an export path's one exported call a bucket), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once where no CUDA device is visible.
"""

from __future__ import annotations

import collections
import copy
import io
import json
import os
import re
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
K1_BWD_REPLACES = "mde_tpu/ops/window_attention.py:103"  # _pallas_wa_bwd, the Pallas kernel's VJP
K2_REPLACES = "mde_tpu/ops/pallas_kernels.py:111"
K2_BWD_REPLACES = "mde_tpu/ops/pallas_kernels.py:130"
K3_REPLACES = "mde_tpu/ops/pallas_kernels.py:240"
K3_TRAIN_SOURCE = "mde_tpu_torch/csrc/preprocess_train.cu"
K4_SOURCE = "mde_tpu_torch/csrc/flash_attention.cu"
K4_REPLACES = "mde_tpu/ops/flash_attention.py:58"
# (label, (B, N, H, D)): DA-V2-S serving and training at 448x588 (32x42 + 1
# tokens), DA-V2-L, the flagship's DINOv2 branch at buckets 1 and 8 (16x20 + 1
# tokens), and a ragged tile.
K4_CASES = (("da2s_serve", (1, 1345, 6, 64)), ("da2s_train", (4, 1345, 6, 64)),
            ("da2l", (1, 1345, 16, 64)), ("flagship_b1", (1, 321, 6, 64)),
            ("flagship_b8", (8, 321, 6, 64)), ("ragged", (2, 130, 6, 64)),
            ("dptl_train", (4, 1009, 16, 64)), ("dpth_train", (4, 1009, 12, 64)))
# The cases timed with the profiler too: DA-V2-S's training shape (the row's
# times), and DPT_Large's and DPT_Hybrid's at 448x576 (28x36 + 1 tokens).
K4_PROFILED = ("da2s_train", "dptl_train", "dpth_train")
# K4's backward cases: DA-V2-S and DA-V2-B training, DA-V2-L, the flagship's
# branch, ragged, a grid smaller than one wave, and N one below, at and one
# above the 64 and 128 rows a block can take.
K4_BWD_CASES = (("da2s_train", (4, 1345, 6, 64)), ("da2b_train", (4, 1345, 12, 64)),
                ("da2l", (1, 1345, 16, 64)), ("flagship_b1", (1, 321, 6, 64)),
                ("ragged", (2, 130, 6, 64)), ("one_block", (1, 65, 1, 64)),
                ("n63", (1, 63, 2, 64)), ("n64", (1, 64, 2, 64)), ("n127", (1, 127, 2, 64)),
                ("n128", (1, 128, 2, 64)), ("n129", (1, 129, 2, 64)),
                ("dptl_train", (4, 1009, 16, 64)), ("dpth_train", (4, 1009, 12, 64)))
# rel-L2 of dq/dk/dv, kernel vs autograd through the plain version, float32
# (K4's backward, and K1's)
TOL_K4_GRAD = 1e-5
# bf16: the kernel rounds P and dS to bf16 for their products (2^-9 relative
# each) and reads the bf16-rounded output for delta; the reference keeps both
# float32. Each gradient is rounded to bf16 once in both.
TOL_K4_GRAD_BF16 = 2e-2
DA2_SETS = ("model.model_type=DepthAnythingV2_vits", "framework.input_size=[448,588]")
TOL_KERNEL = 1e-5  # kernel vs plain, float32, same inputs
TOL_K2 = 1e-5  # K2 sums relative; backward max-abs over the plain gradient's max-abs
# K2's cases (label, shape, storage offset in floats), timed at the first:
# the flagship and DA-V2 train steps (vector path, a wave of tiles), n odd
# (scalar path, two tiles a sample), three ragged vector tiles, twenty
# ragged scalar tiles, and the flagship's shape with rows off 16 bytes
# (scalar path, a wave of tiles).
K2_CASES = (("flagship_train", (4, 448, 576), 0), ("da2_train", (4, 448, 588), 0),
            ("ragged", (3, 1001), 0), ("ragged_chunks", (2, 5000), 0),
            ("ragged_tiles", (5, 9999), 0), ("misaligned", (4, 448, 576), 1))
TOL_K1_BF16 = 1e-2  # max-abs, about one bf16 ulp at |out| ~ 2 (K1 and K4)
# K1's row statistics (max, 1/sum) against the plain version's, relative:
# the same float32 logits, summed in another order.
TOL_K1_STATS = 1e-5
# Kernel path vs plain path, one float32 train step: the loss, and the
# gradients' rel-L2 globally and per top-level module, the noise band of the
# flagship's gradient (tests/test_train_parity.py:444-457).
TOL_TRAIN_LOSS = 1e-4
TOL_GRAD_GLOBAL, TOL_GRAD_SUBTREE = 0.15, 0.3
TOL_BF16_LOSS = 2e-2  # bf16 step-0 loss vs the float32 one, relative
# The evaluation tool's printed metrics against evaluate() on the reloaded
# checkpoint (the same float32 computation), relative.
TOL_TOOL_METRICS = 1e-5
# The prediction tool's .npy against train (c)'s predictions of the same
# weights, max-abs in depth units: the same float32 forward, but (c) runs
# the flagship's transposed convolution with cuDNN's default algorithm,
# whose order of summation changes run to run, and the tool the
# deterministic one.
TOL_TOOL_PRED = 1e-4
# PairAug on the card against the CPU, same draws and noise: normalised RGB
# max-abs (float32 rounding of the depth resize, the contrast mean, the
# blur taps' exp, carried through the warp, up to 1/0.225 by the
# normalisation), and depth max-abs over its largest value.
TOL_PAIRAUG = 1e-4
TOL_PAIRAUG_DEPTH = 1e-5
# Pageable host-to-card copies an augmented step may make: the draws' one
# (B, 14) copy and K1's key-validity row.
MAX_PAGEABLE_AUGMENT = 2
TRAIN_SHAPE = (4, 426, 560)  # batch, native height and width
TOL_SERVED = 1e-4  # served reply vs plain-version predict step on the card
# The same, relative to the reply's spread (max - min): random weights give
# depths close to a constant, so an absolute bound alone would say little.
TOL_SERVED_SPREAD = 1e-3
N_CLIENTS, N_PER_CLIENT = 6, 4
# The export phase: the archive's buckets (--max-batch), and its exported
# predictor against the live predict step on the same checkpoint and batch,
# max-abs in depth units and relative L2: the same kernels and operations,
# but cuDNN's default algorithms may sum in another order from run to run
# (the flagship's transposed convolution; TOL_TOOL_PRED's reason).
EXPORT_MAX_BATCH = {"flagship": 8, "da2": 2}
# Two epochs on generated data leave train (c)'s DA-V2-S map at its final
# ReLU (all zeros on the card), where a comparison says nothing: the
# export phase takes the serve phase's DA-V2-S weights instead (SEED's, the
# final depth bias raised by 0.5) and the flagship's (c) checkpoint.
EXPORT_SERVE_WEIGHTS = ("da2",)
TOL_EXPORT = 1e-4
TOL_EXPORT_REL_L2 = 1e-5
# Each bucket's program launches what the live step launches, once a call:
# K3's eval form, K1 float32 once a cross-attention, K4 float32 once a DINOv2
# block; no other kernel.
EXPORT_BUCKET_LAUNCHES = {
    "flagship": {"preprocess_u8": 1, "window_attention": 1, "flash_attention": 12},
    "da2": {"preprocess_u8": 1, "flash_attention": 12},
}
# The plain versions' signature operations (K4's softmax, K1's amax): an
# exported program whose graph held a plain version would run one.
PLAIN_OPS = ("aten::_softmax", "aten::softmax", "aten::amax")
# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet): a
# bound is the larger of bytes over the memory rate and operations over the
# rate of the type they run in.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# Exponentials (MUFU.EX2) an SM issues a clock on Hopper; times the card's SM
# count and its maximum SM clock (nvidia-smi, read in phase_device) this is
# the exponential rate that bounds K1's forward.
SFU_EX2_PER_CLOCK = 16
SM_CLOCK_HZ = None  # set by phase_device


# K2's forward before its redesign: two launches (the parent's tree in a
# comparison in turns).
K2_PARENT_NAMES = ("si_partial_kernel", "si_finish_kernel")
# The keys every row of the final kernels line carries.
ROW_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "device_ms", "profiler_ms", "bound_ms", "bound_by", "library_ms"}
# The device kernels each wrapper launches, as the profiler names them: a
# row's ``profiler_ms`` is their device time per call.
KERNEL_NAMES = {
    "window_attention": ("window_attention_kernel",),
    "window_attention_backward": ("window_attention_backward_kernel",),
    "preprocess_u8": ("preprocess_u8_kernel",),
    "preprocess_u8_train": ("preprocess_train_kernel",),
    "si_loss_sums": ("si_sums_kernel",),
    "si_loss_sums_backward": ("si_backward_kernel",),
    "flash_attention": ("flash_attention_kernel",),
    "flash_attention_backward": ("flash_attention_delta_kernel", "flash_attention_dkdv_kernel",
                                 "flash_attention_dq_kernel"),
}


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


def device_ms(fn, n: int = 50, warmup: int = 3) -> float:
    """Device time per call: CUDA events around ``n`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def bound(flop: float, nbytes: float, rate: str) -> dict:
    """The least time the card could take: ``flop`` operations at the peak of
    ``rate`` against ``nbytes`` (each input read once, each output written
    once) at the memory rate, whichever is larger."""
    ops_ms = flop / PEAK_FLOPS[rate] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def profiled(fn, n: int = 1):
    """torch.profiler's key_averages over ``n`` calls of ``fn``, recorded
    after a warm-up window of ``n`` calls: a window's first device records
    can be lost while the tracer starts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return prof.key_averages()


def profiler_ms(fn, names, n: int = 20):
    """Device time per call of the kernels whose names contain one of
    ``names``, from the profiler over ``n`` calls: the kernels' own time,
    without the host's launch gaps that ``device_ms`` reads below about
    0.08 ms. A window that recorded none of them (the tracer drops one at
    times) is taken again, twice at most; then "not measured"."""
    for _ in range(3):
        total = sum(e.device_time_total for e in profiled(fn, n)
                    if str(getattr(e, "device_type", "")).endswith("CUDA")
                    and any(name in e.key for name in names))
        if total > 0:
            return total / 1e3 / n
    return "not measured"


def profiler_split_ms(fn, names, n: int = 20) -> dict:
    """Device time per call of each kernel in ``names`` (matched as in
    ``profiler_ms``), from one profiler window over ``n`` calls; a window that
    recorded one of them as nothing is taken again, twice at most; then "not
    measured"."""
    for _ in range(3):
        events = [e for e in profiled(fn, n)
                  if str(getattr(e, "device_type", "")).endswith("CUDA")]
        split = {name: sum(e.device_time_total for e in events if name in e.key) / 1e3 / n
                 for name in names}
        if all(ms > 0 for ms in split.values()):
            return split
    return dict.fromkeys(names, "not measured")


def timings(kernel_fn, plain_fn, library_fn, work: dict, names=None, profiler_n: int = 20) -> dict:
    """Per-call and back-to-back times of a kernel, its plain version and its
    library yardstick (None where no one PyTorch call computes the function),
    beside the bound ``work``; with ``names``, the kernels' profiler time over
    ``profiler_n`` calls."""
    out = {"ms": cuda_ms(kernel_fn), "plain_ms": cuda_ms(plain_fn),
           "device_ms": device_ms(kernel_fn), "plain_device_ms": device_ms(plain_fn),
           "library_ms": None if library_fn is None else device_ms(library_fn), **work}
    if names:
        out["profiler_ms"] = profiler_ms(kernel_fn, names, profiler_n)
    # against the kernels' own time where the profiler gave it: below about
    # 0.08 ms device_ms reads the host's launch rate
    basis = "profiler_ms" if isinstance(out.get("profiler_ms"), float) else "device_ms"
    out["bound_share"] = out["bound_ms"] / out[basis]
    out["bound_share_of"] = basis
    return out


def phase_device() -> tuple[str, str]:
    global SM_CLOCK_HZ
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    print(f"clocks.max.sm: {clock}", flush=True)
    SM_CLOCK_HZ = int(clock.split()[0]) * 1e6  # "1980 MHz"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "sm_count": torch.cuda.get_device_properties(0)
          .multi_processor_count, "max_sm_clock_hz": SM_CLOCK_HZ, "torch": torch.__version__,
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
          "nvcc_seconds": kernels.build_seconds, "ptxas": _ptxas(kernels.build_log)})


def _ptxas(log: dict) -> list:
    """Registers, spills, stack frame (local memory, such as a register
    array indexed at run time) and static shared memory of every kernel,
    from nvcc's -Xptxas -v report of each source."""
    rows, cur = [], None
    for src, text in sorted(log.items()):
        for line in text.splitlines():
            if "Compiling entry function" in line:
                cur = {"source": src, "kernel": line.split("'")[1]}
                rows.append(cur)
            elif cur is not None:
                for key, pat in (("stack_frame", r"(\d+) bytes stack frame"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("registers", r"Used (\d+) registers"),
                                 ("static_smem", r"(\d+) bytes smem")):
                    m = re.search(pat, line)
                    if m:
                        cur[key] = int(m.group(1))
    return rows


def phase_kernels() -> dict:
    from mde_tpu_torch.ops import kernels as K
    from mde_tpu_torch.ops.window_attention import _window_key_validity

    g = torch.Generator().manual_seed(SEED)
    dev = "cuda"
    results = {}
    k1_cases = [
        # the flagship: 56x72 grid padded to 64x80, ragged right/bottom
        # windows; a predict batch of 2, and serving bucket 1
        ("flagship", (2, 20, 256, 32), 8, _window_key_validity(56, 72, 64, 80, 16)),
        ("bucket1", (1, 20, 256, 32), 8, _window_key_validity(56, 72, 64, 80, 16)),
        ("aligned", (1, 4, 64, 32), 4, _window_key_validity(16, 16, 16, 16, 8)),
    ]
    for label, shape, heads, mask in k1_cases:
        q, k, v = (torch.randn(shape, generator=g).to(dev) for _ in range(3))
        m = torch.from_numpy(mask).to(dev)
        got = K.window_attention(q, k, v, heads, m)
        want = K.window_attention_plain(q, k, v, heads, m)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        row = dict(max_abs_err=err)
        if label != "aligned":  # timed at the serving path's shapes
            row.update(_k1_timings(K, q, k, v, heads, m))
        emit({"phase": "kernels", "kernel": "window_attention", "case": label,
              "shape": list(shape), "heads": heads, **row})
        check(bool(torch.isfinite(got).all()), f"window_attention {label}: non-finite output")
        check(err <= TOL_KERNEL, f"window_attention {label}: max-abs {err} > {TOL_KERNEL}")
        if label == "bucket1":
            results["window_attention"]["bucket1"] = {
                key: row[key] for key in ("profiler_ms", "device_ms", "ms", "bound_ms",
                                          "bound_share")}
        results.setdefault("window_attention", row)
        results["window_attention"]["max_abs_err"] = max(err, results["window_attention"]
                                                         ["max_abs_err"])

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
    row = dict(max_abs_err=err, **_k1_timings(K, q, k, v, heads, m))
    emit({"phase": "kernels", "kernel": "window_attention_bf16", "case": "flagship_train",
          "shape": list(shape), "heads": heads, **row})
    check(bool(torch.isfinite(got).all()), "window_attention bf16: non-finite output")
    check(err <= TOL_K1_BF16, f"window_attention bf16: max-abs {err} > {TOL_K1_BF16}")
    results["window_attention_bf16"] = row
    k1 = _check_k1_backward(K, g, _window_key_validity)
    for name, err in k1.pop("forward_max_abs_err").items():
        results[name]["max_abs_err"] = max(err, results[name]["max_abs_err"])
    results.update(k1)

    results.update(_check_k2_all(K, g))

    results.update(_check_k3(K, g))
    results.update(_check_k4(K, g))
    return results


def _check_k1_backward(K, g, validity) -> dict:
    """K1's forward and backward kernels in both types at the flagship train
    shape (ragged right-edge windows whose invalid keys interleave with valid
    ones), a smaller ragged grid, an aligned one with head_dim 8, one whose
    bottom windows hold no valid key (their rows attend evenly to all keys,
    as in the plain version), one with head_dim 16 (the runtime-width
    kernels) and one of 10x10 windows (T = 100: ragged in the forward's
    chunks and slices and in the backward's chunks).

    The forward: its output against ``window_attention_plain``, finite, the
    same bits on two calls and with and without its statistics; the
    statistics against ``window_attention_plain_stats``, with the max
    exactly -FLT_MAX in a window with no valid key. The backward, fed the
    kernel forward's output and statistics, against autograd through
    ``window_attention_plain`` on the same inputs and cotangent; two calls
    and the autograd Function give the same bits. Times at the flagship
    train shape: the backward, the recompute backward it replaced (plain
    forward + autograd) and SDPA's backward with a boolean key mask; the
    forward with and without its statistics. Returns the backward rows and
    the forward's largest error by kernel row."""
    cases = (("flagship_train", (4, 20, 256, 32), 8, validity(56, 72, 64, 80, 16)),
             ("ragged", (2, 6, 256, 32), 8, validity(24, 40, 32, 48, 16)),
             ("aligned_hd8", (1, 4, 64, 32), 4, validity(16, 16, 16, 16, 8)),
             ("empty_windows", (1, 4, 64, 32), 8, validity(8, 16, 16, 16, 8)),
             ("wide_hd16", (1, 4, 64, 64), 4, validity(12, 16, 16, 16, 8)),
             ("window10", (1, 4, 100, 32), 8, validity(14, 18, 20, 20, 10)))
    out = {"forward_max_abs_err": {}}
    fwd_names = {torch.float32: ("window_attention", TOL_KERNEL),
                 torch.bfloat16: ("window_attention_bf16", TOL_K1_BF16)}
    for dtype, name, tol in ((torch.float32, "window_attention_backward", TOL_K4_GRAD),
                             (torch.bfloat16, "window_attention_backward_bf16", TOL_K4_GRAD_BF16)):
        rows = {}
        for label, shape, heads, mask in cases:
            q, k, v, cot = (torch.randn(shape, generator=g).to("cuda", dtype) for _ in range(4))
            m = torch.from_numpy(mask).cuda()
            o, stats = K._window_attention_forward(q, k, v, heads, m, True)
            o_nostats, none = K._window_attention_forward(q, k, v, heads, m, False)
            o_again, _ = K._window_attention_forward(q, k, v, heads, m, False)
            plain_out, plain_stats = K.window_attention_plain_stats(q, k, v, heads, m)
            got = K._window_attention_backward(q, k, v, heads, m, o, stats, cot)
            again = K._window_attention_backward(q, k, v, heads, m, o, stats, cot)
            plain = K.window_attention_backward_plain(q, k, v, heads, m, o, stats, cot)

            def recompute():
                with torch.enable_grad():
                    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                    return torch.autograd.grad(K.window_attention_plain(*leaves, heads, m),
                                               leaves, cot)

            want = recompute()
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            via_function = torch.autograd.grad(K.window_attention(*leaves, heads, m), leaves, cot)
            torch.cuda.synchronize()
            rel = max(_rel_l2(x.float(), y.float()) for x, y in zip(got, want))
            plain_rel = max(_rel_l2(x.float(), y.float()) for x, y in zip(plain, want))
            err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
            stats_rel = ((stats - plain_stats).abs() / plain_stats.abs()).max().item()
            same_out = none is None and torch.equal(o, o_nostats)
            fwd_name, fwd_tol = fwd_names[dtype]
            fwd_err = (o_nostats.float() - plain_out.float()).abs().max().item()
            fwd_same_bits = torch.equal(o_nostats, o_again)
            fwd_finite = bool(torch.isfinite(o_nostats).all())
            empty = ~(m > 0).any(dim=1)
            empty_m = stats[:, empty, :, :, 0]
            empty_m_exact = bool((empty_m == torch.finfo(torch.float32).min).all())
            same_bits = all(torch.equal(x, y) for x, y in zip(got, again)) and \
                all(torch.equal(x, y) for x, y in zip(got, via_function))
            # an invalid key gets dk = 0, and dv = 0 where its window has a
            # valid key (a window without one spreads p evenly, as the plain
            # version does)
            invalid = (m <= 0)[None, :, :, None].expand(shape)
            live = (m > 0).any(dim=1)[None, :, None, None].expand(shape)
            masked = (got[1][invalid], got[2][invalid & live])
            masked_max = max([x.abs().max().item() for x in masked if x.numel()] or [0.0])
            row = dict(max_abs_err=err, max_rel_l2=rel, plain_max_rel_l2=plain_rel,
                       stats_max_rel_err=stats_rel, forward_same_bits_with_stats=same_out,
                       forward_max_abs_err=fwd_err, forward_same_bits=fwd_same_bits,
                       empty_windows=int(empty.sum()), empty_m_exact=empty_m_exact,
                       same_bits=same_bits, invalid_key_grad_max=masked_max)
            if label == "flagship_train":
                b, n, t, c = shape
                hd = c // heads
                lib_leaves = [x.detach().clone().reshape(b * n, t, heads, hd).transpose(1, 2)
                              .requires_grad_() for x in (q, k, v)]
                lib_mask = (m > 0).repeat(b, 1)[:, None, None, :]
                lib_out = torch.nn.functional.scaled_dot_product_attention(
                    *lib_leaves, attn_mask=lib_mask)
                lib_cot = cot.reshape(b * n, t, heads, hd).transpose(1, 2)
                # S, dP, dV, dK and dQ: 10 head_dim FLOP a (query, key, head);
                # q/k/v/dO/out read, dq/dk/dv written, the mask and the row
                # statistics read. The kernel computes in float32 on the CUDA
                # cores in both types.
                flop = 10 * hd * b * n * heads * t * t
                work = {**bound(flop, 8 * q.numel() * q.element_size() + 4 * m.numel()
                                + 4 * stats.numel(),
                                "bf16" if dtype == torch.bfloat16 else "f32"),
                        "bound_f32_cuda_cores_ms": bound(flop, 0, "f32")["bound_ms"]}
                row.update(timings(
                    lambda: K._window_attention_backward(q, k, v, heads, m, o, stats, cot),
                    recompute,
                    lambda: torch.autograd.grad(lib_out, lib_leaves, lib_cot, retain_graph=True),
                    work, KERNEL_NAMES["window_attention_backward"]))
                for key, need in (("forward_profiler_ms", False),
                                  ("forward_with_stats_profiler_ms", True)):
                    row[key] = profiler_ms(
                        lambda: K._window_attention_forward(q, k, v, heads, m, need),
                        KERNEL_NAMES["window_attention"])
            rows[label] = row
            emit({"phase": "kernels", "kernel": name, "case": label, "shape": list(shape),
                  "heads": heads, **row})
            check(o_nostats.dtype == dtype and fwd_finite,
                  f"{fwd_name} {label}: {o_nostats.dtype} output, or non-finite")
            check(fwd_err <= fwd_tol, f"{fwd_name} {label}: max-abs {fwd_err} > {fwd_tol}")
            check(fwd_same_bits, f"{fwd_name} {label}: two calls gave other bits")
            check(empty_m_exact, f"{fwd_name} {label}: a window with no valid key has max "
                                 f"{empty_m.unique().tolist()}, not -FLT_MAX")
            out["forward_max_abs_err"][fwd_name] = max(
                fwd_err, out["forward_max_abs_err"].get(fwd_name, 0.0))
            check(all(x.dtype == dtype and x.shape == shape and bool(torch.isfinite(x).all())
                      for x in got), f"{name} {label}: gradients of the wrong dtype or shape")
            check(rel <= tol, f"{name} {label}: rel-L2 {rel} > {tol} against autograd")
            check(plain_rel <= tol, f"{name} {label}: plain version rel-L2 {plain_rel} > {tol}")
            check(stats_rel <= TOL_K1_STATS,
                  f"{name} {label}: forward statistics {stats_rel} > {TOL_K1_STATS} from plain")
            check(same_out, f"{name} {label}: the forward's output changed with its statistics")
            check(same_bits, f"{name} {label}: two runs, or the autograd Function, gave other bits")
            check(masked_max == 0.0, f"{name} {label}: an invalid key got dk/dv {masked_max}")
        out[name] = dict(rows["flagship_train"],
                         max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                         max_rel_l2=max(r["max_rel_l2"] for r in rows.values()))
    return out


def _check_k3(K, g) -> dict:
    """K3's eval form at ``_k3_cases`` against its plain version, then its
    train form (``_check_k3_train``): the rows of both."""
    results = {}
    # K3 to the flagship's and to DA-V2's input size, at serving bucket 1,
    # and at shapes that take its other paths; times at the flagship's (the
    # row) and at bucket 1.
    rgb = torch.randint(0, 256, (4, 426, 560, 3), dtype=torch.uint8, generator=g).cuda()
    for label, x, size in _k3_cases(g, rgb):
        got = K.preprocess_u8(x, size)
        again = K.preprocess_u8(x, size)
        want = K.preprocess_u8_plain(x, size)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same_bits = torch.equal(got, again)
        row = dict(max_abs_err=err, same_bits=same_bits)
        if label in ("flagship", "bucket1"):
            # u8 NHWC read once, float32 NCHW written once; ~12 FLOP an
            # output value (two bilinear blends and the normalise); no one
            # PyTorch call resizes and normalises.
            work = bound(12 * got.numel(), x.numel() + 4 * got.numel(), "f32")
            row.update(timings(lambda: K.preprocess_u8(x, size),
                               lambda: K.preprocess_u8_plain(x, size), None,
                               work, KERNEL_NAMES["preprocess_u8"]))
        emit({"phase": "kernels", "kernel": "preprocess_u8", "case": label,
              "shape": list(x.shape), "out": list(got.shape), **row})
        check(tuple(got.shape) == (x.shape[0], 3, *size) and bool(torch.isfinite(got).all()),
              f"preprocess_u8 {label}: shape {tuple(got.shape)}, or non-finite")
        check(err <= TOL_KERNEL, f"preprocess_u8 {label}: max-abs {err} > {TOL_KERNEL}")
        check(same_bits, f"preprocess_u8 {label}: two calls gave other bits")
        if label == "flagship":
            results["preprocess_u8"] = row
        elif label == "bucket1":
            results["preprocess_u8"]["bucket1"] = {
                key: row[key] for key in ("profiler_ms", "device_ms", "ms", "bound_ms",
                                          "bound_share")}
        results["preprocess_u8"]["max_abs_err"] = max(err, results["preprocess_u8"]["max_abs_err"])
    results["preprocess_u8_train"] = _check_k3_train(K, g, rgb)
    return results


def _k3_cases(g, rgb):
    """(label, u8 batch, output size) of K3's checks in both forms: the
    flagship's and DA-V2's train batches, serving bucket 1, and shapes that
    take the kernels' other paths: 159-byte source rows (staged byte by
    byte), an output width that is not a multiple of 4 (stored value by
    value), 24,000-byte source rows (too wide to stage: the taps come from
    device memory; the train form's two-launch design) and a 2048x2048
    output (more than one cooperative grid holds: the train form's
    two-launch design on staged rows)."""
    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g).cuda()

    return (("flagship", rgb, (448, 576)), ("da2", rgb, (448, 588)),
            ("bucket1", rgb[:1], (448, 576)), ("odd", u8(3, 37, 53, 3), (64, 96)),
            ("ragged", u8(3, 37, 53, 3), (61, 93)), ("wide", u8(1, 6, 8000, 3), (5, 7001)),
            ("large", u8(1, 1024, 1024, 3), (2048, 2048)))


# The train form's design at each case, as its plan must choose it from the
# shape: (cooperative, staged rows).
K3_TRAIN_DESIGN = {"wide": (0, False), "large": (0, True)}


# Float operations a pixel of K3's train form, by adjustment (brightness,
# contrast and saturation: a blend of 4 and a clamp of 2 a channel,
# saturation's grey 5 more; hue's round trip 43), of the resize (3 channels x
# (four u8 scalings, two row blends and one column blend of 3)) and of the
# normalisation: the function's work, K3 train's bound.
JITTER_FLOP = (18, 18, 23, 43)
RESIZE_FLOP, NORMALIZE_FLOP = 3 * (4 + 3 * 3), 3 * 2


def _k3_train_flop(draws: torch.Tensor, pixels: int) -> int:
    """Operations of the function for these draws, each done once: the
    resize, the four adjustments, the grey before contrast (5 FLOP) and the
    normalisation, for every pixel of every sample."""
    return draws.shape[0] * pixels * (RESIZE_FLOP + sum(JITTER_FLOP) + 5 + NORMALIZE_FLOP)


def _check_k3_train(K, g, rgb) -> dict:
    """K3's train form against its plain version on the same draws, at
    ``_k3_cases`` (bucket 1 aside) and on a batch of 24 that takes every
    order of the four adjustments (in groups of samples where one
    cooperative grid does not hold them); two calls give the same bits. Draws
    go in as the train step makes them, on the CPU; the wrapper refuses draws
    on the card and an order that is not a permutation. Each case emits the
    plan the shape chose, and ``K3_TRAIN_DESIGN`` holds it to its design (one
    cooperative launch where not listed). Times at the flagship's size,
    batch 4."""
    import itertools

    from mde_tpu_torch.ops.image import color_jitter_draws

    def draws_for(b, perms=None):
        fb, fc, fs, fh, pr = color_jitter_draws(b, 0.2, 0.2, 0.2, 0.1, generator=g)
        return K.pack_jitter_draws(fb, fc, fs, fh, pr if perms is None else torch.tensor(perms))

    orders = list(itertools.permutations(range(4)))
    rgb24 = torch.randint(0, 256, (24, *rgb.shape[1:]), dtype=torch.uint8, generator=g).cuda()
    cases = [(label, x, size, draws_for(x.shape[0])) for label, x, size in _k3_cases(g, rgb)
             if label != "bucket1"]
    cases.append(("all_orders", rgb24, (448, 576), draws_for(24, orders)))
    row = {}
    for label, x, size, draws in cases:
        got = K.preprocess_u8_train(x, draws, size)
        again = K.preprocess_u8_train(x, draws, size)
        on_card = draws.cuda()
        want = K.preprocess_u8_train_plain(x, on_card, size)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        same_bits = torch.equal(got, again)
        chosen = K.train_plan(x.shape[0], *x.shape[1:3], *size)
        plan = {key: getattr(chosen, key) for key, _ in chosen._fields_}
        case = dict(max_abs_err=err, same_bits=same_bits, plan=plan)
        coop, staged = K3_TRAIN_DESIGN.get(label, (1, True))
        check(plan["cooperative"] == coop and (plan["stage_bytes"] > 0) == staged,
              f"preprocess_u8_train {label}: plan {plan}, expected cooperative={coop}, "
              f"staged={staged}")
        if label == "flagship":
            work = bound(_k3_train_flop(draws, size[0] * size[1]),
                         x.numel() + 4 * got.numel() + 4 * draws.numel(), "f32")
            case.update(timings(lambda: K.preprocess_u8_train(x, draws, size),
                                lambda: K.preprocess_u8_train_plain(x, on_card, size), None,
                                work, KERNEL_NAMES["preprocess_u8_train"]))
            row = case
        emit({"phase": "kernels", "kernel": "preprocess_u8_train", "case": label,
              "shape": list(x.shape), "out": list(got.shape), **case})
        check(tuple(got.shape) == (x.shape[0], 3, *size) and bool(torch.isfinite(got).all()),
              f"preprocess_u8_train {label}: shape {tuple(got.shape)}, or non-finite")
        check(err <= TOL_KERNEL, f"preprocess_u8_train {label}: max-abs {err} > {TOL_KERNEL}")
        check(same_bits, f"preprocess_u8_train {label}: two calls gave other bits")
        row["max_abs_err"] = max(err, row.get("max_abs_err", 0.0))
    # the wrapper's checks of the draws, before any launch
    x, draws = rgb, draws_for(4)
    bad = draws.clone()
    bad[1, 4:] = torch.tensor([0.0, 1.0, 1.0, 3.0])
    for what, d, match in (("draws on the card", draws.cuda(), "on the CPU"),
                           ("an order that is not a permutation", bad, "permutation")):
        launches = K.preprocess_u8_train.launches
        try:
            K.preprocess_u8_train(x, d, (448, 576))
            raised = ""
        except ValueError as e:
            raised = str(e)
        check(match in raised and K.preprocess_u8_train.launches == launches,
              f"preprocess_u8_train took {what} (raised {raised!r})")
    return row


def _k4_flop(b: int, n: int, h: int, d: int) -> int:
    """The forward's two products, 4 B H N^2 D; the backward does 2.5x that."""
    return 4 * b * h * n * n * d


def _k4_bound(flop: float, nbytes: float, dtype) -> dict:
    """bf16 on the tensor cores; float32 as the kernel runs it, 3xTF32 (three
    TF32 products a product, the least time for float32 accuracy), with the
    float32 CUDA-core bound beside it."""
    if dtype == torch.bfloat16:
        return bound(flop, nbytes, "bf16")
    return {**bound(3 * flop, nbytes, "tf32"), "bound_rate": "3xTF32",
            "bound_f32_cuda_cores_ms": bound(flop, nbytes, "f32")["bound_ms"]}


def _check_k4(K, g) -> dict:
    """K4 at every case in both element types, on the (B, N, 3, H, D) views of
    a fused qkv tensor as the ViT hands them over, against its plain version
    fed the same inputs; then its backward kernel. The kernel rows carry the
    largest error over the cases and the times at DA-V2-S's training shape."""
    out = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype, name, tol in ((torch.float32, "flash_attention", TOL_KERNEL),
                             (torch.bfloat16, "flash_attention_bf16", TOL_K1_BF16)):
        cases = {}
        for label, (b, n, h, d) in K4_CASES:
            q, k, v = torch.randn((b, n, 3, h, d), generator=g).to("cuda", dtype).unbind(2)
            got = K.flash_attention(q, k, v)
            want = K.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                  f"{name} {label}: {got.dtype} output, or non-finite")
            err = (got.float() - want.float()).abs().max().item()
            tq, tk, tv = (x.transpose(1, 2) for x in (q, k, v))
            work = _k4_bound(_k4_flop(b, n, h, d), 4 * q.numel() * q.element_size(), dtype)
            cases[label] = dict(max_abs_err=err, **timings(
                lambda: K.flash_attention(q, k, v), lambda: K.flash_attention_plain(q, k, v),
                lambda: sdpa(tq, tk, tv), work,
                KERNEL_NAMES["flash_attention"] if label in K4_PROFILED else None))
            emit({"phase": "kernels", "kernel": name, "case": label, "shape": [b, n, h, d],
                  **cases[label]})
            check(err <= tol, f"{name} {label}: max-abs {err} > {tol}")
        out[name] = dict(cases["da2s_train"],
                         max_abs_err=max(c["max_abs_err"] for c in cases.values()),
                         dpt=_dpt_cases(cases))
    out.update(_check_k4_backward_all(K, g))
    return out


def _check_k4_backward_all(K, g) -> dict:
    """K4's backward kernel in both types at every case of ``K4_BWD_CASES``;
    each row carries the largest errors over the cases and the times at
    DA-V2-S's training shape."""
    out = {}
    for dtype, name, tol in ((torch.float32, "flash_attention_backward", TOL_K4_GRAD),
                             (torch.bfloat16, "flash_attention_backward_bf16", TOL_K4_GRAD_BF16)):
        cases = {label: _check_k4_backward(K, g, label, shape, dtype, name, tol)
                 for label, shape in K4_BWD_CASES}
        out[name] = dict(cases["da2s_train"],
                         max_abs_err=max(c["max_abs_err"] for c in cases.values()),
                         max_rel_l2=max(c["max_rel_l2"] for c in cases.values()),
                         dpt=_dpt_cases(cases))
    return out


def _dpt_cases(cases: dict) -> dict:
    """The DPT shapes' numbers of a K4 row (its main numbers are DA-V2-S's)."""
    keys = ("max_abs_err", "max_rel_l2", "ms", "device_ms", "profiler_ms", "plain_device_ms",
            "bound_ms", "bound_by", "bound_share", "library_ms")
    return {label: {k: cases[label][k] for k in keys if k in cases[label]}
            for label in ("dptl_train", "dpth_train")}


def _check_k4_backward(K, g, label: str, shape, dtype, name: str, tol: float) -> dict:
    """The backward kernel (fed the kernel forward's output and lse) and its
    plain version against autograd through ``flash_attention_plain`` on the
    same inputs and cotangent; the kernel twice, for the same bits. Times: the
    kernel alone, the recompute backward it replaced (plain forward + autograd),
    and SDPA's backward through autograd on a retained graph."""
    b, n, h, d = shape
    q, k, v = torch.randn((b, n, 3, h, d), generator=g).to("cuda", dtype).unbind(2)
    cot = torch.randn(shape, generator=g).to("cuda", dtype)
    o, lse = K._flash_attention_forward(q, k, v, True)
    got = K._flash_attention_backward(q, k, v, o, lse, cot)
    again = K._flash_attention_backward(q, k, v, o, lse, cot)
    plain = K.flash_attention_backward_plain(q, k, v, o, lse, cot)

    def recompute():
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            return torch.autograd.grad(K.flash_attention_plain(*leaves), leaves, cot)

    want = recompute()
    torch.cuda.synchronize()
    rel = max(_rel_l2(x.float(), y.float()) for x, y in zip(got, want))
    plain_rel = max(_rel_l2(x.float(), y.float()) for x, y in zip(plain, want))
    err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
    same_bits = all(torch.equal(x, y) for x, y in zip(got, again))
    # The autograd Function (forward with lse, then the kernel backward) on
    # contiguous copies of the views gives the same bits.
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    via_function = torch.autograd.grad(K.flash_attention(*leaves), leaves, cot)
    same_bits = same_bits and all(torch.equal(x, y) for x, y in zip(got, via_function))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in leaves))
    lib_cot = cot.transpose(1, 2)
    # Five products (S again, dP, dV, dK, dQ); q/k/v/o/dO read, dq/dk/dv
    # written, lse read.
    work = _k4_bound(2.5 * _k4_flop(b, n, h, d), 8 * q.numel() * q.element_size() + 4 * lse.numel(),
                     dtype)
    row = dict(max_abs_err=err, max_rel_l2=rel, plain_max_rel_l2=plain_rel, same_bits=same_bits,
               **timings(lambda: K._flash_attention_backward(q, k, v, o, lse, cot), recompute,
                         lambda: torch.autograd.grad(lib_out, leaves, lib_cot, retain_graph=True),
                         work,
                         KERNEL_NAMES["flash_attention_backward"] if label in K4_PROFILED
                         else None))
    if label == "da2s_train":
        # each pass's own device time, and what ptxas and the launcher give
        # the kernels: registers, spills, static and dynamic shared memory,
        # rows a block and blocks an SM
        names = KERNEL_NAMES["flash_attention_backward"]
        row["passes_profiler_ms"] = profiler_split_ms(
            lambda: K._flash_attention_backward(q, k, v, o, lse, cot), names)
        row["ptxas"] = [r for r in _ptxas(K.build_log)
                        if any(n_ in r["kernel"] for n_ in names)]
        if hasattr(K, "flash_attention_backward_plan"):  # not in trees before the redesign
            row["plan"] = K.flash_attention_backward_plan(dtype, n)
    emit({"phase": "kernels", "kernel": name, "case": label, "shape": list(shape), **row})
    check(all(x.dtype == dtype and x.shape == shape and bool(torch.isfinite(x).all())
              for x in got), f"{name} {label}: gradients of the wrong dtype or shape, or non-finite")
    check(rel <= tol, f"{name} {label}: rel-L2 {rel} > {tol} against autograd")
    check(plain_rel <= tol, f"{name} {label}: plain version rel-L2 {plain_rel} > {tol}")
    check(same_bits, f"{name} {label}: two runs, or the autograd Function, gave other bits")
    return row


def k1_forward_bound(b: int, n: int, t: int, heads: int, hd: int, elem_bytes: int) -> dict:
    """K1's forward bound in either element type: it computes in float32 on
    the CUDA cores, so the larger of q/k/v/out and the key mask at the memory
    rate, 4 hd FLOP a (query, key, head) pair (logit and weighted sum) at
    the float32 rate, and one exponential a pair at SFU_EX2_PER_CLOCK an SM
    a clock at the card's maximum SM clock."""
    pairs = b * n * heads * t * t
    bytes_ms = (4 * b * n * t * heads * hd * elem_bytes + 4 * n * t) / HBM_BYTES_PER_S * 1e3
    flop_ms = 4 * hd * pairs / PEAK_FLOPS["f32"] * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_ms = pairs / (sms * SFU_EX2_PER_CLOCK * SM_CLOCK_HZ) * 1e3
    return {"bound_ms": max(bytes_ms, flop_ms, exp_ms),
            "bound_by": "bytes" if bytes_ms >= max(flop_ms, exp_ms) else "operations",
            "bound_bytes_ms": bytes_ms, "bound_f32_cuda_cores_ms": flop_ms,
            "bound_exp_ms": exp_ms}


def _k1_timings(K, q, k, v, heads: int, m) -> dict:
    """K1's times, its bound (``k1_forward_bound``) and its yardstick:
    scaled_dot_product_attention on the (B N, heads, T, hd) view with a
    boolean key mask from ``key_valid``."""
    b, n, t, c = q.shape
    hd = c // heads

    def split(x):
        return x.reshape(b * n, t, heads, hd).transpose(1, 2)

    mask = (m > 0).repeat(b, 1)[:, None, None, :]
    sq, sk, sv = split(q), split(k), split(v)
    work = k1_forward_bound(b, n, t, heads, hd, q.element_size())
    return timings(lambda: K.window_attention(q, k, v, heads, m),
                   lambda: K.window_attention_plain(q, k, v, heads, m),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       sq, sk, sv, attn_mask=mask), work, KERNEL_NAMES["window_attention"])


def _k2_inputs(shape, g, offset: int = 0):
    """Positive depths and a log-ratio with a non-zero mean and a spread, so
    neither sum is near zero or constant; on the card, each a contiguous view
    ``offset`` floats into its storage (1: rows off 16 bytes)."""
    target = torch.rand(shape, generator=g) * 9.9 + 0.1
    pred = target * torch.exp(0.3 + 0.5 * torch.randn(shape, generator=g))
    n = pred.numel()

    def place(x):
        flat = torch.empty(n + offset, device="cuda")
        flat[offset:] = x.reshape(-1).cuda()
        return flat[offset:].view(shape)

    return place(pred), place(target)


def _check_k2(K, label: str, shape, g, timed: bool, offset: int = 0) -> dict:
    """K2 forward and backward against the plain version; the forward also
    gives the same bits on a second call and through the autograd Function,
    with its launch plan. Returns the numbers of a timed case."""
    dev, b = "cuda", shape[0]
    pred, target = _k2_inputs(shape, g, offset)
    s1, s2 = K.si_loss_sums(pred, target)
    r1, r2 = K.si_loss_sums_plain(pred, target)
    again = K.si_loss_sums(pred, target)
    leaf = pred.clone().requires_grad_()
    graph = K.si_loss_sums(leaf, target)
    torch.cuda.synchronize()
    check(graph[0].grad_fn is not None, f"si_loss_sums {label}: no autograd graph")
    same_bits = all(torch.equal(x, y) for x, y in zip((s1, s2, s1, s2), (*again, *graph)))
    rel = max(((s1 - r1).abs() / r1.abs()).max().item(), ((s2 - r2).abs() / r2.abs()).max().item())
    err = max((s1 - r1).abs().max().item(), (s2 - r2).abs().max().item())
    fwd = dict(max_abs_err=err, max_rel_err=rel, same_bits=same_bits)
    if hasattr(K, "si_loss_sums_plan"):  # not in trees before the redesign
        aligned = pred.data_ptr() % 16 == 0 and target.data_ptr() % 16 == 0
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        fwd["plan"] = K.si_loss_sums_plan(b, pred[0].numel(), aligned, sms)._asdict()
        fwd["plan"]["threads"] = K.SI_SUM_THREADS
        names = KERNEL_NAMES["si_loss_sums"]
    else:
        names = K2_PARENT_NAMES
    n = pred.numel()
    if timed:  # pred and target read once; two logs and four FLOP an element
        # 100 calls a profiler window: at 20, one window in two read this
        # 6 us kernel up to 0.0018 ms low (PERF.md, K2 findings)
        fwd.update(timings(lambda: K.si_loss_sums(pred, target),
                           lambda: K.si_loss_sums_plain(pred, target), None,
                           bound(6 * n, 8 * n + 8 * b, "f32"), names, profiler_n=100))
        # device kernels a call, as the profiler counts them over 100 calls
        launched = sum(e.count for e in profiled(lambda: K.si_loss_sums(pred, target), 100)
                       if str(getattr(e, "device_type", "")).endswith("CUDA")
                       and any(name in e.key for name in names))
        fwd["device_kernels_a_call"] = launched / 100
    emit({"phase": "kernels", "kernel": "si_loss_sums", "case": label, "shape": list(shape),
          "storage_offset": offset, "sums": [r1.tolist(), r2.tolist()], **fwd})
    check(rel <= TOL_K2, f"si_loss_sums {label}: relative error {rel} > {TOL_K2}")
    check(same_bits, f"si_loss_sums {label}: not the same bits on a second call or through "
          "the autograd Function")

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
    if timed:  # pred and target read, dpred written; two logs and six FLOP an element
        bwd.update(timings(
            lambda: K._si_loss_sums_backward(pred, target, g1, g2, 1e-6, False),
            lambda: K.si_loss_sums_backward_plain(pred, target, g1, g2, 1e-6, False), None,
            bound(8 * n, 12 * n + 8 * b, "f32"), KERNEL_NAMES["si_loss_sums_backward"]))
    emit({"phase": "kernels", "kernel": "si_loss_sums_backward", "case": label,
          "shape": list(shape), "dtarget": need_target, **bwd})
    check(rel <= TOL_K2, f"si_loss_sums backward {label}: max-abs over max-abs {rel} > {TOL_K2}")
    return {"si_loss_sums": fwd, "si_loss_sums_backward": bwd} if timed else {}


def _sass_counts(K, marker: str) -> dict:
    """Each kernel of the built library whose name holds ``marker``: its SASS
    instructions in all and by opcode, from ``cuobjdump -sass`` (the
    toolkit's, beside nvcc)."""
    try:
        tool = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
        text = subprocess.run([tool, "-sass", str(K.library_path())],
                              capture_output=True, text=True, timeout=120).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        return {"error": repr(e)}
    counts = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        if marker not in name:
            continue
        ops = [m.group(1).split(".")[0]
               for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)]
        counts[name] = {"instructions": len(ops),
                        "opcodes": dict(sorted(collections.Counter(ops).items()))}
    return counts


def _check_k2_all(K, g) -> dict:
    """K2 at every case of ``K2_CASES``; the numbers of the timed one."""
    results = {}
    for label, shape, offset in K2_CASES:
        results.update(_check_k2(K, label, shape, g, timed=label == "flagship_train",
                                 offset=offset))
    return results


def _post(url: str, body: bytes):
    req = urllib.request.Request(url + "/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def _post_concurrently(url: str, images: np.ndarray) -> tuple[list, float]:
    """POST each image as .npy from N_CLIENTS threads started together, a
    client every N_CLIENTS-th image; the replies in order and the seconds
    taken. A client's error or a thread that did not finish fails."""
    bodies = []
    for img in images:
        buf = io.BytesIO()
        np.save(buf, img)
        bodies.append(buf.getvalue())
    replies, errors = [None] * len(bodies), []
    barrier = threading.Barrier(N_CLIENTS)

    def client(c: int):
        try:
            barrier.wait(timeout=60)
            for i in range(c, len(bodies), N_CLIENTS):
                replies[i] = _post(url, bodies[i])
        except Exception as e:  # reported below; a thread must not die silently
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    check(not errors, f"client errors: {errors}")
    check(all(not t.is_alive() for t in threads), "a client thread did not finish")
    return replies, seconds


def _counters():
    from mde_tpu_torch.ops import kernels as K

    return K.LAUNCH_COUNTERS


def reset_counts() -> None:
    from mde_tpu_torch.ops import kernels as K

    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
    K.window_attention.stats_launches = 0


def k1_stats_launches() -> int:
    """K1 forwards that also wrote the row statistics since ``reset_counts``."""
    from mde_tpu_torch.ops import kernels as K

    return K.window_attention.stats_launches


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


# The kernels each path must launch; it may launch no other (the flagship's
# DINOv2 is frozen and runs under no_grad, so no K4 backward).
PATH_KERNELS = {
    "flagship_serve": ("window_attention", "preprocess_u8", "flash_attention"),
    "flagship_train": ("window_attention", "window_attention_bf16", "window_attention_backward",
                       "window_attention_backward_bf16", "preprocess_u8", "preprocess_u8_train",
                       "si_loss_sums", "si_loss_sums_backward", "flash_attention",
                       "flash_attention_bf16"),
    "da2_serve": ("preprocess_u8", "flash_attention"),
    "da2_train": ("preprocess_u8", "preprocess_u8_train", "si_loss_sums", "si_loss_sums_backward",
                  "flash_attention", "flash_attention_bf16", "flash_attention_backward",
                  "flash_attention_backward_bf16"),
    # the evaluation, prediction and visualisation tools: forwards only
    "flagship_tools": ("window_attention", "preprocess_u8", "si_loss_sums", "flash_attention"),
    "da2_tools": ("preprocess_u8", "si_loss_sums", "flash_attention"),
    # PairAug normalises after its warp: neither form of K3 runs
    "flagship_augment": ("window_attention_bf16", "window_attention_backward_bf16",
                         "si_loss_sums", "si_loss_sums_backward", "flash_attention_bf16"),
    # the exported predictor and the server over it: the serving path's kernels
    "flagship_export": ("window_attention", "preprocess_u8", "flash_attention"),
    "da2_export": ("preprocess_u8", "flash_attention"),
    # data parallel: the flagship's float32 and bf16 train steps and
    # DA-V2-S's bf16 ones on every rank
    "parallel": ("window_attention", "window_attention_bf16", "window_attention_backward",
                 "window_attention_backward_bf16", "preprocess_u8_train",
                 "si_loss_sums", "si_loss_sums_backward", "flash_attention",
                 "flash_attention_bf16", "flash_attention_backward_bf16"),
}


def check_path_launches(path: str, launches: dict, what: str, skip=()) -> None:
    """Every kernel of the path launched (but those in ``skip``), and no other."""
    for kernel, count in launches.items():
        if kernel not in PATH_KERNELS[path]:
            check(count == 0, f"{kernel} was launched {count} times {what}, off its path")
        elif kernel not in skip:
            check(count > 0, f"{kernel} was not launched {what}")


def model_cfg(name: str, *sets: str):
    """The config a user gets from the CLI with the model's ``--set``s."""
    from mde_tpu_torch.tools.common import parse_config

    extra = DA2_SETS if name == "da2" else ()
    cfg, _ = parse_config("chip_smoke", argv=[a for x in extra + sets for a in ("--set", x)])
    return cfg


def final_depth_conv(model):
    """The conv that makes each model's depth channel: DA-V2's release tail,
    the flagship's depth head, U-Net's ``final``, else the MiDaS and DPT
    heads' ``scratch.output_conv[4]``."""
    from mde_tpu_torch.models.depth_anything import DepthAnythingV2
    from mde_tpu_torch.models.midas_semantics import MidasNetSemantics
    from mde_tpu_torch.models.simple_unet import SimpleUNet

    if isinstance(model, DepthAnythingV2):
        return model.depth_head.scratch.output_conv2[2]
    if isinstance(model, MidasNetSemantics):
        return model.depth_head[1]
    if isinstance(model, SimpleUNet):
        return model.final
    return model.scratch.output_conv[4]


def make_model(name: str, cfg, bias: float):
    """The model from SEED on the CPU, with every LayerScale gamma in [0.2, 0.8]
    and the final depth conv's bias raised by ``bias`` (a random depth tail
    sits at its ReLU: most of the map would compare 0 to 0)."""
    from mde_tpu_torch.models.factory import build_model
    from mde_tpu_torch.nn.vit import LayerScale

    g = torch.Generator().manual_seed(SEED)
    model = build_model(cfg.model, "cpu", g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.gamma.copy_(torch.rand(m.gamma.shape, generator=g) * 0.6 + 0.2)
        final_depth_conv(model).bias.add_(bias)
    return model


def _host_ms(step, batch: np.ndarray, reps: int = 5) -> float:
    """Median host time of copy in, step, copy out (the serving path's work)."""
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        step(torch.from_numpy(batch).cuda()).cpu()
        times.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(times)


def phase_serve(name: str) -> dict:
    from http.server import ThreadingHTTPServer

    from mde_tpu_torch.tools.common import bootstrap_model
    from mde_tpu_torch.tools.serve import build_service, make_handler
    from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
    from mde_tpu_torch.train.trainer import make_predict_step

    path = f"{name}_serve"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg = model_cfg(name, f"paths.results_dir={tmp}")
        ckpt = checkpoint_path(tmp, cfg.experiment.model_name)
        save_checkpoint(ckpt, make_model(name, cfg, bias=0.5 if name == "da2" else 0.0))

        # torch's defaults; the server must run float32 with TF32 off
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        service = build_service(cfg, "cuda", max_batch=8, window_ms=5.0, warmup=True)
        start_s = time.perf_counter() - t0
        tf32 = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        check(not any(tf32.values()), f"the server left TF32 on: {tf32}")
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
        server_thread = threading.Thread(target=server.serve_forever, daemon=True)
        server_thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            rng = np.random.default_rng(SEED)
            h, w = service.native
            images = rng.integers(0, 256, (N_CLIENTS * N_PER_CLIENT, h, w, 3), dtype=np.uint8)
            reset_counts()
            replies, serve_s = _post_concurrently(url, images)
            launches = read_counts()
            stats_writes = k1_stats_launches()
            check(stats_writes == 0, f"{path} wrote K1 statistics {stats_writes} times")

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
            check_path_launches(path, launches, f"while {path} served")

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
            del cpu_model

            bucket_ms = {str(b): _host_ms(service._step, np.zeros((b, h, w, 3), np.uint8))
                         for b in service.batcher.buckets}
            # The predict step at buckets 1 and 8 on device-resident frames:
            # CUDA-event time and the profiler's split of its device time.
            predict_profile = {}
            for b in (1, 8):
                x = torch.from_numpy(images[:b]).cuda()
                step_ms = cuda_ms(lambda: service._step(x), reps=8, warmup=2)
                predict_profile[str(b)] = {
                    "step_ms": step_ms, "profile": _profile_step(lambda: service._step(x), step_ms)}
            # Kernels against plain versions at buckets 1 and 8, in turns
            # plain, kernels, kernels, plain.
            ab = {}
            for b in (1, 8):
                batch = images[:b]
                steps = {"plain": plain_step, "kernels": service._step}
                ab[str(b)] = {k: [] for k in steps}
                for k in ("plain", "kernels", "kernels", "plain"):
                    ab[str(b)][k].append(_host_ms(steps[k], batch))
            out = {"phase": "serve", "model": name, "requests": len(replies),
                   "clients": N_CLIENTS, "start_s": start_s, "serve_s": serve_s, **tf32,
                   "k1_stats_writes": stats_writes,
                   "batch_sizes": batch_sizes, "stats": dict(service.batcher.stats),
                   "launches": launches, "served_vs_plain_max_abs": served_err,
                   "served_vs_cpu_max_abs": cpu_err, "depth_mean": float(np.mean(depths)),
                   "depth_spread": spread, "predict_ms_by_bucket": bucket_ms,
                   "predict_ms_kernels_vs_plain": ab, "predict_profile": predict_profile}
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
    events = profiled(step)
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in events
            if e.device_time_total > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    if not rows:
        return {"device_ms": "not measured"}
    device_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    ours = {o: [0.0, 0] for names in KERNEL_NAMES.values() for o in names}
    for name, ms, n in rows:
        for o, acc in ours.items():
            if o in name:
                acc[0] += ms
                acc[1] += n
    # A softmax backward comes only from a recompute backward through a plain
    # attention (K1's in the flagship; none on DA-V2's path).
    softmax_bwd = [[name[:90], ms, n] for name, ms, n in rows
                   if "softmax" in name.lower() and "backward" in name.lower()]
    # K1's plain recompute backward is the only autograd through an amax in
    # the port (window_attention_plain); its node shows on the host side.
    plain_k1 = [[e.key[:90], e.count] for e in events if "AmaxBackward" in e.key]
    copies = [[name, n] for name, _, n in rows if name.startswith("Memcpy")]
    return {"device_ms": device_ms, "busy_share_of_step": device_ms / step_ms,
            "launches": sum(r[2] for r in rows),
            "kernel_launches": sum(n for name, _, n in rows if not name.startswith("Mem")),
            "pageable_h2d": sum(n for name, n in copies if "HtoD" in name and "Pageable" in name),
            "pinned_h2d": sum(n for name, n in copies if "HtoD" in name and "Pinned" in name),
            "copies": copies, "plain_k1_backward": plain_k1,
            "our_kernels": ours, "softmax_backward": softmax_bwd,
            "our_kernels_share": sum(ms for ms, _ in ours.values()) / device_ms,
            "top": [[name[:90], ms, n] for name, ms, n in rows[:12]]}


def phase_train(name: str) -> dict:
    from mde_tpu_torch.data import synthetic
    from mde_tpu_torch.data.transforms import preprocess_train
    from mde_tpu_torch.tools import main as train_cli
    from mde_tpu_torch.tools.common import bootstrap_model, live_missing_keys
    from mde_tpu_torch.train.checkpoint import checkpoint_path, load_training_checkpoint
    from mde_tpu_torch.train.checkpoint import TRAINING_KEYS
    from mde_tpu_torch.models.midas_semantics import CrossAttention
    from mde_tpu_torch.nn.vit import Attention
    from mde_tpu_torch.train.trainer import (forward_backward, make_optimizer, make_train_step,
                                             step_generator)

    path = f"{name}_train"
    cfg = model_cfg(name)  # bf16 compute, the default
    cfg32 = model_cfg(name, "framework.compute_dtype=float32")
    input_size = tuple(int(s_) for s_ in cfg.framework.input_size)
    # Start the depth head comfortably positive, as tests/test_train_parity.py
    # does: at random init most pre-ReLU depths sit at the ReLU cliff, where
    # the loss gradient is ~1/(pred + 1e-6) and the comparison says nothing.
    model = make_model(name, cfg, bias=0.5 if name == "da2" else 2.0).cuda()
    init_state = copy.deepcopy(model.state_dict())
    rng = np.random.default_rng(SEED)
    samples = [synthetic.make_sample(rng, *TRAIN_SHAPE[1:]) for _ in range(TRAIN_SHAPE[0])]
    rgb_u8 = torch.from_numpy(np.stack([s_[0] for s_ in samples])).cuda()
    depth_raw = torch.from_numpy(np.stack([s_[1] for s_ in samples])).cuda()
    out = {"phase": "train", "model": name, "batch": TRAIN_SHAPE[0],
           "input_size": list(input_size)}
    # K4's backward runs once per attention block a step on DA-V2's trunk
    # (the flagship's DINOv2 is frozen and launches none), K1's once per
    # cross-attention on the flagship, K3's train form once a step on both.
    n_attn = sum(isinstance(m, Attention) for m in model.modules()) if name == "da2" else 0
    n_cross = sum(isinstance(m, CrossAttention) for m in model.modules())

    def check_step_launches(launches: dict, steps: int, what: str) -> None:
        bf16 = what != "a"
        want = {"preprocess_u8_train": steps}
        for kernel, per_step in (("flash_attention_backward", n_attn),
                                 ("window_attention_backward", n_cross)):
            want[kernel] = 0 if bf16 else per_step * steps
            want[kernel + "_bf16"] = per_step * steps if bf16 else 0
        got = {k: launches[k] for k in want}
        check(got == want, f"{path} ({what}): launches {got}, want {want}")
        # K1's forward writes its statistics once for each backward to come
        stats_writes = k1_stats_launches()
        check(stats_writes == n_cross * steps,
              f"{path} ({what}): K1 statistics written {stats_writes} times, want "
              f"{n_cross * steps}")

    # (a) the train preprocessing, kernel vs plain on the same draws; then one
    # float32 step, kernels vs plain, each on its own preprocessed inputs
    reset_counts()
    rgb, depth = preprocess_train(rgb_u8, depth_raw, input_size,
                                  generator=step_generator(SEED, 0, 0))
    rgb_p, depth_p = preprocess_train(rgb_u8, depth_raw, input_size,
                                      generator=step_generator(SEED, 0, 0), plain=True)
    pre_err = (rgb - rgb_p).abs().max().item()
    check(pre_err <= TOL_KERNEL and torch.equal(depth, depth_p),
          f"preprocess_train kernel vs plain: max-abs {pre_err} > {TOL_KERNEL}, or depth differs")
    model_plain = copy.deepcopy(model)
    loss_k, _ = forward_backward(model, cfg32, rgb, depth)
    launches_a = read_counts()
    loss_p, _ = forward_backward(model_plain, cfg32, rgb_p, depth_p, plain=True)
    check(read_counts() == launches_a, "the plain path launched a kernel")
    loss_k, loss_p = loss_k.item(), loss_p.item()
    gaps = _grad_gaps(model, model_plain)
    out["a_fp32_kernels_vs_plain"] = {"preprocess_max_abs": pre_err,
                                      "loss_kernels": loss_k, "loss_plain": loss_p,
                                      "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                                      "grad_rel_l2": gaps, "launches": launches_a}
    emit({"phase": "train", "model": name, "check": "a", **out["a_fp32_kernels_vs_plain"]})
    check(all(np.isfinite([loss_k, loss_p])), f"non-finite loss {loss_k}, {loss_p}")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS * abs(loss_p),
          f"train loss kernels {loss_k} vs plain {loss_p}")
    check(gaps["global"] < TOL_GRAD_GLOBAL, f"global gradient rel-L2 {gaps['global']}")
    bad = {k: v for k, v in gaps.items() if k != "global" and v >= TOL_GRAD_SUBTREE}
    check(not bad, f"subtree gradient rel-L2 above {TOL_GRAD_SUBTREE}: {bad}")
    want_a = [k for k in PATH_KERNELS[path] if not k.endswith("_bf16") and k != "preprocess_u8"]
    check(all(launches_a[k] > 0 for k in want_a), f"a kernel was not launched: {launches_a}")
    check_step_launches(launches_a, 1, "a")
    si_bwd_per_step = launches_a["si_loss_sums_backward"]
    make_optimizer(model, cfg32).step()
    del model_plain

    # (b) two bf16 autocast steps from the same weights
    model.load_state_dict(init_state)
    reset_counts()
    step16 = make_train_step(model, cfg, make_optimizer(model, cfg))
    losses16 = [step16(rgb_u8, depth_raw, step_generator(SEED, 0, i))["loss"].item()
                for i in range(2)]
    launches_b = read_counts()
    out["b_bf16"] = {"losses": losses16, "fp32_step0_loss": loss_k,
                     "step0_rel": abs(losses16[0] - loss_k) / abs(loss_k),
                     "launches": launches_b}
    emit({"phase": "train", "model": name, "check": "b", **out["b_bf16"]})
    check(all(np.isfinite(losses16)), f"non-finite bf16 losses {losses16}")
    for k in PATH_KERNELS[path]:
        if k.endswith("_bf16"):
            check(launches_b[k] > 0, f"{k} was not launched by the bf16 steps")
    check_step_launches(launches_b, 2, "b")
    check(abs(losses16[0] - loss_k) <= TOL_BF16_LOSS * abs(loss_k),
          f"bf16 step-0 loss {losses16[0]} vs float32 {loss_k}")

    # (d) the train step through the kernels and through the plain versions
    # (plain=True), each dtype in turn: peak memory (one optimizer, two
    # steps), CUDA-event times in turns plain, kernels, kernels, plain, and
    # one profiled step each.
    timing = {}
    modes = ("kernels", "plain")
    gen = step_generator(SEED, 1, 0)
    for dt, c in (("fp32", cfg32), ("bf16", cfg)):
        timing[dt] = {}
        for mode in modes:
            model.load_state_dict(init_state)
            step = make_train_step(model, c, make_optimizer(model, c), plain=mode == "plain")
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                step(rgb_u8, depth_raw, gen)
            torch.cuda.synchronize()
            timing[dt][mode] = {"peak_mib": torch.cuda.max_memory_allocated() / 2**20}
            del step
        steps = {mode: make_train_step(model, c, make_optimizer(model, c), plain=mode == "plain")
                 for mode in modes}
        turns = {mode: [] for mode in modes}
        for mode in ("plain", "kernels", "kernels", "plain"):
            turns[mode].append(cuda_ms(lambda: steps[mode](rgb_u8, depth_raw, gen), reps=6,
                                       warmup=2))
        for mode, step in steps.items():
            ms = statistics.median(turns[mode])
            timing[dt][mode].update(step_ms=ms, step_ms_turns=turns[mode], profile=_profile_step(
                lambda: step(rgb_u8, depth_raw, gen), ms))
        del steps, step
    out["d_timing"] = timing

    def by_mode(key):
        return {dt: {mode: (v[key] if key in v else v["profile"].get(key)) for mode, v in t.items()}
                for dt, t in timing.items()}

    emit({"phase": "train", "model": name, "check": "d", "train_step_ms": by_mode("step_ms"),
          "peak_mib": by_mode("peak_mib"), "busy_share": by_mode("busy_share_of_step"),
          "kernel_launches": by_mode("kernel_launches"), "pageable_h2d": by_mode("pageable_h2d"),
          "pinned_h2d": by_mode("pinned_h2d"),
          "profile": timing})
    # The backward kernels left no attention recompute behind: no softmax
    # backward (K4, DA-V2) and no autograd through K1's plain version; the
    # plain path shows each, so the profile would see one.
    recompute = "plain_k1_backward" if name == "flagship" else "softmax_backward"
    for dt, t in timing.items():
        for key in ("softmax_backward", "plain_k1_backward"):
            check(t["kernels"]["profile"].get(key, []) == [],
                  f"{name} {dt} train step ran {key}: {t['kernels']['profile'].get(key)}")
        check(bool(t["plain"]["profile"].get(recompute)),
              f"{name} {dt} plain train step: the profile saw no {recompute}")
        # K3's train form takes its draws by value: no pinned copy a step
        pinned = t["kernels"]["profile"].get("pinned_h2d", 0)
        check(pinned == 0, f"{name} {dt} train step made {pinned} pinned host-to-card copies")
        # K2's forward is one kernel a step (a window may lose a record)
        k2 = t["kernels"]["profile"].get("our_kernels", {}).get("si_sums_kernel", [0.0, 0])[1]
        check(k2 <= 1, f"{name} {dt} train step launched K2's forward kernel {k2} times")
    del model, step16

    # (c) the training CLI, end to end, on generated data
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data = os.path.join(tmp, "data")
        synthetic.generate(data, n_train=16, n_test=4, size=TRAIN_SHAPE[1:], seed=SEED)
        results, preds = os.path.join(tmp, "results"), os.path.join(tmp, "predictions")
        # one process whatever the number of cards: the parallel phase
        # drives W > 1
        base_sets = ("training.n_epoch=2", "framework.mesh.data=1", f"paths.results_dir={results}",
                     f"paths.predictions_dir={preds}", "experiment.wandb_disable=true")
        sets = (DA2_SETS if name == "da2" else ()) + base_sets
        argv = ["--device", "cuda", "--data-dir", data] + [a for x in sets for a in ("--set", x)]
        reset_counts()
        t0 = time.perf_counter()
        history = train_cli.main(argv)
        cli_s = time.perf_counter() - t0
        launches = read_counts()
        ckpt = checkpoint_path(results, cfg.experiment.model_name)
        check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
        payload = load_training_checkpoint(ckpt)
        check(set(TRAINING_KEYS) <= set(payload), f"checkpoint keys {sorted(payload)}")
        reloaded, report = bootstrap_model(model_cfg(name), "cuda", checkpoint=ckpt)
        missing = live_missing_keys(reloaded, report)
        check(not report["shape_mismatch"] and not missing,
              f"checkpoint reload: {report['shape_mismatch'][:5]} {missing[:5]}")
        del reloaded
        files = sorted(os.listdir(preds))
        arrays = [np.load(os.path.join(preds, f)) for f in files]
        out["c_cli"] = {"seconds": cli_s, "history": history, "launches": launches,
                        "predictions": len(files), "checkpoint_epoch": payload["epoch"]}
        emit({"phase": "train", "model": name, "check": "c", **out["c_cli"]})
        check(len(history["train_loss"]) == 2, f"epochs run: {history}")
        check(all(np.isfinite(history["train_loss"] + history["val_loss"])),
              f"non-finite losses {history}")
        check(len(arrays) == 4 and all(a.shape == (426, 560) and np.isfinite(a).all()
                                       for a in arrays),
              f"predictions {[(f, a.shape) for f, a in zip(files, arrays)]}")
        # The CLI trains in bf16: K1's and K4's float32 backwards run in (a) only.
        check_path_launches(path, launches, f"during {path}'s CLI",
                            skip=("flash_attention_backward", "window_attention_backward"))
        check(launches["si_loss_sums_backward"] % si_bwd_per_step == 0,
              f"K2 backward launches {launches['si_loss_sums_backward']} are not whole steps")
        check_step_launches(launches, launches["si_loss_sums_backward"] // si_bwd_per_step, "c")
        tools = phase_tools(name, tmp, base_sets + (f"paths.data_dir={data}",),
                            dict(zip(files, arrays)))
        export = phase_export(name, tmp, sets, ckpt)
    # The path's launches: (a), (b) and (c), each counted from zero.
    total = {k: launches_a[k] + launches_b[k] + launches[k] for k in launches}
    check_path_launches(path, total, f"during {path}")
    return {path: total, f"{name}_tools": tools, f"{name}_export": export}


def _trainable_count(model) -> int:
    """Trainable values as the JAX tool counts them: ``requires_grad``, outside
    the frozen top-level ``dinov2``, and not one of the model's dead keys
    (the reference grammar's modules the forward never reads)."""
    return sum(p.numel() for n, p in model.named_parameters()
               if p.requires_grad and n.split(".", 1)[0] != "dinov2"
               and not n.startswith(model.DEAD_KEY_PREFIXES))


def phase_tools(name: str, tmp: str, sets: tuple, c_predictions: dict) -> dict:
    """The evaluation, prediction and visualisation tools as a user runs them
    after training: from train (c)'s directory (the working directory is
    changed there and back), on the checkpoint (c) wrote, with (c)'s
    ``--set``s. Their launches are the path's; the checks against
    ``evaluate()`` and against (c)'s predictions come after the counts are
    read. The tools turn cuDNN's deterministic algorithms on, so the
    comparison with ``evaluate()`` runs under the same setting; the phases
    after this one get cuDNN's setting back as they found it.
    """
    saved = torch.backends.cudnn.deterministic
    try:
        return _run_tools(name, tmp, sets, c_predictions)
    finally:
        torch.backends.cudnn.deterministic = saved


def _run_tools(name: str, tmp: str, sets: tuple, c_predictions: dict) -> dict:
    import base64
    import contextlib
    import csv
    import importlib.util
    import zlib

    from mde_tpu_torch.data.dataset import DepthDataset
    from mde_tpu_torch.data.loader import HostLoader
    from mde_tpu_torch.tools import evaluation, generate_predictions, visualize
    from mde_tpu_torch.tools.common import bootstrap_model, resolve_paths
    from mde_tpu_torch.train.checkpoint import checkpoint_path
    from mde_tpu_torch.train.trainer import evaluate, trainable_parameters

    path = f"{name}_tools"
    tool_preds = os.path.join(tmp, "predictions_tool")
    viz_dir = os.path.join(tmp, "visualization")
    argv = ["--device", "cuda"] + [a for x in (DA2_SETS if name == "da2" else ()) + sets
                                   + (f"paths.predictions_dir={tool_preds}",)
                                   for a in ("--set", x)]
    has_matplotlib = importlib.util.find_spec("matplotlib") is not None
    cfg = model_cfg(name, *sets)
    seconds = {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            metrics = evaluation.main(argv)
        seconds["evaluation"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        written = generate_predictions.main(argv)
        seconds["generate_predictions"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if has_matplotlib:
            drawn = visualize.main(argv + ["--n-samples", "2", "--output-dir", viz_dir])
            maps = None
        else:
            # the tool's arrays without its figures: the one declared exception
            print("visualize: the PNGs were not written because matplotlib is absent; "
                  "its arrays were computed for two samples", flush=True)
            model, _ = bootstrap_model(cfg, "cuda", checkpoint=checkpoint_path(
                cfg.paths.results_dir, cfg.experiment.model_name))
            paths = resolve_paths(cfg)
            loader = HostLoader(DepthDataset(paths["train_dir"], paths["train_list"]),
                                indices=range(2), batch_size=1, num_workers=2, device="cuda")
            maps = [visualize.sample_maps(model, cfg, b["rgb"], b["depth"]) for b in loader]
            drawn = len(maps)
            del model
        seconds["visualize"] = time.perf_counter() - t0
        launches = read_counts()
        csv_path = os.path.join(tmp, "predictions.csv")
        with open(csv_path, newline="") as f:
            rows = list(csv.reader(f))
    finally:
        os.chdir(cwd)
    out = {"phase": "tools", "model": name, "seconds": seconds, "launches": launches,
           "matplotlib": has_matplotlib}
    print(printed.getvalue(), end="", flush=True)
    check_path_launches(path, launches, f"while {path} ran")

    # evaluation: finite metrics equal to evaluate() on the reloaded model,
    # and the JAX tool's trainable count
    lines = dict(line.rsplit(": ", 1) for line in printed.getvalue().splitlines()
                 if ": " in line)
    count = int(lines["Number of trainable parameters in the model"])
    model, _ = bootstrap_model(cfg, "cuda", checkpoint=checkpoint_path(
        cfg.paths.results_dir, cfg.experiment.model_name))
    paths = resolve_paths(cfg)
    loader = HostLoader(DepthDataset(paths["train_dir"], paths["train_list"]),
                        batch_size=int(cfg.training.batch_size), shuffle=False,
                        num_workers=int(cfg.framework.num_workers), device="cuda")
    want = evaluate(model, cfg, loader, n_samples=int(cfg.framework.eval_n_samples))
    base = float(cfg.framework.eval_base_thres)
    keys = {"si_rmse": "Average Scale-Invariant Loss", "abs_rel": "Average Absolute Relative Error",
            **{f"delta_{j}": f"Average Delta {base**j} Threshold"
               for j in range(1, int(cfg.framework.eval_n_delta) + 1)}}
    got = {k: float(lines[label]) for k, label in keys.items()}
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in keys}
    out["evaluation"] = {"printed": got, "evaluate": want, "rel": rel, "trainable": count,
                         "trainable_parameters": sum(p.numel() for p in trainable_parameters(model)),
                         "trainable_live": _trainable_count(model)}
    check(all(np.isfinite(v) for v in got.values()), f"evaluation tool printed {got}")
    check(got == {k: metrics[k] for k in keys}, "the evaluation tool printed other numbers "
          "than it returned")
    check(max(rel.values()) <= TOL_TOOL_METRICS,
          f"evaluation tool vs evaluate(): rel {rel} > {TOL_TOOL_METRICS}")
    check(count == _trainable_count(model),
          f"evaluation tool counted {count} trainable values, want {_trainable_count(model)}")
    del model

    # prediction: (c)'s files and values, and the CSV's rows decode to them
    files = sorted(os.listdir(tool_preds))
    arrays = {f: np.load(os.path.join(tool_preds, f)) for f in files}
    check(written == 4 and files == sorted(c_predictions),
          f"prediction tool wrote {written}: {files}, want {sorted(c_predictions)}")
    check(all(a.shape == TRAIN_SHAPE[1:] and a.dtype == np.float32 and np.isfinite(a).all()
              for a in arrays.values()), f"predictions {[(f, a.shape) for f, a in arrays.items()]}")
    pred_err = max(float(np.abs(arrays[f] - c_predictions[f]).max()) for f in files)
    check(pred_err <= TOL_TOOL_PRED,
          f"prediction tool vs train (c)'s predictions: max-abs {pred_err} > {TOL_TOOL_PRED}")
    check(rows[0] == ["id", "Depths"] and len(rows) == 5, f"predictions.csv rows {len(rows)}")
    for (file_id, blob), f in zip(rows[1:], files):
        text = zlib.decompress(base64.b64decode(blob)).decode("utf-8")
        check(file_id == os.path.splitext(f)[0]
              and text == ",".join(f"{x:.2f}" for x in np.round(arrays[f].flatten(), 2)),
              f"predictions.csv row {file_id} does not decode to {f}")
    out["generate_predictions"] = {"files": files, "max_abs_vs_c": pred_err,
                                   "csv_rows": len(rows) - 1}

    # visualisation: six PNGs with the reference's names, or the arrays
    model_name = cfg.experiment.model_name
    if has_matplotlib:
        figures = sorted(os.listdir(os.path.join(viz_dir, "figures")))
        want_figs = sorted(f"{i:06d}_{suffix}.png" for i in range(2) for suffix in
                           ("gtd", f"{model_name}_pred", f"{model_name}_lmap"))
        check(drawn == 2 and figures == want_figs, f"visualize wrote {figures}")
        out["visualize"] = {"figures": figures}
    else:
        input_size = tuple(int(s_) for s_ in cfg.framework.input_size)
        check(drawn == 2 and all(m.shape == input_size and np.isfinite(m).all()
                                 for arrs in maps for m in arrs), "visualize's arrays")
        out["visualize"] = {"figures": "not written: matplotlib is absent", "arrays": drawn}
    emit(out)
    return launches


def phase_augment() -> dict:
    """The flagship's PairAug path (``augmentation: True``) at batch 4:
    (a) ``pairaug_apply`` on the card against the CPU with the same draws and
    noise, with the step's gates and with every stage on; (b) the pipeline's
    CUDA-event time, launches and copies; (c) three bf16 train steps, the
    path's launches; (d) the augmented step against the default one, timed
    in turns with ``StepTimer``, peak memory from ``device_memory_stats``
    and each step's pageable host-to-card copies from the profiler."""
    from mde_tpu_torch.data import synthetic
    from mde_tpu_torch.data.transforms import pairaug_apply, pairaug_draws, preprocess_pairaug
    from mde_tpu_torch.models.midas_semantics import CrossAttention
    from mde_tpu_torch.ops.image import standard_normal
    from mde_tpu_torch.train.profiling import StepTimer, device_memory_stats
    from mde_tpu_torch.train.trainer import make_optimizer, make_train_step, step_generator

    path = "flagship_augment"
    cfg = model_cfg("flagship", "augmentation=true")  # bf16 compute, the default
    cfg_default = model_cfg("flagship")
    size = tuple(int(s_) for s_ in cfg.framework.input_size)
    b = TRAIN_SHAPE[0]
    rng = np.random.default_rng(SEED)
    samples = [synthetic.make_sample(rng, *TRAIN_SHAPE[1:]) for _ in range(b)]
    rgb_u8 = torch.from_numpy(np.stack([s_[0] for s_ in samples])).cuda()
    depth_raw = torch.from_numpy(np.stack([s_[1] for s_ in samples])).cuda()
    out = {"phase": "augment", "model": "flagship", "batch": b, "input_size": list(size)}

    # (a) the card against the CPU on the same draws and noise
    draws = pairaug_draws(b, step_generator(SEED, 0, 0))
    on = torch.ones(b)
    cases = {"step_draws": draws,
             "every_stage": draws._replace(jitter_gate=on, noise_gate=on, blur_gate=on)}
    out["a_card_vs_cpu"] = {}
    for label, d in cases.items():
        noise = standard_normal((b, 3, *size), d.noise_seed, "cpu")
        rgb_c, depth_c = pairaug_apply(rgb_u8.cpu(), depth_raw.cpu(), d, size, noise=noise)
        rgb_g, depth_g = pairaug_apply(rgb_u8, depth_raw, d, size, noise=noise.cuda())
        err = (rgb_g.cpu() - rgb_c).abs().max().item()
        derr = ((depth_g.cpu() - depth_c).abs().max() / depth_c.abs().max()).item()
        gates = {k: getattr(d, k).tolist() for k in ("flip", "rot_gate", "jitter_gate",
                                                     "noise_gate", "blur_gate")}
        out["a_card_vs_cpu"][label] = {"rgb_max_abs": err, "depth_rel": derr, "gates": gates}
        check(torch.isfinite(rgb_g).all().item() and torch.isfinite(depth_g).all().item(),
              f"pairaug ({label}) on the card is not finite")
        check(err <= TOL_PAIRAUG and derr <= TOL_PAIRAUG_DEPTH,
              f"pairaug ({label}) card vs CPU: rgb max-abs {err} > {TOL_PAIRAUG} or depth "
              f"rel {derr} > {TOL_PAIRAUG_DEPTH}")
    card_noise = standard_normal((b, 3, *size), draws.noise_seed, "cuda")
    out["a_card_noise"] = {"mean": card_noise.mean().item(), "std": card_noise.std().item()}
    check(abs(out["a_card_noise"]["mean"]) < 0.01 and abs(out["a_card_noise"]["std"] - 1) < 0.01,
          f"the card's noise is not N(0, 1): {out['a_card_noise']}")
    emit({**out, "check": "a"})

    # (b) the pipeline alone: the step's draws (as a step runs it) and every stage on
    out["b_pipeline"] = {}
    for label, fn in (
            ("step_draws", lambda: preprocess_pairaug(rgb_u8, depth_raw, size,
                                                      generator=step_generator(SEED, 0, 0))),
            ("every_stage", lambda: pairaug_apply(rgb_u8, depth_raw, cases["every_stage"],
                                                  size))):
        ms = cuda_ms(fn, reps=20, warmup=3)
        prof = _profile_step(fn, ms)
        out["b_pipeline"][label] = {"ms": ms, "device_ms": prof.get("device_ms"),
                                    "kernel_launches": prof.get("kernel_launches"),
                                    "pageable_h2d": prof.get("pageable_h2d"),
                                    "top": prof.get("top", [])[:6]}
        check(prof.get("pageable_h2d", 0) <= 1,
              f"pairaug ({label}) made {prof.get('pageable_h2d')} pageable copies, want 1")
    emit({"phase": "augment", "check": "b", **out["b_pipeline"]})

    # (c) three bf16 steps with augmentation: True, counted from zero
    model = make_model("flagship", cfg, bias=2.0).cuda()
    n_cross = sum(isinstance(m, CrossAttention) for m in model.modules())
    optimizer = make_optimizer(model, cfg)
    step = make_train_step(model, cfg, optimizer)
    reset_counts()
    timer = StepTimer(warmup=0)
    losses = []
    for i in range(3):
        timer.start()
        metrics = step(rgb_u8, depth_raw, step_generator(SEED, 0, i))
        timer.stop(metrics)
        losses.append(metrics["loss"].item())
    launches = read_counts()
    out["c_steps"] = {"losses": losses, "step_s": timer.times, "launches": launches}
    emit({"phase": "augment", "check": "c", **out["c_steps"]})
    check(all(np.isfinite(losses)), f"non-finite augmented losses {losses}")
    want = {"si_loss_sums": 3, "si_loss_sums_backward": 3, "preprocess_u8_train": 0,
            "window_attention_backward_bf16": 3 * n_cross}
    got = {k: launches[k] for k in want}
    check(got == want, f"{path}: launches {got}, want {want}")
    check(k1_stats_launches() == 3 * n_cross,
          f"{path}: K1 statistics written {k1_stats_launches()} times, want {3 * n_cross}")
    check_path_launches(path, launches, f"during {path}")

    # (d) augmented and default steps in turns on one optimizer: StepTimer
    # (two warm-up steps each), peak memory, the profiler's copies a step
    steps = {"augment": step, "default": make_train_step(model, cfg_default, optimizer)}
    timers = {mode: StepTimer(warmup=2) for mode in steps}
    gen = step_generator(SEED, 1, 0)
    peaks = {}
    for mode, fn in steps.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            fn(rgb_u8, depth_raw, gen)
        peaks[mode] = device_memory_stats()[0]["peak_bytes_in_use"] / 2**20
    for mode in ("default", "augment", "augment", "default"):
        for _ in range(4):
            timers[mode].start()
            timers[mode].stop(steps[mode](rgb_u8, depth_raw, gen))
    summary = {mode: t.summary() for mode, t in timers.items()}
    profiles = {mode: _profile_step(lambda fn=fn: fn(rgb_u8, depth_raw, gen),
                                    summary[mode]["p50_s"] * 1e3) for mode, fn in steps.items()}
    out["d_turns"] = {
        "step_ms_p50": {m: s_["p50_s"] * 1e3 for m, s_ in summary.items()},
        "augment_over_default": summary["augment"]["p50_s"] / summary["default"]["p50_s"],
        "timer": summary, "peak_mib": peaks,
        "pageable_h2d": {m: p.get("pageable_h2d") for m, p in profiles.items()},
        "kernel_launches": {m: p.get("kernel_launches") for m, p in profiles.items()},
        "device_ms": {m: p.get("device_ms") for m, p in profiles.items()},
        "busy_share": {m: p.get("busy_share_of_step") for m, p in profiles.items()}}
    emit({"phase": "augment", "check": "d", **out["d_turns"]})
    pageable = profiles["augment"].get("pageable_h2d")
    print(f"augment: {pageable} pageable host-to-card copies a step", flush=True)
    check(pageable is not None and pageable <= MAX_PAGEABLE_AUGMENT,
          f"the augmented step made {pageable} pageable copies, more than {MAX_PAGEABLE_AUGMENT}")
    k2 = profiles["augment"].get("our_kernels", {}).get("si_sums_kernel", [0.0, 0])[1]
    check(k2 <= 1, f"the augmented step launched K2's forward kernel {k2} times")
    return launches


def export_inputs(batch: int, native) -> np.ndarray:
    """The export phase's uint8 batch of ``batch`` frames, from SEED."""
    return np.random.default_rng(SEED + batch).integers(0, 256, (batch, *native, 3),
                                                        dtype=np.uint8)


# Run in a fresh interpreter: load the archive on the card with no model code,
# predict once a bucket on ``export_inputs``, count each bucket's launches.
EXPORT_CHILD = """
import json, sys, time
import numpy as np, torch
import chip_smoke as S
from mde_tpu_torch.train.export import load_exported
# float32 with TF32 off, as the server over an archive sets it
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
p = load_exported(sys.argv[1], "cuda")
load_s = time.perf_counter() - t0
outs, counts, first_s = {}, {}, {}
for b in p.batch_sizes:
    x = S.export_inputs(b, p.meta["native_size"])
    S.reset_counts()
    t1 = time.perf_counter()
    outs[str(b)] = p.predict(x)
    first_s[str(b)] = time.perf_counter() - t1
    counts[str(b)] = S.read_counts()
np.savez(sys.argv[2], **outs)
print(json.dumps({"load_s": load_s, "first_predict_s": first_s, "counts": counts,
                  "models_imported": sorted(m for m in sys.modules
                                            if m.startswith("mde_tpu_torch.models")),
                  "jax_imported": sorted(m for m in sys.modules
                                         if m.split(".")[0] in ("jax", "mde_tpu"))}))
"""


def _compare(got: np.ndarray, want: np.ndarray) -> dict:
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return {"max_abs": err, "rel_l2": rel}


def phase_export(name: str, tmp: str, sets: tuple, ckpt: str) -> dict:
    """The ahead-of-time path on train (c)'s checkpoint (DA-V2-S: the serve
    phase's weights, EXPORT_SERVE_WEIGHTS): the export CLI writes the
    archive (buckets up to EXPORT_MAX_BATCH); a fresh interpreter
    loads it with no model code and predicts once a bucket; each bucket's
    output and launches are held against the live predict step's on the same
    checkpoint; the exported predictor and the live step are timed in turns
    and profiled at bucket 1 (no plain version's operation may run); then
    ``build_service_from_exported`` serves it over HTTP to concurrent clients,
    its replies held against the live step. Returns the launches of one
    exported call a bucket (the path's row in the kernels line)."""
    import zipfile
    from http.server import ThreadingHTTPServer

    from mde_tpu_torch.tools import export_model
    from mde_tpu_torch.tools.common import bootstrap_model
    from mde_tpu_torch.tools.serve import build_service_from_exported, make_handler
    from mde_tpu_torch.train.export import WEIGHTS_NAME, load_exported
    from mde_tpu_torch.train.trainer import make_predict_step

    path = f"{name}_export"
    phase_t0 = time.perf_counter()
    if name in EXPORT_SERVE_WEIGHTS:
        from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint

        results = os.path.join(tmp, "export_results")
        sets = sets + (f"paths.results_dir={results}",)
        cfg = model_cfg(name, *sets)
        ckpt = checkpoint_path(results, cfg.experiment.model_name)
        save_checkpoint(ckpt, make_model(name, cfg, bias=0.5))
    archive = os.path.join(tmp, f"{name}.mdex")
    argv = ["--device", "cuda", "--out", archive, "--max-batch", str(EXPORT_MAX_BATCH[name])]
    argv += [a for x in sets for a in ("--set", x)]
    reset_counts()
    t0 = time.perf_counter()
    meta = export_model.main(argv)
    export_s = time.perf_counter() - t0
    traced = read_counts()
    check(not any(traced.values()), f"exporting launched kernels: {traced}")
    with zipfile.ZipFile(archive) as zf:
        sizes = {i.filename: i.file_size for i in zf.infolist()}
    out = {"phase": "export", "model": name, "buckets": meta["batch_sizes"],
           "cli_s": export_s, "export_s_by_bucket": meta["export_seconds"]["cuda"],
           "archive_mb": os.path.getsize(archive) / 1e6,
           "state_dict_mb": sizes[WEIGHTS_NAME] / 1e6,
           "program_mb": {k: v / 1e6 for k, v in sizes.items() if k.endswith(".pt2")}}

    # the live predict step on the same checkpoint
    cfg = model_cfg(name, *sets)
    live_model, report = bootstrap_model(cfg, "cuda", checkpoint=ckpt)
    check(report is not None and not report["shape_mismatch"], "checkpoint reload failed")
    live = make_predict_step(live_model, cfg)
    native = tuple(int(s_) for s_ in cfg.framework.native_size)
    buckets = list(meta["batch_sizes"])
    want, live_counts = {}, {}
    for b in buckets:
        x = torch.from_numpy(export_inputs(b, native)).cuda()
        reset_counts()
        want[str(b)] = live(x).cpu().numpy()
        live_counts[str(b)] = read_counts()
        check((want[str(b)] > 0).mean() > 0.5 and float(want[str(b)].std()) > 0,
              f"bucket {b}: the live depth map is clipped at the ReLU; nothing to compare")

    # a fresh interpreter loads the archive and predicts
    npz = os.path.join(tmp, f"{name}_exported.npz")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, archive, npz],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the loading process failed:\n{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    check(child["models_imported"] == [] and child["jax_imported"] == [],
          f"the loader imported {child['models_imported'] + child['jax_imported']}")
    got = np.load(npz)
    per_bucket = {}
    for b in buckets:
        key = str(b)
        cmp = _compare(got[key], want[key])
        check(got[key].shape == (b, *native) and np.isfinite(got[key]).all(),
              f"bucket {b}: exported output {got[key].shape}")
        check(cmp["max_abs"] <= TOL_EXPORT and cmp["rel_l2"] <= TOL_EXPORT_REL_L2,
              f"bucket {b}: exported vs live predict step {cmp}")
        expected = {k: EXPORT_BUCKET_LAUNCHES[name].get(k, 0) for k in child["counts"][key]}
        check(child["counts"][key] == expected == live_counts[key],
              f"bucket {b}: exported launches {child['counts'][key]}, live "
              f"{live_counts[key]}, want {expected}")
        per_bucket[key] = {**cmp, "launches": {k: v for k, v in expected.items() if v}}
    out.update(child_s=child_s, child_load_s=child["load_s"],
               child_first_predict_s=child["first_predict_s"], by_bucket=per_bucket)

    # in this process: one call a bucket (the path's launches), then timing
    predictor = load_exported(archive, "cuda")
    reset_counts()
    here = {str(b): predictor.predict(export_inputs(b, native)) for b in buckets}
    launches = read_counts()
    check_path_launches(path, launches, "while the exported predictor ran its buckets")
    for key, depth in here.items():
        cmp = _compare(depth, want[key])
        check(cmp["max_abs"] <= TOL_EXPORT and cmp["rel_l2"] <= TOL_EXPORT_REL_L2,
              f"bucket {key}: exported vs live predict step in this process {cmp}")
        per_bucket[key]["in_process"] = cmp
    host_ms = {}
    for b in buckets:
        batch = export_inputs(b, native)
        steps = {"live": live, "exported": predictor.predict_tensor}
        host_ms[str(b)] = {k: [] for k in steps}
        for k in ("live", "exported", "exported", "live"):
            host_ms[str(b)][k].append(_host_ms(steps[k], batch))
    x1 = torch.from_numpy(export_inputs(1, native)).cuda()
    step_ms = cuda_ms(lambda: predictor.predict_tensor(x1), reps=8, warmup=2)
    profile = _profile_step(lambda: predictor.predict_tensor(x1), step_ms)
    plain_ops = sorted({e.key for e in profiled(lambda: predictor.predict_tensor(x1))
                        if e.key in PLAIN_OPS})
    check(not plain_ops, f"the exported program ran plain versions' operations: {plain_ops}")
    live_ms = cuda_ms(lambda: live(x1), reps=8, warmup=2)
    out.update(host_ms_by_bucket=host_ms, bucket1_step_ms=step_ms, bucket1_profile=profile,
               live_bucket1_step_ms=live_ms,
               live_bucket1_profile=_profile_step(lambda: live(x1), live_ms))
    del predictor

    # served over HTTP; TF32 at torch's defaults first: the server turns it off
    torch.backends.cudnn.allow_tf32 = True
    service = build_service_from_exported(cfg, archive, "cuda", window_ms=5.0)
    tf32 = torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32
    check(not tf32, "serving the archive left TF32 on")
    check(tuple(service.batcher.buckets) == tuple(buckets), f"buckets {service.batcher.buckets}")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        images = export_inputs(N_CLIENTS * N_PER_CLIENT, native)
        reset_counts()
        replies, serve_s = _post_concurrently(url, images)
        served = read_counts()
        check_path_launches(path, served, "while the archive was served")
        worst, sizes_seen = 0.0, []
        for img, (status, body, headers) in zip(images, replies):
            check(status == 200, f"HTTP {status}: {body[:200]!r}")
            depth = np.load(io.BytesIO(body))
            ref = live(torch.from_numpy(img[None]).cuda()).cpu().numpy()[0]
            err = float(np.abs(depth - ref).max())
            check(depth.shape == native and err <= TOL_SERVED
                  and err <= TOL_SERVED_SPREAD * float(ref.max() - ref.min()),
                  f"served reply vs live predict step: max-abs {err}")
            worst = max(worst, err)
            sizes_seen.append(int(headers["X-Batch-Size"]))
        check(max(sizes_seen) > 1, f"no request was coalesced: {sizes_seen}")
        out.update(serve_s=serve_s, served_requests=len(replies), served_batch_sizes=sizes_seen,
                   served_vs_live_max_abs=worst, served_launches=served,
                   seconds=time.perf_counter() - phase_t0)
        emit(out)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        service.close()


# The zoo phase: the rest of the factory's models, each selected by its
# ``--set``s alone, at full width and the default 448x576 input.
ZOO = (
    ("midas_small", ("model.dinov2_type=null",)),
    ("midas_small_lb_dgr", ("model.dinov2_type=null", "model.network.use_lb=true",
                            "model.network.use_dgr=true")),
    ("flagship_lb", ("model.network.use_lb=true",)),
    ("unet", ("model.model_type=U_Net",)),
    ("midas", ("model.model_type=MiDaS",)),
    ("dpt_large", ("model.model_type=DPT_Large",)),
    ("dpt_hybrid", ("model.model_type=DPT_Hybrid",)),
)
ZOO_CLI = "midas_small_lb_dgr"  # the one model the training CLI and evaluation tool run
# Kernel predict step against the plain-version one, float32 on the same
# weights and frames: max-abs over the plain map's largest value. The
# flagship's and DA-V2-S's served maps sat 2e-7 of it from plain on an H100.
TOL_ZOO_PREDICT = 1e-5
ZOO_CONV = ("preprocess_u8", "preprocess_u8_train", "si_loss_sums", "si_loss_sums_backward")
PATH_KERNELS.update({
    "zoo_midas_small": ZOO_CONV, "zoo_midas_small_lb_dgr": ZOO_CONV, "zoo_unet": ZOO_CONV,
    "zoo_midas": ZOO_CONV, "zoo_flagship_lb": PATH_KERNELS["flagship_train"],
    "zoo_dpt_large": PATH_KERNELS["da2_train"], "zoo_dpt_hybrid": PATH_KERNELS["da2_train"],
})


def _zoo_serve(name: str, sets: tuple) -> dict:
    """build_service from the model's ``--set``s behind the HTTP server:
    two concurrent frames, the replies against the kernels' predict step on
    the same frames, that step against ``plain=True``, host ms by bucket."""
    from http.server import ThreadingHTTPServer

    from mde_tpu_torch.tools.serve import build_service, make_handler
    from mde_tpu_torch.train.checkpoint import checkpoint_path, save_checkpoint
    from mde_tpu_torch.train.trainer import make_predict_step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        cfg = model_cfg(name, *sets, f"paths.results_dir={tmp}")
        save_checkpoint(checkpoint_path(tmp, cfg.experiment.model_name),
                        make_model(name, cfg, bias=0.5))
        t0 = time.perf_counter()
        service = build_service(cfg, "cuda", max_batch=2, window_ms=20.0, warmup=True)
        start_s = time.perf_counter() - t0
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            h, w = service.native
            images = np.random.default_rng(SEED).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
            reset_counts()
            replies, serve_s = _post_concurrently(f"http://127.0.0.1:{server.server_address[1]}",
                                                  images)
            launches = read_counts()
            check(all(st == 200 for st, _, _ in replies), f"zoo {name}: HTTP {replies[0][:2]}")
            served = np.stack([np.load(io.BytesIO(body)) for _, body, _ in replies])
            check(served.shape == (2, 426, 560) and bool(np.isfinite(served).all()),
                  f"zoo {name}: replies {served.shape}, or non-finite")
            x = torch.from_numpy(images).cuda()
            kernels = service._step(x).cpu().numpy()
            plain = make_predict_step(service.model, cfg, plain=True)(x).cpu().numpy()
            scale = float(np.abs(plain).max())
            out = {"start_s": start_s, "serve_s": serve_s, "launches": launches,
                   "batch_sizes": [int(hd["X-Batch-Size"]) for _, _, hd in replies],
                   "served_vs_predict_max_abs": float(np.abs(served - kernels).max()),
                   "predict_vs_plain_max_abs": float(np.abs(kernels - plain).max()),
                   "depth_max": scale, "depth_spread": float(plain.max() - plain.min()),
                   "predict_ms_by_bucket": {
                       str(b): _host_ms(service._step, np.zeros((b, h, w, 3), np.uint8))
                       for b in service.batcher.buckets}}
        finally:
            server.shutdown()
            server.server_close()
            service.close()
    emit({"phase": "zoo", "model": name, "part": "serve", **out})
    check(out["served_vs_predict_max_abs"] <= TOL_ZOO_PREDICT * scale,
          f"zoo {name}: served vs predict step {out['served_vs_predict_max_abs']} (map max {scale})")
    check(out["predict_vs_plain_max_abs"] <= TOL_ZOO_PREDICT * scale,
          f"zoo {name}: kernels vs plain predict {out['predict_vs_plain_max_abs']} "
          f"(map max {scale})")
    check(out["depth_spread"] > 0, f"zoo {name}: a constant map")
    return launches


def _zoo_train(name: str, sets: tuple) -> dict:
    """Two train steps in float32 and two in bf16 at batch 4 through the
    kernels, each beside the same step through the plain versions on the same
    weights and draws: losses, the gradient's rel-L2 against the plain step,
    CUDA-event ms, peak MiB and the kernels' launches."""
    from mde_tpu_torch.data import synthetic
    from mde_tpu_torch.models.midas_semantics import CrossAttention
    from mde_tpu_torch.nn.vit import Attention
    from mde_tpu_torch.train.trainer import make_optimizer, make_train_step, step_generator

    cfg16 = model_cfg(name, *sets)  # bf16 compute, the default
    cfg32 = model_cfg(name, *sets, "framework.compute_dtype=float32")
    # the depth head comfortably positive, as phase_train's flagship: at the
    # ReLU cliff the loss gradient is ~1/(pred + 1e-6), and with a bias of
    # 0.5 K3's rounding moved MidasNet's float32 gradient 0.36 rel-L2 from
    # the plain step's on an H100
    model = make_model(name, cfg16, bias=2.0).cuda()
    init = copy.deepcopy(model.state_dict())
    rng = np.random.default_rng(SEED)
    samples = [synthetic.make_sample(rng, *TRAIN_SHAPE[1:]) for _ in range(TRAIN_SHAPE[0])]
    rgb_u8 = torch.from_numpy(np.stack([s_[0] for s_ in samples])).cuda()
    depth_raw = torch.from_numpy(np.stack([s_[1] for s_ in samples])).cuda()
    # K4's backward once per trainable attention block a step (the flagship's
    # DINOv2 is frozen), K1's once per cross-attention, K3's train form once
    n_attn = 0 if name == "flagship_lb" else sum(isinstance(m, Attention) for m in model.modules())
    n_cross = sum(isinstance(m, CrossAttention) for m in model.modules())
    out, total = {}, collections.Counter()
    for dt, cfg in (("fp32", cfg32), ("bf16", cfg16)):
        model.load_state_dict(init)
        plain = copy.deepcopy(model)
        steps = {"kernels": make_train_step(model, cfg, make_optimizer(model, cfg)),
                 "plain": make_train_step(plain, cfg, make_optimizer(plain, cfg), plain=True)}
        rows = []
        for i in range(2):
            row = {}
            for mode, step in steps.items():
                reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                loss = step(rgb_u8, depth_raw, step_generator(SEED, 0, i))["loss"]
                t1.record()
                torch.cuda.synchronize()
                launches = read_counts()
                row[mode] = {"loss": loss.item(), "ms": t0.elapsed_time(t1),
                             "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
                if mode == "kernels":
                    row["launches"] = {k: v for k, v in launches.items() if v}
                    total.update(launches)
                else:
                    check(not any(launches.values()), f"zoo {name}: the plain step launched "
                          f"{launches}")
            row["loss_rel"] = abs(row["kernels"]["loss"] - row["plain"]["loss"]) / abs(
                row["plain"]["loss"])
            row["grad_rel_l2"] = _grad_gaps(model, plain)
            rows.append(row)
            bf16 = dt == "bf16"
            want = {"preprocess_u8_train": 1,
                    "flash_attention_backward" + ("_bf16" if bf16 else ""): n_attn,
                    "window_attention_backward" + ("_bf16" if bf16 else ""): n_cross}
            got = {k: row["launches"].get(k, 0) for k in want}
            check(got == want, f"zoo {name} {dt} step {i}: launches {got}, want {want}")
        out[dt] = rows
        del plain, steps
    emit({"phase": "zoo", "model": name, "part": "train", **out})
    for i, row in enumerate(out["fp32"]):
        check(all(np.isfinite([row[m]["loss"] for m in ("kernels", "plain")])),
              f"zoo {name}: non-finite fp32 loss at step {i}")
    first = out["fp32"][0]
    check(first["loss_rel"] <= TOL_TRAIN_LOSS, f"zoo {name}: fp32 loss kernels vs plain "
          f"{first['loss_rel']}")
    gaps = first["grad_rel_l2"]
    check(gaps["global"] < TOL_GRAD_GLOBAL, f"zoo {name}: global gradient rel-L2 {gaps['global']}")
    bad = {k: v for k, v in gaps.items() if k != "global" and v >= TOL_GRAD_SUBTREE}
    check(not bad, f"zoo {name}: subtree gradient rel-L2 above {TOL_GRAD_SUBTREE}: {bad}")
    # bf16: the step-0 loss against float32's; its gradient is reported, not
    # bounded (the flagship's bf16 gradient is 0.74 rel-L2 from its float32
    # one by rounding alone on an H100, the parallel phase's
    # grad_rel_l2_vs_float32)
    loss32 = first["kernels"]["loss"]
    for mode in ("kernels", "plain"):
        loss16 = out["bf16"][0][mode]["loss"]
        check(np.isfinite(loss16) and abs(loss16 - loss32) <= TOL_BF16_LOSS * abs(loss32),
              f"zoo {name}: bf16 {mode} step-0 loss {loss16} vs float32 {loss32}")
    check(all(np.isfinite(r[m]["loss"]) for r in out["bf16"] for m in ("kernels", "plain")),
          f"zoo {name}: non-finite bf16 loss")
    del model
    return dict(total)


def _zoo_cli(name: str, sets: tuple) -> dict:
    """The training CLI for one epoch on generated data, then the evaluation
    tool on the checkpoint it wrote (the reference grammar's ``.pth``)."""
    import contextlib

    from mde_tpu_torch.data import synthetic
    from mde_tpu_torch.tools import evaluation
    from mde_tpu_torch.tools import main as train_cli
    from mde_tpu_torch.tools.common import bootstrap_model, live_missing_keys
    from mde_tpu_torch.train.checkpoint import (TRAINING_KEYS, checkpoint_path,
                                                load_training_checkpoint)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_train_") as tmp:
        data = os.path.join(tmp, "data")
        synthetic.generate(data, n_train=16, n_test=4, size=TRAIN_SHAPE[1:], seed=SEED)
        results = os.path.join(tmp, "results")
        run_sets = sets + ("training.n_epoch=1", "framework.mesh.data=1",
                           f"paths.results_dir={results}", f"paths.data_dir={data}",
                           f"paths.predictions_dir={os.path.join(tmp, 'predictions')}",
                           "experiment.wandb_disable=true")
        argv = ["--device", "cuda"] + [a for x in run_sets for a in ("--set", x)]
        reset_counts()
        t0 = time.perf_counter()
        history = train_cli.main(argv)
        cli_s = time.perf_counter() - t0
        cfg = model_cfg(name, *run_sets)
        ckpt = checkpoint_path(results, cfg.experiment.model_name)
        payload = load_training_checkpoint(ckpt)
        check(set(TRAINING_KEYS) <= set(payload), f"zoo {name}: checkpoint keys {sorted(payload)}")
        model, report = bootstrap_model(cfg, "cuda", checkpoint=ckpt)
        check(set(payload["model_state_dict"]) == set(model.state_dict())
              and not report["shape_mismatch"] and not live_missing_keys(model, report),
              f"zoo {name}: the checkpoint is not the model's grammar: {report}")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            metrics = evaluation.main(argv)
        eval_s = time.perf_counter() - t0
        launches = read_counts()
        count = int(dict(line.rsplit(": ", 1) for line in printed.getvalue().splitlines()
                         if ": " in line)["Number of trainable parameters in the model"])
        out = {"seconds": cli_s, "history": history, "evaluation_s": eval_s,
               "evaluation": {k: float(v) for k, v in metrics.items()},
               "trainable_count": count, "launches": launches}
        emit({"phase": "zoo", "model": name, "part": "cli", **out})
        check(len(history["train_loss"]) == 1 and all(
            np.isfinite(history["train_loss"] + history["val_loss"])), f"zoo {name}: {history}")
        check(all(np.isfinite(list(out["evaluation"].values()))),
              f"zoo {name}: evaluation {out['evaluation']}")
        check(count == evaluation.count_trainable_params(model),
              f"zoo {name}: the tool printed {count} trainable parameters")
        del model
    return launches


def phase_zoo(name: str, sets: tuple) -> dict:
    """One model of ``ZOO``: serve, train (and the CLI for ``ZOO_CLI``); the
    path ``zoo_<name>`` holds their launches, and must launch its
    ``PATH_KERNELS`` and no other."""
    path = f"zoo_{name}"
    t0 = time.perf_counter()
    total = collections.Counter(_zoo_serve(name, sets))
    torch.cuda.empty_cache()
    total.update(_zoo_train(name, sets))
    if name == ZOO_CLI:
        total.update(_zoo_cli(name, sets))
    torch.cuda.empty_cache()
    total = {k: total.get(k, 0) for k in read_counts()}
    emit({"phase": "zoo", "model": name, "sets": list(sets), "launches": total,
          "seconds": time.perf_counter() - t0})
    check_path_launches(path, total, f"during {path}")
    return {path: total}


def phase_op_dispatch() -> dict:
    """Host microseconds of one call through each ``torch.library`` op
    against one call of its CUDA implementation, at small shapes where the
    host is the limit: 200 calls back to back, in turns op, direct, direct,
    op. The train steps call the ops too (K1's and K4's forwards, 13 calls a
    flagship step and 12 a DA-V2 step), so the difference times those counts
    is what the op costs a step's host."""
    from mde_tpu_torch.ops import kernels as K

    def host_us(fn, n: int = 200) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    u8 = torch.randint(0, 256, (1, 8, 8, 3), dtype=torch.uint8, device="cuda")
    q, k, v = (torch.randn(1, 1, 256, 32, device="cuda") for _ in range(3))
    valid = torch.ones(1, 256, device="cuda")
    f = torch.randn(1, 64, 6, 64, device="cuda")
    cases = {
        "preprocess_u8": (lambda: K.preprocess_u8_op(u8, 8, 8),
                          lambda: K._preprocess_u8_cuda(u8, 8, 8)),
        "window_attention": (lambda: K.window_attention_op(q, k, v, valid, 8, False),
                             lambda: K._window_attention_cuda(q, k, v, valid, 8, False)),
        "flash_attention": (lambda: K.flash_attention_op(f, f, f, False),
                            lambda: K._flash_attention_cuda(f, f, f, False)),
    }
    out = {}
    for name, (op, direct) in cases.items():
        for fn in (op, direct):
            host_us(fn, 20)
        turns = {"op": [], "direct": []}
        for key in ("op", "direct", "direct", "op"):
            turns[key].append(host_us(op if key == "op" else direct))
        op_us, direct_us = (statistics.median(turns[k_]) for k_ in ("op", "direct"))
        out[name] = {"op_us": op_us, "direct_us": direct_us, "overhead_us": op_us - direct_us,
                     "turns": turns}
    k1, k4 = out["window_attention"]["overhead_us"], out["flash_attention"]["overhead_us"]
    out["train_step_overhead_us"] = {"flagship": k1 + 12 * k4, "da2": 12 * k4}
    reset_counts()
    emit({"phase": "op_dispatch", **out})
    return out


# The parallel phase: (model, compute type) runs of PARALLEL_STEPS train
# steps at global batch TRAIN_SHAPE[0], each held against the one-process
# step on the same batches and generators. The learning rate is 0: in
# float32 the flagship's trajectory is chaotic after one AdamW step (its
# first update is lr * sign(g); two summation orders of one process give
# second-step losses 3% apart, tests/test_torch_parallel.py), so every step
# runs at the same weights and the check holds each step's loss and the
# last step's averaged gradient. Losses: float32 TOL_TRAIN_LOSS, bf16
# TOL_BF16_LOSS; the state after the steps (BN buffers move) rel-L2 at the
# loss's bound; the gradient's rel-L2 against the one-process gradient of
# the same type: float32 TOL_GRAD_GLOBAL (the flagship's noise band), bf16
# PARALLEL_BF16_GRAD times a noise witness measured in the same run. The
# witness is the one-process bf16 step against itself with its BatchNorm
# layers in the cross-process form: a world of one over NCCL, whose
# all-reduces change nothing, on the same rows. The ranks' step differs
# from one process by that form and by the split of the batch's sums over
# two processes, two reorderings of bf16 sums; the flagship's bf16 gradient
# is mostly such rounding (0.74 rel-L2 from its float32 gradient in one
# process: ``grad_rel_l2_vs_float32`` on the run's line). DA-V2-S has no BatchNorm, so its witness is
# cuDNN's run-to-run noise alone; PARALLEL_BF16_GRAD_FLOOR (4x its ranks'
# 0.0023) stands in below it. A gradient of zeros, or of the wrong rows,
# reads about 1 or more.
PARALLEL_RUNS = (("flagship", "float32"), ("flagship", "bfloat16"), ("da2", "bfloat16"))
PARALLEL_STEPS = 3
PARALLEL_BF16_GRAD, PARALLEL_BF16_GRAD_FLOOR = 1.5, 0.01
# Each rank's launches a step: K3's train form, K2 forward and backward, K4
# forward once per DINOv2 block (12; DA-V2-S's backward as well), K1
# forward and backward once per cross-attention (the flagship).
PARALLEL_STEP_LAUNCHES = {
    ("flagship", "float32"): {"preprocess_u8_train": 1, "si_loss_sums": 1,
                              "si_loss_sums_backward": 1, "flash_attention": 12,
                              "window_attention": 1, "window_attention_backward": 1},
    ("flagship", "bfloat16"): {"preprocess_u8_train": 1, "si_loss_sums": 1,
                               "si_loss_sums_backward": 1, "flash_attention_bf16": 12,
                               "window_attention_bf16": 1, "window_attention_backward_bf16": 1},
    ("da2", "bfloat16"): {"preprocess_u8_train": 1, "si_loss_sums": 1,
                          "si_loss_sums_backward": 1, "flash_attention_bf16": 12,
                          "flash_attention_backward_bf16": 12},
}


# One run at the config's learning rate (1e-4), so that an optimizer update
# under DDP is held against one process on the card: PARALLEL_F64_STEPS
# flagship steps in float64, through the kernels' plain versions (the
# kernels take float32 and bf16), losses and the state after (trainable
# parameters and BN buffers) at TOL_PARALLEL_F64, the bound the CPU test
# holds two gloo ranks to (tests/test_torch_parallel.py).
PARALLEL_F64_STEPS = 2
TOL_PARALLEL_F64 = 1e-5
# The cross-process BatchNorm alone, bf16 input and float32 parameters (as
# autocast runs it) on the ranks' 2 + 2 rows, against cuDNN's BatchNorm on
# the 4 at the flagship's first BN layer (pretrained.layer1.1 at 448x576).
# Everything against the layer in float64 on the same bf16 values (cuDNN's
# distances from it beside, on the line). Output and input gradient: float32
# values rounded once to bf16, so within half a bf16 ulp (2^-8 of the value)
# plus TOL_BN_ATOL for the float32 error before the rounding. The weight and
# bias gradients (the ranks' shares added) rel-L2 TOL_BN_SUMS: each is a sum
# of 2^21 terms a channel that cancel to about 1/1000 of their magnitudes,
# which this layer sums in float64 (cuDNN's float32 sums read 0.0036-0.0041
# from float64). The running statistics rel-L2 TOL_BN_STATS.
PARALLEL_BN_SHAPE = (4, 32, 224, 288)
TOL_BN_RTOL, TOL_BN_ATOL = 2 ** -8, 1e-5
TOL_BN_SUMS, TOL_BN_STATS = 1e-5, 1e-5


def _parallel_world() -> tuple[int, str, str]:
    """(W, --device, backend): one card a rank over NCCL with two cards or
    more (W divides the global batch), else two ranks sharing card 0 over
    gloo, which NCCL refuses; named on the phase's lines."""
    n = torch.cuda.device_count()
    if n >= 2:
        return (4 if n >= 4 else 2), "cuda", "nccl"
    return 2, "cuda:0", "gloo"


def phase_parallel() -> dict:
    """Data-parallel training (``mde_tpu_torch/parallel``) on W ranks, each a
    process started by ``parallel.launch``: the PARALLEL_RUNS against the
    one-process step and against a world of one over NCCL through the same
    DDP code (the bf16 runs' noise witness), the float64 update and the bf16
    BatchNorm layer against one process,
    ``fit`` with ``generate_test_predictions`` (histories equal on every
    rank, one checkpoint, a prediction an image) and the evaluation steps
    (the same metrics on every rank), then the training CLI at
    W, which starts its ranks itself. Returns the launches of the W-rank runs
    summed over ranks."""
    from mde_tpu_torch.data import synthetic
    from mde_tpu_torch.parallel import launch
    from mde_tpu_torch.tools import main as train_cli
    from mde_tpu_torch.tools.common import set_float32_precision

    world, device, backend = _parallel_world()
    set_float32_precision()
    out = {"phase": "parallel", "world": world, "device": device, "backend": backend,
           "cards": torch.cuda.device_count(),
           "note": ("two ranks share one card over gloo (NCCL refuses two ranks on one card): "
                    "a correctness run; its step times are not a scaling figure"
                    if backend == "gloo" else "one card a rank over NCCL")}
    emit(out)
    total = dict.fromkeys(_counters(), 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        rng = np.random.default_rng(SEED + 7)
        batches = []
        for _ in range(PARALLEL_STEPS):
            samples = [synthetic.make_sample(rng, *TRAIN_SHAPE[1:]) for _ in range(TRAIN_SHAPE[0])]
            batches.append({"rgb": np.stack([x[0] for x in samples]),
                            "depth": np.stack([x[1] for x in samples])})
        torch.save(batches, os.path.join(tmp, "batches.pt"))
        gens = [[SEED, 0, i] for i in range(PARALLEL_STEPS)]
        runs, jobs = {}, []
        for name, dtype in PARALLEL_RUNS:
            label = f"{name}_{dtype}"
            extra = (f"framework.compute_dtype={dtype}", "framework.learning_rate=0")
            sets = list((DA2_SETS if name == "da2" else ()) + extra)
            cfg = model_cfg(name, *extra)
            model = make_model(name, cfg, bias=0.5 if name == "da2" else 2.0)
            torch.save(model, os.path.join(tmp, f"{name}.pt"))
            runs[label] = (name, dtype, cfg, model)
            jobs.append({"name": label, "mode": "steps", "model": os.path.join(tmp, f"{name}.pt"),
                         "sets": sets, "batches": os.path.join(tmp, "batches.pt"),
                         "generators": gens, "grads": True})
        data = os.path.join(tmp, "data")
        synthetic.generate(data, n_train=16, n_test=5, size=TRAIN_SHAPE[1:], seed=SEED)
        fit_sets = [f"paths.data_dir={data}", f"paths.results_dir={tmp}/fit/results",
                    f"paths.predictions_dir={tmp}/fit/predictions", "training.n_epoch=2",
                    "framework.learning_rate=0", "experiment.wandb_disable=true"]
        jobs.append({"name": "fit", "mode": "fit", "model": os.path.join(tmp, "flagship.pt"),
                     "sets": fit_sets})
        jobs.append({"name": "flagship_float64", "mode": "steps",
                     "model": os.path.join(tmp, "flagship.pt"),
                     "sets": ["framework.compute_dtype=float32"],
                     "batches": os.path.join(tmp, "batches.pt"),
                     "generators": gens[:PARALLEL_F64_STEPS], "float64": True, "plain": True})
        bn_input = _bn_input()
        torch.save(bn_input, os.path.join(tmp, "bn_bf16.pt"))
        jobs.append({"name": "bn_bf16", "mode": "batchnorm",
                     "input": os.path.join(tmp, "bn_bf16.pt")})
        reset_counts()
        t0 = time.perf_counter()
        got = launch.run({"world": world, "device": device, "out": tmp, "threads": 4,
                          "jobs": jobs}, os.path.join(tmp, "spec.json"), timeout=900,
                         backend=backend)
        ranks_s = time.perf_counter() - t0
        check(read_counts() == dict.fromkeys(_counters(), 0),
              "the main process launched a kernel while the ranks ran")
        # a world of one over NCCL through the same DDP code, the BN layers
        # in the cross-process form: each run's noise witness
        world1 = launch.run({"world": 1, "device": "cuda", "out": tmp, "jobs": [
            {**job, "name": f"world1_{job['name']}"} for job in jobs[:len(runs)]]},
            os.path.join(tmp, "spec1.json"), timeout=300, backend="nccl")
        check(all(r["backend"] == backend and r["world"] == world
                  for job in got.values() for r in job),
              f"ranks ran over {[(r['backend'], r['world']) for r in got['fit']]}")
        results = {}
        for label, (name, dtype, cfg, model) in runs.items():
            result = results[label] = _check_parallel_run(label, name, dtype, cfg, model,
                                                          got[label], batches,
                                                          world1[f"world1_{label}"][0])
            for r in got[label]:
                for step in r["launches"]:
                    for k, v in step.items():
                        total[k] += v
        _check_parallel_float64(runs["flagship_float32"][3], got["flagship_float64"],
                                batches[:PARALLEL_F64_STEPS])
        _check_parallel_bn(bn_input, got["bn_bf16"])
        fit = got["fit"]
        hist = [r["history"] for r in fit]
        ckpts = sorted(f for f in os.listdir(f"{tmp}/fit/results") if f.endswith(".pth"))
        preds = sorted(os.listdir(f"{tmp}/fit/predictions"))
        emit({**out, "run": "fit", "seconds_all_jobs": ranks_s,
              "history": {k: hist[0][k] for k in ("train_loss", "val_loss", "n_train")},
              "written": [r["written"] for r in fit], "checkpoints": ckpts,
              "predictions": len(preds), "evaluate": fit[0]["evaluate"],
              "suite": fit[0]["suite"]})
        check(all(h[k] == hist[0][k] for h in hist for k in ("train_loss", "val_loss", "n_train")),
              "fit's histories differ between ranks")
        check(all(r["evaluate"] == fit[0]["evaluate"] and r["suite"] == fit[0]["suite"]
                  for r in fit), "the ranks' evaluation metrics differ")
        check(all(np.isfinite(list(fit[0]["evaluate"].values()))), "non-finite metrics")
        check(len(hist[0]["train_loss"]) == 2 and np.isfinite(hist[0]["val_loss"]).all(),
              f"fit history {hist[0]}")
        check(len(ckpts) == 1, f"checkpoints {ckpts}")
        check(len(preds) == 5 and sum(r["written"] for r in fit) == 5,
              f"predictions {preds}, written {[r['written'] for r in fit]}")
        arrays = [np.load(os.path.join(f"{tmp}/fit/predictions", p_)) for p_ in preds]
        check(all(a.shape == TRAIN_SHAPE[1:] and np.isfinite(a).all() for a in arrays),
              "fit's predictions are not finite native-size maps")

        one = world1["world1_flagship_float32"][0]
        loss0 = one["losses"][0]["loss"]
        want0 = results["flagship_float32"]["losses_one_process"][0]
        emit({**out, "run": "nccl_world1", "backend_ran": one["backend"], "loss": loss0,
              "one_process_loss": want0, "step_ms": one["step_ms"],
              "one_process_step_ms": results["flagship_float32"]["step_ms_one_process"]})
        check(one["backend"] == "nccl", f"the world of one ran over {one['backend']}")
        check(abs(loss0 - want0) <= TOL_TRAIN_LOSS * abs(want0),
              f"NCCL world of one: loss {loss0} vs one process {want0}")

        # the training CLI at W, which starts its own ranks
        cli_results = os.path.join(tmp, "cli", "results")
        pred_dir = os.path.join(tmp, "cli", "preds")
        argv = ["--device", device, "--data-dir", data,
                *(a for x in ("training.n_epoch=2", f"framework.mesh.data={world}",
                              f"paths.results_dir={cli_results}",
                              f"paths.predictions_dir={pred_dir}",
                              "experiment.wandb_disable=true") for a in ("--set", x))]
        saved = os.environ.get("MDE_DIST_BACKEND")
        os.environ["MDE_DIST_BACKEND"] = backend
        t0 = time.perf_counter()
        try:
            returned = train_cli.main(argv)
        finally:
            if saved is None:
                os.environ.pop("MDE_DIST_BACKEND")
            else:
                os.environ["MDE_DIST_BACKEND"] = saved
        cli_s = time.perf_counter() - t0
        ckpts = sorted(f for f in os.listdir(cli_results) if f.endswith(".pth"))
        preds = sorted(os.listdir(pred_dir))
        emit({**out, "run": "cli", "seconds": cli_s, "checkpoints": ckpts,
              "predictions": len(preds)})
        check(returned is None, "the CLI trained in this process instead of starting its ranks")
        check(len(ckpts) == 1 and len(preds) == 5, f"CLI wrote {ckpts}, {len(preds)} predictions")
    check_path_launches("parallel", total, "by the ranks' train steps")
    return total


def _one_process_steps(model, cfg, batches, float64: bool = False) -> tuple[list, list, dict, dict]:
    """The one-process steps on the card: (losses, step ms, the last step's
    gradients, the state_dict after). ``float64``: the model and the
    pipeline's outputs in float64, through the kernels' plain versions, as
    the ranks' ``float64`` job runs."""
    from mde_tpu_torch.data.transforms import make_train_pipeline
    from mde_tpu_torch.parallel import launch
    from mde_tpu_torch.train.trainer import make_optimizer, make_train_step, step_generator

    model = copy.deepcopy(model).cuda()
    if float64:
        model = model.double()
        pipeline = launch.float64_pipeline(
            make_train_pipeline(bool(cfg.augmentation), cfg.framework.input_size))
        with launch.train_pipeline(pipeline):
            step = make_train_step(model, cfg, make_optimizer(model, cfg), plain=True)
    else:
        step = make_train_step(model, cfg, make_optimizer(model, cfg))
    losses, ms = [], []
    for i, b in enumerate(batches):
        rgb, depth = torch.from_numpy(b["rgb"]).cuda(), torch.from_numpy(b["depth"]).cuda()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = step(rgb, depth, step_generator(SEED, 0, i))
        losses.append({k: v.item() for k, v in metrics.items()})
        ms.append((time.perf_counter() - t1) * 1e3)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    return losses, ms, grads, model.state_dict()


def _grad_rel(got: dict, want: dict) -> float:
    keys = sorted(want)
    return _rel_l2(torch.cat([got[k].double().flatten() for k in keys]),
                   torch.cat([want[k].double().flatten() for k in keys]))


def _subtree_rel(got: dict, want: dict) -> dict:
    """Gradient rel-L2 by top-level module."""
    out = {}
    for top in sorted({k.split(".", 1)[0] for k in want}):
        keys = sorted(k for k in want if k.split(".", 1)[0] == top)
        out[top] = _grad_rel({k: got[k] for k in keys}, {k: want[k] for k in keys})
    return out


def _gap_leaves(got: dict, want: dict, n: int = 3) -> list:
    """The ``n`` parameters carrying most of the squared gradient gap: (name,
    share of the gap, the parameter's own rel-L2)."""
    sq = {k: (got[k].double() - want[k].double()).square().sum().item() for k in want}
    total = sum(sq.values())
    return [(k, sq[k] / total, _grad_rel({k: got[k]}, {k: want[k]}))
            for k in sorted(sq, key=sq.get, reverse=True)[:n]]


def _check_parallel_run(label, name, dtype, cfg, model, ranks, batches, world1) -> dict:
    """The one-process steps of ``label`` on the card against its W-rank run;
    returns the numbers the phase line prints. ``world1`` is the run's world
    of one over NCCL: its gradient against one process's is the noise
    witness a bf16 run's gradient is held to (PARALLEL_RUNS' comment)."""
    losses, ms, grads, state = _one_process_steps(model, cfg, batches)
    state = {k: v.detach().cpu().float() for k, v in state.items()
             if k in ranks[0]["state_dict"] and v.is_floating_point()}
    r0 = ranks[0]
    tol_loss = TOL_TRAIN_LOSS if dtype == "float32" else TOL_BF16_LOSS
    loss_rel = [abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(r0["losses"], losses)]
    grad_rel = _grad_rel(r0["grads"], grads)
    state_rel = _rel_l2(torch.cat([r0["state_dict"][k].double().flatten() for k in state]),
                        torch.cat([state[k].double().flatten() for k in state]))
    want = PARALLEL_STEP_LAUNCHES[(name, dtype)]
    per_step = [{k: v for k, v in step_.items() if v} for r in ranks for step_ in r["launches"]]
    result = {"losses_ranks": [x["loss"] for x in r0["losses"]],
              "losses_one_process": [x["loss"] for x in losses], "loss_rel": loss_rel,
              "grad_rel_l2": grad_rel, "state_rel_l2": state_rel,
              "step_ms_by_rank": [r["step_ms"] for r in ranks], "step_ms_one_process": ms,
              "launches_per_rank_step": per_step[0]}
    witness = _grad_rel(world1["grads"], grads)
    result.update(witness_bn_form_world1=witness,
                  grad_rel_l2_ranks_vs_world1=_grad_rel(r0["grads"], world1["grads"]),
                  grad_rel_l2_by_subtree={"ranks": _subtree_rel(r0["grads"], grads),
                                          "witness": _subtree_rel(world1["grads"], grads)},
                  gap_leaves=_gap_leaves(r0["grads"], grads))
    if dtype == "float32":
        tol_grad = TOL_GRAD_GLOBAL
    else:
        tol_grad = PARALLEL_BF16_GRAD * max(witness, PARALLEL_BF16_GRAD_FLOOR)
        cfg32 = copy.deepcopy(cfg)
        cfg32.framework.compute_dtype = "float32"
        grads32 = _one_process_steps(model, cfg32, batches)[2]
        result["grad_rel_l2_vs_float32"] = {"ranks": _grad_rel(r0["grads"], grads32),
                                            "one_process": _grad_rel(grads, grads32)}
    result["tolerances"] = {"loss": tol_loss, "grad": tol_grad, "state": tol_loss}
    check(all(r["losses"] == r0["losses"] for r in ranks), f"{label}: ranks' losses differ")
    check(all(r["fingerprint"] == r0["fingerprint"] for r in ranks),
          f"{label}: ranks' weights differ after the steps")
    check(all(np.isfinite([x["loss"] for x in r0["losses"]])), f"{label}: non-finite loss")
    emit({"phase": "parallel", "run": label, **result})
    check(max(loss_rel) <= tol_loss, f"{label}: losses {loss_rel} above {tol_loss}")
    check(grad_rel <= tol_grad, f"{label}: gradient rel-L2 {grad_rel} above {tol_grad}")
    check(state_rel <= tol_loss, f"{label}: state rel-L2 {state_rel} above {tol_loss}")
    check(all(s_ == want for s_ in per_step),
          f"{label}: launches a rank a step {per_step}, want {want}")
    return result


def _check_parallel_float64(model, ranks, batches) -> dict:
    """The ranks' float64 steps at the config's learning rate against one
    process's on the card (PARALLEL_F64_STEPS)."""
    cfg = model_cfg("flagship", "framework.compute_dtype=float32")
    losses, ms, _, state = _one_process_steps(model, cfg, batches, float64=True)
    r0 = ranks[0]
    keys = [k for k, v in r0["state_dict"].items() if v.is_floating_point()]
    state = {k: state[k].detach().cpu() for k in keys}
    before = model.state_dict()
    loss_rel = [abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(r0["losses"], losses)]
    state_rel = _rel_l2(torch.cat([r0["state_dict"][k].double().flatten() for k in keys]),
                        torch.cat([state[k].double().flatten() for k in keys]))
    moved = sum(not torch.equal(state[k].float(), before[k].float()) for k in keys)
    per_step = [{k: v for k, v in s_.items() if v} for r in ranks for s_ in r["launches"]]
    result = {"learning_rate": float(cfg.framework.learning_rate),
              "losses_ranks": [x["loss"] for x in r0["losses"]],
              "losses_one_process": [x["loss"] for x in losses], "loss_rel": loss_rel,
              "state_rel_l2": state_rel, "tensors_moved": moved, "tensors": len(keys),
              "step_ms_by_rank": [r["step_ms"] for r in ranks], "step_ms_one_process": ms,
              "tolerance": TOL_PARALLEL_F64}
    emit({"phase": "parallel", "run": "flagship_float64", **result})
    check(all(r["losses"] == r0["losses"] and r["fingerprint"] == r0["fingerprint"]
              for r in ranks), "float64: the ranks' losses or weights differ")
    check(max(loss_rel) <= TOL_PARALLEL_F64, f"float64: losses {loss_rel}")
    check(state_rel <= TOL_PARALLEL_F64, f"float64: state rel-L2 {state_rel}")
    check(moved > 100, f"float64: only {moved} tensors moved: no update ran")
    check(all(not s_ for s_ in per_step), f"float64 runs the plain versions, launched {per_step}")
    return result


def _bn_input() -> dict:
    """x and dy in bf16 at PARALLEL_BN_SHAPE (channel means and scales of a
    convolution's output), a float32 BatchNorm2d state_dict."""
    g = torch.Generator().manual_seed(SEED + 11)
    c = PARALLEL_BN_SHAPE[1]
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
        bn.running_mean.uniform_(-0.5, 0.5, generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    scale = torch.rand(1, c, 1, 1, generator=g) * 1.5 + 0.5
    mean = torch.rand(1, c, 1, 1, generator=g) * 6 - 3
    x = torch.randn(PARALLEL_BN_SHAPE, generator=g) * scale + mean
    return {"x": x.bfloat16(), "dy": torch.randn(PARALLEL_BN_SHAPE, generator=g).bfloat16(),
            "state_dict": bn.state_dict()}


def _check_parallel_bn(data: dict, ranks) -> dict:
    """The ranks' cross-process BatchNorm (bf16 input) against cuDNN's
    BatchNorm on the global batch, and both against the layer in float64 on
    the same bf16 values, on the card."""
    def run(dtype):
        bn = torch.nn.BatchNorm2d(PARALLEL_BN_SHAPE[1]).to("cuda", dtype).train()
        bn.load_state_dict(data["state_dict"])
        x = data["x"].cuda().to(dtype if dtype == torch.float64 else torch.bfloat16)
        x.requires_grad_(True)
        y = bn(x)
        y.backward(data["dy"].cuda().to(x.dtype))
        return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
                "running_mean": bn.running_mean, "running_var": bn.running_var}

    cudnn, exact = run(torch.float32), run(torch.float64)
    ours = {k: torch.cat([r[k] for r in ranks]).cuda() for k in ("y", "dx")}
    ours.update({k: sum(r[k] for r in ranks).cuda() for k in ("dw", "db")})
    ours.update({k: ranks[0]["state_dict"][k].cuda() for k in ("running_mean", "running_var")})
    result = {"shape": list(PARALLEL_BN_SHAPE), "input": "bfloat16", "parameters": "float32",
              "tolerances": {"rtol": TOL_BN_RTOL, "atol": TOL_BN_ATOL, "sums": TOL_BN_SUMS,
                             "stats": TOL_BN_STATS}}
    checks = []
    for key in ("y", "dx"):
        got, want = ours[key].double(), exact[key]

        def excess(t):  # beyond half a bf16 ulp of the float64 value
            return ((t.double() - want).abs() - TOL_BN_RTOL * want.abs()).max().item()

        result[key] = {"dtype": str(ours[key].dtype), "max_abs": want.abs().max().item(),
                       "excess_over_half_ulp": {"ours": excess(got),
                                                "cudnn": excess(cudnn[key])},
                       "rel_l2_vs_float64": {"ours": _rel_l2(got, want),
                                             "cudnn": _rel_l2(cudnn[key].double(), want)},
                       "differing_from_cudnn": int((ours[key] != cudnn[key]).sum().item())}
        checks.append((ours[key].dtype == torch.bfloat16 and excess(got) <= TOL_BN_ATOL,
                       f"bn_bf16: {key} ({ours[key].dtype}) beyond half a bf16 ulp of float64 "
                       f"by {excess(got)}"))
    for key, tol in (("dw", TOL_BN_SUMS), ("db", TOL_BN_SUMS), ("running_mean", TOL_BN_STATS),
                     ("running_var", TOL_BN_STATS)):
        rel = _rel_l2(ours[key].double(), exact[key])
        result[key] = {"rel_l2_vs_float64": {"ours": rel,
                                             "cudnn": _rel_l2(cudnn[key].double(), exact[key])},
                       "rel_l2_vs_cudnn": _rel_l2(ours[key].double(), cudnn[key].double())}
        checks.append((rel <= tol, f"bn_bf16: {key} rel-L2 {rel} from float64"))
    emit({"phase": "parallel", "run": "bn_bf16", **result})
    for ok, msg in checks:
        check(ok, msg)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 1
    os.environ["WANDB_MODE"] = "disabled"  # no experiment tracker may reach the network
    kind, _ = phase_device()
    phase_build()
    if sys.argv[1:] == ["--k4-backward-only"]:
        # K4's backward alone, at every case in both types: the quick run
        # that compares two trees in turns on one card
        from mde_tpu_torch.ops import kernels as K

        emit({"k4_backward": _check_k4_backward_all(K, torch.Generator().manual_seed(SEED))})
        return 0
    if sys.argv[1:] == ["--k2-only"]:
        # K2 alone, at every case: the quick run that compares two trees in
        # turns on one card
        from mde_tpu_torch.ops import kernels as K

        g = torch.Generator().manual_seed(SEED)
        emit({"k2": _check_k2_all(K, g)})
        emit({"k2_sass": _sass_counts(K, "si_")})
        return 0
    if sys.argv[1:] == ["--parallel-only"]:
        # the data-parallel phase alone: the quick run for its own changes
        emit({"parallel_launches": phase_parallel()})
        return 0
    if sys.argv[1:] == ["--zoo-only"]:
        # the zoo phase alone: the quick run for the zoo's models
        by_path = {}
        for name, sets in ZOO:
            by_path.update(phase_zoo(name, sets))
        emit({"zoo_launches": by_path})
        return 0
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}; the only ones are "
          "--k4-backward-only, --k2-only, --parallel-only and --zoo-only")
    kernels = phase_kernels()
    phase_op_dispatch()
    by_path = {}
    for name in ("flagship", "da2"):
        by_path[f"{name}_serve"] = phase_serve(name)
        by_path.update(phase_train(name))  # the train path, then the tools on its checkpoint
    by_path["flagship_augment"] = phase_augment()
    for name, sets in ZOO:
        by_path.update(phase_zoo(name, sets))
    by_path["parallel"] = phase_parallel()
    rows = []
    for name, source, replaces in (
            ("window_attention", K1_SOURCE, K1_REPLACES),
            ("window_attention_bf16", K1_SOURCE, K1_REPLACES),
            ("window_attention_backward", K1_SOURCE, K1_BWD_REPLACES),
            ("window_attention_backward_bf16", K1_SOURCE, K1_BWD_REPLACES),
            ("preprocess_u8", K3_SOURCE, K3_REPLACES),
            ("preprocess_u8_train", K3_TRAIN_SOURCE, K3_REPLACES),
            ("si_loss_sums", K2_SOURCE, K2_REPLACES),
            ("si_loss_sums_backward", K2_SOURCE, K2_BWD_REPLACES),
            ("flash_attention", K4_SOURCE, K4_REPLACES),
            ("flash_attention_bf16", K4_SOURCE, K4_REPLACES),
            ("flash_attention_backward", K4_SOURCE, K4_REPLACES),
            ("flash_attention_backward_bf16", K4_SOURCE, K4_REPLACES)):
        launches = {p: counts[name] for p, counts in by_path.items()}
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(launches.values()), "launches_by_path": launches,
                     **kernels[name]})
        missing = ROW_KEYS - set(rows[-1])
        check(not missing, f"kernel row {name} lacks {sorted(missing)}")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
