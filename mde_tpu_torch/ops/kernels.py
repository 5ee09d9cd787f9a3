"""Hand-written CUDA kernels of the serving and training paths, each beside
its plain version.

Port of mde_tpu/ops/pallas_kernels.py. The kernels live in
``mde_tpu_torch/csrc`` and are built with ``nvcc`` into one shared library with
a plain C interface, loaded with ``ctypes``:

- ``window_attention`` (csrc/window_attention.cu) replaces
  ``window_attention_fused`` (pallas_kernels.py:163-225), in float32 and in
  bfloat16 (the mixed-precision train step; at head_dim 4 and 8 a base-2
  softmax over keys pre-scaled in shared memory, several query rows a
  thread, the keys split into 4 slices merged in a fixed order), and its
  gradient ``_pallas_wa_bwd`` (mde_tpu/ops/window_attention.py:103-110) with
  a backward kernel in both types (one block per window and head, fed the
  forward's row statistics, which the forward writes only when a backward
  will follow, and its stored output; each probability formed once in
  register tiles, sums in a fixed order, no atomics);
- ``si_loss_sums`` (csrc/si_loss.cu) replaces ``si_loss_sums``
  (pallas_kernels.py:56-144), forward and backward; the forward is one
  launch (a block a tile of a sample, 16-byte loads where the rows allow
  them; the block that finishes a sample's last tile adds its tiles'
  partials in a fixed order) into one allocation (``si_loss_sums_plan``
  picks the path and the tiles from the shape and the SM count);
- ``preprocess_u8`` (csrc/preprocess.cu) replaces ``normalize_u8_fused``
  (pallas_kernels.py:233-260), fused with the half-pixel bilinear resize that
  precedes it in ``preprocess_eval`` (a band of output rows a block over
  source rows staged in shared memory, 4 pixels a thread, 16-byte stores);
  ``preprocess_u8_train`` (csrc/preprocess_train.cu) is its train form, with
  the colour jitter of ``preprocess_train`` (mde_tpu/ops/image.py::color_jitter)
  between the resize and the normalisation, in one cooperative launch (a
  grid barrier before contrast; two plain launches where the shape allows no
  cooperative grid) from draws made on the host and passed by value in the
  launch's parameters;
- ``flash_attention`` (csrc/flash_attention.cu) replaces ``flash_attention``
  (mde_tpu/ops/flash_attention.py:39-80), in float32 and in bfloat16, forward
  and backward; every ViT attention of the port runs through it. At DA-V2-S's
  training shape (4, 1345, 6, 64) the forward is 11.1 GFLOP and the backward
  27.8 GFLOP (2.5x, the recompute of S included) against 16.5 MB of q/k/v/o in
  bf16, about 670 FLOP a byte: compute-bound. So every product runs on the
  tensor cores (``mma.sync``: bf16 m16n8k16, and float32 as 3xTF32 m16n8k8,
  which keeps float32 accuracy), with the logits, probabilities and their
  gradients kept in registers and K/V (or q/dO) streamed through shared
  memory by ``cp.async``. The backward is a kernel too (delta, then dK/dV,
  then dQ; deterministic, no atomics), fed the forward's log-sum-exp, which
  the forward writes only when a backward will follow; in float32 each
  streamed tile is split into its TF32 parts once a block, and in bf16 the
  warps' own rows go into registers once, dQ's as two 16-row tiles a warp
  (``flash_attention_backward_plan`` reports rows, threads, shared bytes and
  blocks an SM).

Each wrapper takes its plain PyTorch version for a tensor on the CPU, and for a
CUDA tensor checks device, dtype, shape and contiguity, then launches the
kernel or raises. The forwards of the predict path (K1, K3's eval form and
K4) are ``torch.library`` ops in the ``mde_tpu`` namespace
(``torch.ops.mde_tpu.window_attention``, ``.preprocess_u8`` and
``.flash_attention``): a fake implementation gives their outputs' shapes, the
CPU implementation is the plain version and the CUDA one launches the kernel
(or raises), so that ``torch.export`` records each as one node of its graph
(it cannot trace a ctypes call) and a program loaded from an archive launches
the kernels. Their wrappers and autograd Functions call the op; the
backward kernels, K2 and K3's train form are called directly. Each counts
its launches in a ``launches`` attribute (``bf16_launches``,
``backward_launches``, ``bf16_backward_launches`` and
``backward_bf16_launches`` for the other forms; K1's ``stats_launches``
counts the forwards that also wrote the row statistics), in the CUDA
implementation, so that a loaded program's launches count too.

The library is built at first use into ``mde_tpu_torch/_build`` (listed in
.gitignore), named by a hash of the sources and flags, so an edited source is
rebuilt. Nothing is imported or compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .image import (IMAGENET_MEAN, IMAGENET_STD, color_jitter_apply, normalize_imagenet,
                    to_float)

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# per source, with -c; -Xptxas -v reports each kernel's registers, spills and
# shared memory into ``build_log``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib = None
_lib_lock = threading.Lock()
build_seconds = None  # wall time of the nvcc run in this process, if one ran
build_log = {}  # source name -> nvcc's report (ptxas -v), from a build in this process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources, headers and flags is (or
    will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmde_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library unless it exists:
    one ``nvcc -c`` per source, all started together, then one link."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objects)]
        errors = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            build_log[src.name] = err
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build in another process sees all or nothing
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return so


def load():
    """The kernels' ctypes library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            ll = ctypes.c_longlong
            for name in ("mde_window_attention_f32", "mde_window_attention_bf16"):
                getattr(lib, name).argtypes = [p] * 6 + [i, i, i, i, i, f, p]
                getattr(lib, name).restype = i
            for name in ("mde_window_attention_backward_f32", "mde_window_attention_backward_bf16"):
                getattr(lib, name).argtypes = [p] * 10 + [i, i, i, i, i, f, p]
                getattr(lib, name).restype = i
            lib.mde_si_loss_sums_f32.argtypes = [p, p, p, p, i, ll, i, i, f, p]
            lib.mde_si_loss_sums_f32.restype = i
            lib.mde_si_loss_backward_f32.argtypes = [p, p, p, p, p, p, i, ll, f, p]
            lib.mde_si_loss_backward_f32.restype = i
            lib.mde_preprocess_u8_f32.argtypes = [p, p] + [i] * 5 + [f] * 6 + [p]
            lib.mde_preprocess_u8_f32.restype = i
            lib.mde_preprocess_u8_train_plan.argtypes = [i] * 5 + [p]
            lib.mde_preprocess_u8_train_plan.restype = i
            lib.mde_preprocess_u8_train_f32.argtypes = [p, p, p, ll, p, p] + [i] * 7 + [f] * 6 + [p]
            lib.mde_preprocess_u8_train_f32.restype = i
            for name in ("mde_flash_attention_f32", "mde_flash_attention_bf16"):
                getattr(lib, name).argtypes = [p, p, p, p, p, i, i, i, i, ll, ll, f, p]
                getattr(lib, name).restype = i
            for name in ("mde_flash_attention_backward_f32", "mde_flash_attention_backward_bf16"):
                getattr(lib, name).argtypes = [p] * 10 + [i, i, i, i, ll, ll, f, p]
                getattr(lib, name).restype = i
            lib.mde_flash_attention_backward_plan.argtypes = [i, i, p]
            lib.mde_flash_attention_backward_plan.restype = i
            lib.mde_error_string.argtypes = [i]
            lib.mde_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.mde_error_string(err).decode()})")


def _require(cond: bool, msg) -> None:
    """Raise a ValueError with ``msg`` (or ``msg()``, formatted only on
    failure) unless ``cond``."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


OPS_NAMESPACE = "mde_tpu"
_ops = torch.library.Library(OPS_NAMESPACE, "DEF")


def _define(schema: str, cpu, cuda, fake):
    """Define ``mde_tpu::<schema>`` with its CPU, CUDA and fake
    implementations; returns the op's overload."""
    name = schema.split("(", 1)[0]
    _ops.define(schema)
    _ops.impl(name, cpu, "CPU")
    _ops.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{OPS_NAMESPACE}::{name}", fake, lib=_ops)
    return getattr(getattr(torch.ops, OPS_NAMESPACE), name).default


def _op_device(x: torch.Tensor, name: str) -> None:
    """The ops take CPU and CUDA tensors; any other device raises here, before
    the op, whose fake implementation would answer a meta tensor."""
    _require(x.device.type in ("cpu", "cuda"), lambda: f"{name}: unsupported device {x.device}")


def _no_stats(x: torch.Tensor) -> torch.Tensor:
    """The empty float32 statistics an op returns when none were asked for."""
    return x.new_empty((0,), dtype=torch.float32)


# ---------------------------------------------------------------------------
# K1: windowed attention over pre-partitioned windows
# ---------------------------------------------------------------------------


def window_attention_plain(qw, kw, vw, num_heads: int, key_valid):
    """Plain version: batched einsum attention per window (the math of
    mde_tpu/ops/window_attention.py::_xla_window_attention).

    qw/kw/vw: (B, N, T, C) float32 or bfloat16; key_valid: (N, T), > 0 for a
    real token. Logits, softmax and the weighted sum in float32, with autocast
    off so they stay so inside a bf16 region, as in the kernel; the output is
    rounded once to ``vw``'s dtype. It is the reference of both kernel forms.
    """
    return window_attention_plain_stats(qw, kw, vw, num_heads, key_valid)[0]


def window_attention_plain_stats(qw, kw, vw, num_heads: int, key_valid):
    """``window_attention_plain``'s output and the rows' softmax statistics,
    (B, N, heads, T, 2) float32: the max of the masked, scaled logits and
    the reciprocal of the sum of their exponentials, what the kernel's
    forward writes for its backward."""
    b, n, t, c = qw.shape
    hd = c // num_heads

    def split(x):
        return x.reshape(b, n, t, num_heads, hd).float()

    with torch.autocast(qw.device.type, enabled=False):
        logits = torch.einsum("bnqhd,bnkhd->bnhqk", split(qw), split(kw)) * hd**-0.5
        key_mask = (key_valid > 0)[None, :, None, None, :]
        logits = torch.where(key_mask, logits, torch.finfo(torch.float32).min)
        m = logits.amax(dim=-1, keepdim=True)
        attn = torch.exp(logits - m)
        total = attn.sum(dim=-1, keepdim=True)
        out = torch.einsum("bnhqk,bnkhd->bnqhd", attn / total, split(vw))
        stats = torch.cat([m, 1.0 / total], dim=-1)
    return out.reshape(b, n, t, c).to(vw.dtype), stats


def window_attention_backward_plain(qw, kw, vw, num_heads: int, key_valid, out, stats, dout):
    """Plain version of the backward kernel, its math written out: P =
    exp(S - m) / l from the masked, scaled logits S and the forward's
    ``stats`` (m, 1/l), delta = rowsum(dO O) with ``out`` as stored (bf16 in
    the bf16 form, as the kernel reads it), dS = P (dO v^T - delta) on the
    valid keys only (an invalid key's logit is a constant, so it passes no
    gradient), then dq = dS k / sqrt(hd), dk = dS^T q / sqrt(hd), dv = P^T
    dO; float32 einsums with autocast off, each gradient rounded once to the
    inputs' dtype. ``key_valid`` gets no gradient."""
    b, n, t, c = qw.shape
    hd = c // num_heads
    scale = hd**-0.5

    def split(x):
        return x.reshape(b, n, t, num_heads, hd).float()

    with torch.autocast(qw.device.type, enabled=False):
        qf, kf, vf, of, dof = (split(x) for x in (qw, kw, vw, out, dout))
        key_mask = (key_valid > 0)[None, :, None, None, :]
        logits = torch.einsum("bnqhd,bnkhd->bnhqk", qf, kf) * scale
        logits = torch.where(key_mask, logits, torch.finfo(torch.float32).min)
        p = torch.exp(logits - stats[..., :1]) * stats[..., 1:]
        delta = torch.einsum("bnqhd,bnqhd->bnhq", dof, of)
        ds = p * (torch.einsum("bnqhd,bnkhd->bnhqk", dof, vf) - delta[..., None])
        ds = torch.where(key_mask, ds, 0.0)
        dq = torch.einsum("bnhqk,bnkhd->bnqhd", ds, kf) * scale
        dk = torch.einsum("bnhqk,bnqhd->bnkhd", ds, qf) * scale
        dv = torch.einsum("bnhqk,bnqhd->bnkhd", p, dof)
    return tuple(x.reshape(b, n, t, c).to(qw.dtype) for x in (dq, dk, dv))


def _window_shape(qw, kw, vw, num_heads: int, key_valid, name: str):
    """The kernels' conditions on q/k/v and the mask other than the device
    type; returns (B, N, T, C, head_dim)."""
    _require(all(x.device == qw.device for x in (kw, vw, key_valid)),
             f"{name}: all inputs must be on one device")
    _require(qw.dim() == 4 and qw.shape == kw.shape == vw.shape,
             f"{name}: q/k/v must share a (B, N, T, C) shape, got "
             f"{tuple(qw.shape)}, {tuple(kw.shape)}, {tuple(vw.shape)}")
    b, n, t, c = qw.shape
    _require(qw.dtype in (torch.float32, torch.bfloat16) and kw.dtype == vw.dtype == qw.dtype
             and key_valid.dtype == torch.float32,
             f"{name}: the kernel takes q/k/v all float32 or all bfloat16 and "
             f"float32 key_valid, got {qw.dtype}, {kw.dtype}, {vw.dtype}, {key_valid.dtype}")
    _require(all(x.is_contiguous() for x in (qw, kw, vw, key_valid)),
             f"{name}: inputs must be contiguous")
    _require(tuple(key_valid.shape) == (n, t),
             f"{name}: key_valid must be {(n, t)}, got {tuple(key_valid.shape)}")
    _require(0 < t <= 1024, f"{name}: T={t} must be in 1..1024 (the kernels' domain; at "
                            "head widths other than 4 and 8 they run one thread a query)")
    _require(num_heads > 0 and c % num_heads == 0,
             f"{name}: C={c} not divisible by {num_heads} heads")
    return b, n, t, c, c // num_heads


def _window_attention_cuda(qw, kw, vw, key_valid, num_heads: int, need_stats: bool):
    """The op's CUDA implementation: (out, stats), stats (B, N, heads, T, 2)
    float32 when ``need_stats``, else empty."""
    b, n, t, c, hd = _window_shape(qw, kw, vw, num_heads, key_valid, "window_attention")
    # head_dim 4 and 8 take the tiled kernel (any T <= 1024, at most 80 KB of
    # shared memory); other widths stage k, v and the mask row as float32
    _require(hd in (4, 8) or (hd <= 64 and (2 * t * hd + t) * 4 <= 48 * 1024),
             f"window_attention: head_dim {hd} at T={t} exceeds the kernel's shared memory")
    # the tiled kernel moves rows of 4 values in one access: 16 bytes in float32, 8 in bf16
    _require(all(x.data_ptr() % (4 * x.element_size()) == 0 for x in (qw, kw, vw)),
             f"window_attention: q/k/v must start {4 * qw.element_size()}-byte aligned")
    out = torch.empty_like(vw)
    stats = (torch.empty((b, n, num_heads, t, 2), dtype=torch.float32, device=qw.device)
             if need_stats else _no_stats(qw))
    lib = load()
    bf16 = qw.dtype == torch.bfloat16
    fn = lib.mde_window_attention_bf16 if bf16 else lib.mde_window_attention_f32
    err = fn(qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
             stats.data_ptr() if need_stats else None, b, n, t, c, num_heads, hd**-0.5,
             _stream(qw))
    _check(lib, err, "window_attention")
    if bf16:
        window_attention.bf16_launches += 1
    else:
        window_attention.launches += 1
    if need_stats:
        window_attention.stats_launches += 1
    return out, stats


def _window_attention_cpu(qw, kw, vw, key_valid, num_heads: int, need_stats: bool):
    if need_stats:
        out, stats = window_attention_plain_stats(qw, kw, vw, num_heads, key_valid)
        return out.contiguous(), stats
    return window_attention_plain(qw, kw, vw, num_heads, key_valid).contiguous(), _no_stats(qw)


def _window_attention_fake(qw, kw, vw, key_valid, num_heads: int, need_stats: bool):
    b, n, t, _ = qw.shape
    stats = (qw.new_empty((b, n, num_heads, t, 2), dtype=torch.float32) if need_stats
             else _no_stats(qw))
    return vw.new_empty(vw.shape), stats


window_attention_op = _define(
    "window_attention(Tensor qw, Tensor kw, Tensor vw, Tensor key_valid, int num_heads, "
    "bool need_stats) -> (Tensor, Tensor)",
    _window_attention_cpu, _window_attention_cuda, _window_attention_fake)


def _window_attention_forward(qw, kw, vw, num_heads: int, key_valid, need_stats: bool):
    """(out, stats) through the op: stats (B, N, heads, T, 2) float32 only
    when ``need_stats``, else None."""
    _op_device(qw, "window_attention")
    out, stats = window_attention_op(qw, kw, vw, key_valid, num_heads, need_stats)
    return out, stats if need_stats else None


def _window_attention_backward(qw, kw, vw, num_heads: int, key_valid, out, stats, dout):
    """(dq, dk, dv), each (B, N, T, C) in q's dtype, from the forward's
    stored ``out`` and its ``stats``."""
    if qw.device.type == "cpu":
        return window_attention_backward_plain(qw, kw, vw, num_heads, key_valid, out, stats, dout)
    name = "window_attention backward"
    _require(qw.device.type == "cuda", f"{name}: unsupported device {qw.device}")
    b, n, t, c, hd = _window_shape(qw, kw, vw, num_heads, key_valid, name)
    dout = dout.to(qw.dtype).contiguous()
    _require(all(x.device == qw.device for x in (out, stats, dout)),
             f"{name}: all inputs must be on one device")
    _require(out.shape == dout.shape == qw.shape and out.dtype == qw.dtype
             and out.is_contiguous(),
             f"{name}: out and dout must be contiguous {tuple(qw.shape)} {qw.dtype}")
    _require(tuple(stats.shape) == (b, n, num_heads, t, 2) and stats.dtype == torch.float32
             and stats.is_contiguous(),
             f"{name}: stats must be a contiguous float32 {(b, n, num_heads, t, 2)}")
    # head_dim 4 and 8 take the tiled kernel (any T <= 1024); other widths
    # stage q, k, v and dO as float32 with five float32 a row (m, 1/l,
    # delta, padding, the mask)
    _require(hd in (4, 8) or (hd <= 64 and (4 * t * hd + 5 * t) * 4 <= 227 * 1024),
             f"{name}: head_dim {hd} at T={t} exceeds the kernel's shared memory")
    dq, dk, dv = (torch.empty_like(qw) for _ in range(3))
    lib = load()
    bf16 = qw.dtype == torch.bfloat16
    fn = lib.mde_window_attention_backward_bf16 if bf16 else lib.mde_window_attention_backward_f32
    err = fn(qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
             stats.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, n, t, c, num_heads, hd**-0.5, _stream(qw))
    _check(lib, err, name)
    if bf16:
        window_attention.bf16_backward_launches += 1
    else:
        window_attention.backward_launches += 1
    return dq, dk, dv


class _WindowAttention(torch.autograd.Function):
    """Kernel forward and kernel backward, as ``_FlashAttention``: taken
    only when a backward will follow, so the forward writes the rows' (max,
    1/sum), and the backward forms the probabilities from them and the stored
    output; no probability is saved."""

    @staticmethod
    def forward(ctx, qw, kw, vw, num_heads, key_valid):
        out, stats = _window_attention_forward(qw, kw, vw, num_heads, key_valid, True)
        ctx.save_for_backward(qw, kw, vw, key_valid, out, stats)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, grad):
        qw, kw, vw, key_valid, out, stats = ctx.saved_tensors
        return (*_window_attention_backward(qw, kw, vw, ctx.num_heads, key_valid, out, stats,
                                            grad),
                None, None)


def window_attention(qw, kw, vw, num_heads: int, key_valid):
    """Windowed attention, (B, N, T, C) -> (B, N, T, C); see the plain version.
    The autograd Function only when a backward can follow (grad mode on and an
    input that requires grad), else the op alone: one node of an exported
    graph."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qw, kw, vw)):
        return _WindowAttention.apply(qw, kw, vw, num_heads, key_valid)
    return _window_attention_forward(qw, kw, vw, num_heads, key_valid, False)[0]


window_attention.launches = 0  # float32 kernel
window_attention.bf16_launches = 0
window_attention.backward_launches = 0  # float32 backward kernel
window_attention.bf16_backward_launches = 0
window_attention.stats_launches = 0  # forward launches (either type) that wrote the statistics


# ---------------------------------------------------------------------------
# K2: per-sample sums of the scale-invariant log difference
# ---------------------------------------------------------------------------


def si_loss_sums_plain(pred, target, eps: float = 1e-6):
    """Plain version: per-sample (sum d, sum d^2), d = log(pred+eps) - log(target+eps).

    pred/target: (B, ...) -> two (B,) float32 vectors. Differentiable through
    torch's autograd.
    """
    b = pred.shape[0]
    d = torch.log(pred.reshape(b, -1).float() + eps) - torch.log(target.reshape(b, -1).float() + eps)
    return d.sum(dim=1), (d * d).sum(dim=1)


def si_loss_sums_backward_plain(pred, target, g1, g2, eps: float, need_target: bool):
    """Plain version of the backward, the math of ``_si_sums_bwd``
    (pallas_kernels.py:130-141): d recomputed, dtarget only when needed."""
    shape = (pred.shape[0],) + (1,) * (pred.dim() - 1)
    g1, g2 = g1.reshape(shape), g2.reshape(shape)
    d = torch.log(pred + eps) - torch.log(target + eps)
    common = g1 + 2.0 * d * g2
    dtarget = -common / (target + eps) if need_target else None
    return common / (pred + eps), dtarget


def _si_flat(pred, target, name: str):
    _require(pred.device.type == "cuda", f"{name}: unsupported device {pred.device}")
    _require(target.device == pred.device, f"{name}: pred and target must be on one device")
    _require(pred.shape == target.shape and pred.dim() >= 1,
             f"{name}: pred and target must share a (B, ...) shape, got "
             f"{tuple(pred.shape)}, {tuple(target.shape)}")
    _require(pred.dtype == target.dtype == torch.float32,
             f"{name}: the kernel takes float32, got {pred.dtype}, {target.dtype}")
    b = pred.shape[0]
    _require(0 < b <= 65535 and pred.numel() > 0, f"{name}: batch {b} out of the kernel's grid")
    return pred.reshape(b, -1).contiguous(), target.reshape(b, -1).contiguous()


# The forward's launch (csrc/si_loss.cu): blocks of SI_SUM_THREADS,
# SI_BLOCKS_PER_SM of them an SM (its launch bounds: at most 42 registers a
# thread); a sample cut into tiles of at least SI_TILE_UNITS units, as many
# as fill one such wave across the batch.
SI_SUM_THREADS = 512
SI_BLOCKS_PER_SM = 3
SI_TILE_UNITS = 512


class SIPlan(NamedTuple):
    """How ``si_loss_sums`` launches for a (batch, n) pair: 16-byte loads
    (``vector``) or 4-byte ones, a sample cut into ``units`` (float4s or
    floats) and into ``tiles`` blocks, ``blocks`` in all."""

    vector: bool
    units: int
    tiles: int
    blocks: int

    def shares(self) -> list:
        """The [begin, end) units of each tile of a sample, as the kernel
        computes them: units // tiles, and one more for the first
        units % tiles tiles."""
        chunk, extra = divmod(self.units, self.tiles)
        return [(r * chunk + min(r, extra), (r + 1) * chunk + min(r + 1, extra))
                for r in range(self.tiles)]


@functools.lru_cache(maxsize=64)
def si_loss_sums_plan(batch: int, n: int, aligned: bool, sms: int) -> SIPlan:
    """The launch for ``batch`` samples of ``n`` floats whose rows start on
    16 bytes where ``aligned``, on a card of ``sms`` SMs: the vector path
    needs n % 4 == 0 too (every row then starts on 16 bytes); the tiles of
    all samples fill one wave of SI_BLOCKS_PER_SM blocks an SM, each of at
    least SI_TILE_UNITS units, one a sample at the least."""
    vector = aligned and n % 4 == 0
    units = n // 4 if vector else n
    wave = sms * SI_BLOCKS_PER_SM
    tiles = max(1, min(wave // batch, -(-units // SI_TILE_UNITS)))
    return SIPlan(vector, units, tiles, tiles * batch)


_sm_counts = {}
_si_counters = {}


def _si_counter(device: torch.device, stream: int, batch: int) -> torch.Tensor:
    """The forward's (batch,) uint32 tile counters for this device and stream
    (kept as int32), zero between launches: the kernel's last tile of a sample
    sets its counter back to 0. One buffer a stream, so that launches on two
    streams never share a counter."""
    key = (device.index, stream)
    buf = _si_counters.get(key)
    if buf is None or buf.numel() < batch:
        buf = torch.zeros(max(batch, 64), dtype=torch.int32, device=device)
        _si_counters[key] = buf
    return buf


def _si_loss_sums_forward(pred, target, eps: float):
    if pred.device.type == "cpu":
        return si_loss_sums_plain(pred, target, eps)
    p, t = _si_flat(pred, target, "si_loss_sums")
    b, n = p.shape
    dev = p.device
    sms = _sm_counts.get(dev.index)
    if sms is None:
        sms = _sm_counts[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = si_loss_sums_plan(b, n, p.data_ptr() % 16 == 0 and t.data_ptr() % 16 == 0, sms)
    # the (2, B) sums, then the tiles' partials
    out = torch.empty(2 * b * (1 + plan.tiles), dtype=torch.float32, device=dev)
    stream = _stream(p)
    lib = load()
    err = lib.mde_si_loss_sums_f32(p.data_ptr(), t.data_ptr(), out.data_ptr(),
                                   _si_counter(dev, stream, b).data_ptr(), b, n, plan.tiles,
                                   int(plan.vector), eps, stream)
    _check(lib, err, "si_loss_sums")
    si_loss_sums.launches += 1
    sums = out[:2 * b].view(2, b)
    return sums[0], sums[1]


def _si_loss_sums_backward(pred, target, g1, g2, eps: float, need_target: bool):
    if pred.device.type == "cpu":
        return si_loss_sums_backward_plain(pred, target, g1, g2, eps, need_target)
    p, t = _si_flat(pred, target, "si_loss_sums backward")
    b, n = p.shape
    g1 = g1.to(torch.float32).contiguous()
    g2 = g2.to(torch.float32).contiguous()
    _require(g1.shape == g2.shape == (b,) and g1.device == g2.device == p.device,
             f"si_loss_sums backward: cotangents must be ({b},) on {p.device}")
    dpred = torch.empty_like(p)
    dtarget = torch.empty_like(t) if need_target else None
    lib = load()
    err = lib.mde_si_loss_backward_f32(
        p.data_ptr(), t.data_ptr(), g1.data_ptr(), g2.data_ptr(), dpred.data_ptr(),
        dtarget.data_ptr() if need_target else None, b, n, eps, _stream(p))
    _check(lib, err, "si_loss_sums backward")
    si_loss_sums.backward_launches += 1
    return dpred.view(pred.shape), dtarget.view(target.shape) if need_target else None


class _SILossSums(torch.autograd.Function):
    """Kernel forward and kernel backward; the backward recomputes d and
    saves nothing else, as ``_si_sums_bwd`` does, and computes the target's
    gradient only when it is needed (the depth target never needs it)."""

    @staticmethod
    def forward(ctx, pred, target, eps):
        ctx.save_for_backward(pred, target)
        ctx.eps = eps
        return _si_loss_sums_forward(pred, target, eps)

    @staticmethod
    def backward(ctx, g1, g2):
        pred, target = ctx.saved_tensors
        dpred, dtarget = _si_loss_sums_backward(pred, target, g1, g2, ctx.eps,
                                                ctx.needs_input_grad[1])
        return (dpred if ctx.needs_input_grad[0] else None), dtarget, None


def si_loss_sums(pred, target, eps: float = 1e-6):
    """Per-sample (sum d, sum d^2) of d = log(pred+eps) - log(target+eps),
    (B, ...) -> (B,), (B,); differentiable. See the plain version."""
    return _SILossSums.apply(pred, target, eps)


si_loss_sums.launches = 0
si_loss_sums.backward_launches = 0


# ---------------------------------------------------------------------------
# K3: uint8 NHWC -> bilinear resize -> ImageNet normalise -> float32 NCHW
# ---------------------------------------------------------------------------


def _bilinear_taps(in_size: int, out_size: int, device):
    """Half-pixel bilinear taps of one axis on ``device``, float32, as the JAX
    reference computes them (mde_tpu/ops/resize.py::_interp_taps): the source
    coordinate ``(o + 0.5) * in/out - 0.5`` is rounded after the multiply and
    after the subtract (each its own float32 operation), then clamped at 0.
    ``F.interpolate`` fuses the two into one multiply-add, which moves a
    coordinate near 256 by an ulp and the normalised output by up to 6e-5,
    so neither version uses it. Made where they are used: no copy to the
    card."""
    scale = float(np.float32(in_size) / np.float32(out_size))
    o = torch.arange(out_size, dtype=torch.float32, device=device)
    src = torch.clamp((o + 0.5) * scale - 0.5, min=0.0)
    i0 = torch.clamp(src.long(), max=in_size - 1)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    return i0, i1, src - i0


def resize_half_pixel(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel bilinear resize of an NCHW float tensor with the JAX
    reference's taps (``_bilinear_taps``): gather the two taps of each axis
    and blend them, rows then columns."""
    for axis, out_size in ((2, int(size[0])), (3, int(size[1]))):
        if x.shape[axis] == out_size:
            continue  # the identity in this convention (src == o)
        i0, i1, frac = _bilinear_taps(x.shape[axis], out_size, x.device)
        shape = [1, 1, 1, 1]
        shape[axis] = out_size
        w1 = frac.view(shape)
        a = x.index_select(axis, i0)
        b = x.index_select(axis, i1)
        x = a * (1.0 - w1) + b * w1
    return x


def preprocess_u8_plain(rgb_u8: torch.Tensor, size) -> torch.Tensor:
    """Plain version: ``to_float`` -> half-pixel bilinear -> ``normalize_imagenet``.

    (B, H, W, 3) uint8 -> (B, 3, size[0], size[1]) float32, contiguous NCHW.
    Bilinear weights sum to 1, so ``resize_half_pixel`` equals the kernel's
    order (blend the taps, then scale and normalise) up to float32 rounding.
    """
    x = to_float(rgb_u8).permute(0, 3, 1, 2)
    return normalize_imagenet(resize_half_pixel(x, size)).contiguous()


def _u8_shape(rgb_u8: torch.Tensor, size, name: str):
    """The K3 kernels' conditions on the image batch; returns (B, H, W, OH, OW).
    On the host's hot path, so each message is formatted only if its
    condition fails."""
    shape = rgb_u8.shape
    oh, ow = int(size[0]), int(size[1])
    _require(rgb_u8.device.type == "cuda", lambda: f"{name}: unsupported device {rgb_u8.device}")
    _require(rgb_u8.dtype == torch.uint8, lambda: f"{name}: expected uint8, got {rgb_u8.dtype}")
    _require(len(shape) == 4 and shape[3] == 3,
             lambda: f"{name}: expected (B, H, W, 3), got {tuple(shape)}")
    _require(rgb_u8.is_contiguous(), lambda: f"{name}: input must be contiguous")
    b, h, w, _ = shape
    _require(0 < b <= 65535 and 0 < oh <= 65535 and ow > 0 and oh * ow < 2**31 - 1024,
             lambda: f"{name}: batch {b} or output {oh}x{ow} out of the kernel's grid")
    return b, h, w, oh, ow


def _preprocess_u8_cuda(rgb_u8: torch.Tensor, height: int, width: int) -> torch.Tensor:
    b, h, w, oh, ow = _u8_shape(rgb_u8, (height, width), "preprocess_u8")
    out = torch.empty((b, 3, oh, ow), dtype=torch.float32, device=rgb_u8.device)
    lib = load()
    err = lib.mde_preprocess_u8_f32(rgb_u8.data_ptr(), out.data_ptr(), b, h, w, oh, ow,
                                    *IMAGENET_MEAN, *IMAGENET_STD, _stream(rgb_u8))
    _check(lib, err, "preprocess_u8")
    preprocess_u8.launches += 1
    return out


def _preprocess_u8_fake(rgb_u8: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return rgb_u8.new_empty((rgb_u8.shape[0], 3, height, width), dtype=torch.float32)


preprocess_u8_op = _define(
    "preprocess_u8(Tensor rgb_u8, int height, int width) -> Tensor",
    lambda rgb_u8, height, width: preprocess_u8_plain(rgb_u8, (height, width)),
    _preprocess_u8_cuda, _preprocess_u8_fake)


def preprocess_u8(rgb_u8: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, size[0], size[1]) normalised float32,
    through the op."""
    _op_device(rgb_u8, "preprocess_u8")
    return preprocess_u8_op(rgb_u8, int(size[0]), int(size[1]))


preprocess_u8.launches = 0

JITTER_DRAWS = 8  # a sample's row of draws: fb, fc, fs, fh, then its order of the four


def pack_jitter_draws(fb, fc, fs, fh, perms) -> torch.Tensor:
    """The colour jitter's draws (``ops.image.color_jitter_draws``) as the
    train-form kernel takes them: one (B, 8) float32 row a sample, the
    brightness, contrast, saturation and hue factors, then its permutation
    of 0..3 (brightness, contrast, saturation, hue)."""
    return torch.cat([torch.stack([fb, fc, fs, fh], dim=1).float(),
                      torch.as_tensor(perms).float()], dim=1)


def preprocess_u8_train_plain(rgb_u8: torch.Tensor, draws: torch.Tensor, size) -> torch.Tensor:
    """Plain version: ``to_float`` -> half-pixel bilinear -> colour jitter
    with the given draws (``color_jitter_apply``) -> ``normalize_imagenet``.

    (B, H, W, 3) uint8 and (B, 8) draws (``pack_jitter_draws``) ->
    (B, 3, size[0], size[1]) float32, contiguous NCHW.
    """
    x = resize_half_pixel(to_float(rgb_u8).permute(0, 3, 1, 2), size)
    fb, fc, fs, fh = draws[:, :4].unbind(1)
    x = color_jitter_apply(x, fb, fc, fs, fh, draws[:, 4:].long())
    return normalize_imagenet(x).contiguous()


class TrainPlan(ctypes.Structure):
    """How the train-form kernel runs one shape on one card, as
    ``mde_preprocess_u8_train_plan`` decides it from the shape alone: one
    cooperative launch a group of samples, or two where no cooperative grid
    fits or the source rows are too wide to stage; its grid and shared
    memory. Every launch of the shape is handed this plan."""
    _fields_ = [(key, ctypes.c_int) for key in (
        "cooperative", "pixels_per_thread", "blocks_per_sample", "blocks_per_sm",
        "samples_per_launch", "stage_bytes", "shared_bytes")]


_ORDER_VALUES = [0.0, 1.0, 2.0, 3.0]


def train_draw_rows(draws: torch.Tensor, name: str = "preprocess_u8_train") -> torch.Tensor:
    """The (B, 8) float32 draws as the train-form launcher reads them from
    host memory, a contiguous row a sample (four factors, then the order),
    which it copies into the kernel's parameters. Draws on another device
    raise: reading them back would be a hidden synchronisation. Each order
    must be a permutation of 0..3."""
    if draws.device.type != "cpu":
        raise ValueError(f"{name}: draws must be on the CPU, got {draws.device}: the kernel "
                         "takes them by value in its launch parameters, and reading them back "
                         "from the card would synchronise the host with it")
    if draws.dim() != 2 or draws.shape[1] != JITTER_DRAWS or draws.dtype != torch.float32:
        raise ValueError(f"{name}: draws must be (B, {JITTER_DRAWS}) float32, got "
                         f"{tuple(draws.shape)} {draws.dtype}")
    rows = draws.detach().contiguous()
    for i, order in enumerate(rows[:, 4:].tolist()):
        if sorted(order) != _ORDER_VALUES:
            raise ValueError(f"{name}: each order must be a permutation of 0..3; sample [{i}] "
                             f"has {order}")
    return rows


def sample_groups(batch: int, per_launch: int):
    """[(first sample, count)] of the launches that cover a batch in order."""
    return [(s, min(per_launch, batch - s)) for s in range(0, batch, per_launch)]


_train_plans = {}


def train_plan(batch: int, h: int, w: int, oh: int, ow: int) -> TrainPlan:
    """The ``TrainPlan`` of this shape on the current card, asked of the
    launcher once a shape and kept here: its only copy."""
    key = (torch.cuda.current_device(), batch, h, w, oh, ow)
    plan = _train_plans.get(key)
    if plan is None:
        lib = load()
        plan = TrainPlan()
        _check(lib, lib.mde_preprocess_u8_train_plan(batch, h, w, oh, ow, ctypes.addressof(plan)),
               "preprocess_u8_train plan")
        _train_plans[key] = plan
    return plan


def preprocess_u8_train(rgb_u8: torch.Tensor, draws: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W, 3) uint8 and (B, 8) jitter draws -> (B, 3, size[0], size[1])
    jittered, normalised float32. On a CUDA tensor the draws stay on the CPU
    (``train_draw_rows``) and go to the kernel by value, a group of samples
    a launch as the shape's ``train_plan`` says."""
    if rgb_u8.device.type == "cpu":
        return preprocess_u8_train_plain(rgb_u8, draws, size)
    name = "preprocess_u8_train"
    b, h, w, oh, ow = _u8_shape(rgb_u8, size, name)
    if draws.shape != (b, JITTER_DRAWS):
        raise ValueError(f"{name}: draws must be ({b}, {JITTER_DRAWS}), got {tuple(draws.shape)}")
    rows = train_draw_rows(draws, name)
    plan = train_plan(b, h, w, oh, ow)
    # the partial grey sums, one a block
    partial = torch.empty(b * plan.blocks_per_sample, dtype=torch.float32, device=rgb_u8.device)
    out = torch.empty((b, 3, oh, ow), dtype=torch.float32, device=rgb_u8.device)
    lib = load()
    stream = _stream(rgb_u8)
    for first, count in sample_groups(b, plan.samples_per_launch):
        err = lib.mde_preprocess_u8_train_f32(
            rgb_u8.data_ptr(), rows[first].data_ptr(), partial.data_ptr(), partial.numel(),
            out.data_ptr(), ctypes.addressof(plan), b, first, count, h, w, oh, ow,
            *IMAGENET_MEAN, *IMAGENET_STD, stream)
        _check(lib, err, name)
    preprocess_u8_train.launches += 1
    return out


preprocess_u8_train.launches = 0


# ---------------------------------------------------------------------------
# K4: full (non-causal) attention over ViT tokens
# ---------------------------------------------------------------------------

FLASH_HEAD_DIM = 64  # the kernel's head dim: DINOv2's 384/6, 768/12 and 1024/16


def flash_attention_plain(q, k, v):
    """Plain version: softmax(q k^T / sqrt(D)) v per (batch, head), the math
    of mde_tpu/ops/flash_attention.py::attention_reference.

    q/k/v: (B, N, H, D) float32 or bfloat16 (the JAX layout) -> (B, N, H, D).
    Logits, softmax and the weighted sum in float32, with autocast off so they
    stay so inside a bf16 region, as in the kernel; the output is rounded once
    to ``v``'s dtype. It is the reference of both kernel forms. In bf16 the JAX
    reference (and the JAX ViT, mde_tpu/nn/vit.py:66) rounds the normalised
    probabilities to bf16 before the second product; this version does not.
    """
    d = q.shape[-1]
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = torch.softmax(logits * d**-0.5, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v.float())
    return out.to(v.dtype)


def flash_attention_plain_lse(q, k, v):
    """``flash_attention_plain`` (the same operations, so the same output)
    and the rows' log-sum-exp of the scaled logits, (B, H, N) float32: what
    the kernel's forward writes for its backward."""
    d = q.shape[-1]
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v.float())
    return out.to(v.dtype), torch.logsumexp(logits, dim=-1)


def flash_attention_backward_plain(q, k, v, out, lse, dout):
    """Plain version of the backward kernel, its math written out: P from the
    forward's lse, delta = rowsum(dO o), dS = P (dO v^T - delta), then
    dq = dS k / sqrt(D), dk = dS^T q / sqrt(D), dv = P^T dO, all in float32
    and rounded once to the inputs' dtype. ``out`` is the forward's output as
    stored (bf16 in the bf16 form), as the kernel reads it."""
    scale = q.shape[-1] ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
        p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
        delta = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
        dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_shape(q, k, v):
    """The kernel's conditions on q/k/v other than the device type; returns
    (B, N, H, D)."""
    _require(k.device == q.device and v.device == q.device,
             "flash_attention: all inputs must be on one device")
    _require(q.dim() == 4 and q.shape == k.shape == v.shape,
             f"flash_attention: q/k/v must share a (B, N, H, D) shape, got "
             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, n, h, d = q.shape
    _require(d == FLASH_HEAD_DIM,
             f"flash_attention: head dim {d}; the kernel takes {FLASH_HEAD_DIM}")
    _require(q.dtype in (torch.float32, torch.bfloat16) and k.dtype == v.dtype == q.dtype,
             "flash_attention: the kernel takes q/k/v all float32 or all bfloat16, got "
             f"{q.dtype}, {k.dtype}, {v.dtype}")
    # (H, D) contiguous, batch and token strides free (the views of a fused
    # qkv projection), every row start 16-byte aligned for vector loads.
    stride_b, stride_n, stride_h, stride_d = q.stride()
    _require(q.stride() == k.stride() == v.stride() and stride_d == 1 and stride_h == d
             and stride_b % 8 == 0 and stride_n % 8 == 0,
             "flash_attention: q/k/v must share strides with (H, D) contiguous and batch "
             f"and token strides a multiple of 8, got {q.stride()}, {k.stride()}, {v.stride()}")
    _require(all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
             "flash_attention: q/k/v must start 16-byte aligned")
    _require(0 < n and 0 < b * h < 2**31 and -(-n // 64) <= 65535,
             f"flash_attention: (B, N, H) = {(b, n, h)} out of the kernel's grid")
    return b, n, h, d


def _flash_attention_cuda(q, k, v, need_lse: bool):
    """The op's CUDA implementation: (out, lse), lse (B, H, N) float32 when
    ``need_lse``, else empty."""
    b, n, h, d = _flash_shape(q, k, v)
    dtype = q.dtype
    stride_b, stride_n = q.stride()[:2]
    out = torch.empty((b, n, h, d), dtype=dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device) if need_lse
           else _no_stats(q))
    lib = load()
    bf16 = dtype == torch.bfloat16
    fn = lib.mde_flash_attention_bf16 if bf16 else lib.mde_flash_attention_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if need_lse else None, b, n, h, d, stride_b, stride_n, d**-0.5,
             _stream(q))
    _check(lib, err, "flash_attention")
    if bf16:
        flash_attention.bf16_launches += 1
    else:
        flash_attention.launches += 1
    return out, lse


def _flash_attention_cpu(q, k, v, need_lse: bool):
    if need_lse:
        out, lse = flash_attention_plain_lse(q, k, v)
        return out.contiguous(), lse
    return flash_attention_plain(q, k, v).contiguous(), _no_stats(q)


def _flash_attention_fake(q, k, v, need_lse: bool):
    b, n, h, d = q.shape
    lse = q.new_empty((b, h, n), dtype=torch.float32) if need_lse else _no_stats(q)
    return q.new_empty((b, n, h, d)), lse


flash_attention_op = _define(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool need_lse) -> (Tensor, Tensor)",
    _flash_attention_cpu, _flash_attention_cuda, _flash_attention_fake)


def _flash_attention_forward(q, k, v, need_lse: bool):
    """(out, lse) through the op: lse (B, H, N) float32 only when
    ``need_lse``, else None."""
    _op_device(q, "flash_attention")
    out, lse = flash_attention_op(q, k, v, need_lse)
    return out, lse if need_lse else None


def _flash_attention_backward(q, k, v, out, lse, dout):
    """(dq, dk, dv), each (B, N, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout)
    _require(q.device.type == "cuda", f"flash_attention backward: unsupported device {q.device}")
    b, n, h, d = _flash_shape(q, k, v)
    dtype = q.dtype
    dout = dout.to(dtype).contiguous()
    _require(all(x.device == q.device for x in (out, lse, dout)),
             "flash_attention backward: all inputs must be on one device")
    _require(tuple(out.shape) == tuple(dout.shape) == (b, n, h, d) and out.dtype == dtype
             and out.is_contiguous(),
             f"flash_attention backward: out and dout must be contiguous {(b, n, h, d)} {dtype}")
    _require(tuple(lse.shape) == (b, h, n) and lse.dtype == torch.float32 and lse.is_contiguous(),
             f"flash_attention backward: lse must be a contiguous float32 {(b, h, n)}")
    _require(out.data_ptr() % 16 == 0 and dout.data_ptr() % 16 == 0,
             "flash_attention backward: out and dout must start 16-byte aligned")
    stride_b, stride_n = q.stride()[:2]
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=dtype, device=q.device) for _ in range(3))
    lib = load()
    bf16 = dtype == torch.bfloat16
    fn = lib.mde_flash_attention_backward_bf16 if bf16 else lib.mde_flash_attention_backward_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, n, h, d, stride_b, stride_n, d**-0.5, _stream(q))
    _check(lib, err, "flash_attention backward")
    if bf16:
        flash_attention.backward_bf16_launches += 1
    else:
        flash_attention.backward_launches += 1
    return dq, dk, dv


def flash_attention_backward_plan(dtype, n: int) -> dict:
    """What the backward kernels of ``dtype`` launch for ``n`` tokens: threads
    a block, and for the dK/dV and the dQ kernel rows a block, blocks a
    (batch, head), dynamic shared bytes and resident blocks an SM (asked of
    the runtime on the current card)."""
    lib = load()
    out = (ctypes.c_int * 9)()
    err = lib.mde_flash_attention_backward_plan(int(dtype == torch.bfloat16), n, out)
    _check(lib, err, "flash_attention backward plan")
    keys = ("threads", "dkdv_rows", "dq_rows", "dkdv_blocks_per_head", "dq_blocks_per_head",
            "dkdv_smem", "dq_smem", "dkdv_blocks_per_sm", "dq_blocks_per_sm")
    return dict(zip(keys, out))


class _FlashAttention(torch.autograd.Function):
    """Kernel forward and kernel backward, taken only when a backward will
    follow (grad mode on and an input that requires grad, which ``forward``
    cannot see: it runs under no_grad, and ``ctx.needs_input_grad`` is set
    under no_grad too), so the forward writes the rows' log-sum-exp; the
    backward recomputes the probabilities from it and saves none."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _flash_attention_forward(q, k, v, True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        return _flash_attention_backward(q, k, v, out, lse, grad)


def flash_attention(q, k, v):
    """Full attention, (B, N, H, D) -> (B, N, H, D); see the plain version.
    The autograd Function only when a backward can follow, else the op alone:
    one node of an exported graph."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v)
    return _flash_attention_forward(q, k, v, False)[0]


flash_attention.launches = 0  # float32 kernel
flash_attention.bf16_launches = 0
flash_attention.backward_launches = 0  # float32 backward kernel
flash_attention.backward_bf16_launches = 0
