"""Hand-written CUDA kernels of the serving and training paths, each beside
its plain version.

Port of mde_tpu/ops/pallas_kernels.py. The kernels live in
``mde_tpu_torch/csrc`` and are built with ``nvcc`` into one shared library with
a plain C interface, loaded with ``ctypes``:

- ``window_attention`` (csrc/window_attention.cu) replaces
  ``window_attention_fused`` (pallas_kernels.py:163-225), in float32 and in
  bfloat16 (the mixed-precision train step);
- ``si_loss_sums`` (csrc/si_loss.cu) replaces ``si_loss_sums``
  (pallas_kernels.py:56-144), forward and backward;
- ``preprocess_u8`` (csrc/preprocess.cu) replaces ``normalize_u8_fused``
  (pallas_kernels.py:233-260), fused with the half-pixel bilinear resize that
  precedes it in ``preprocess_eval``.

Each wrapper takes its plain PyTorch version for a tensor on the CPU, and for a
CUDA tensor checks device, dtype, shape and contiguity, then launches the
kernel or raises. Each counts its launches in a ``launches`` attribute
(``bf16_launches`` and ``backward_launches`` for the other forms).

The library is built at first use into ``mde_tpu_torch/_build`` (listed in
.gitignore), named by a hash of the sources and flags, so an edited source is
rebuilt. Nothing is imported or compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .image import IMAGENET_MEAN, IMAGENET_STD, normalize_imagenet, to_float

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")  # per source, with -c
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib = None
_lib_lock = threading.Lock()
build_seconds = None  # wall time of the nvcc run in this process, if one ran


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
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
            lib.mde_window_attention_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
            lib.mde_window_attention_f32.restype = i
            lib.mde_window_attention_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
            lib.mde_window_attention_bf16.restype = i
            ll = ctypes.c_longlong
            lib.mde_si_loss_sums_f32.argtypes = [p, p, p, p, p, i, ll, f, p]
            lib.mde_si_loss_sums_f32.restype = i
            lib.mde_si_loss_backward_f32.argtypes = [p, p, p, p, p, p, i, ll, f, p]
            lib.mde_si_loss_backward_f32.restype = i
            lib.mde_preprocess_u8_f32.argtypes = [p, p, i, i, i, i, i, f, f, f, f, f, f, p]
            lib.mde_preprocess_u8_f32.restype = i
            lib.mde_error_string.argtypes = [i]
            lib.mde_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.mde_error_string(err).decode()})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    b, n, t, c = qw.shape
    hd = c // num_heads

    def split(x):
        return x.reshape(b, n, t, num_heads, hd).float()

    with torch.autocast(qw.device.type, enabled=False):
        logits = torch.einsum("bnqhd,bnkhd->bnhqk", split(qw), split(kw)) * hd**-0.5
        key_mask = (key_valid > 0)[None, :, None, None, :]
        logits = torch.where(key_mask, logits, torch.finfo(torch.float32).min)
        attn = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        attn = attn / attn.sum(dim=-1, keepdim=True)
        out = torch.einsum("bnhqk,bnkhd->bnqhd", attn, split(vw))
    return out.reshape(b, n, t, c).to(vw.dtype)


def _window_attention_forward(qw, kw, vw, num_heads: int, key_valid):
    if qw.device.type == "cpu":
        return window_attention_plain(qw, kw, vw, num_heads, key_valid)
    _require(qw.device.type == "cuda", f"window_attention: unsupported device {qw.device}")
    _require(all(x.device == qw.device for x in (kw, vw, key_valid)),
             "window_attention: all inputs must be on one device")
    _require(qw.dim() == 4 and qw.shape == kw.shape == vw.shape,
             f"window_attention: q/k/v must share a (B, N, T, C) shape, got "
             f"{tuple(qw.shape)}, {tuple(kw.shape)}, {tuple(vw.shape)}")
    b, n, t, c = qw.shape
    dtype = qw.dtype
    _require(dtype in (torch.float32, torch.bfloat16) and kw.dtype == vw.dtype == dtype
             and key_valid.dtype == torch.float32,
             "window_attention: the kernel takes q/k/v all float32 or all bfloat16 and "
             f"float32 key_valid, got {qw.dtype}, {kw.dtype}, {vw.dtype}, {key_valid.dtype}")
    _require(all(x.is_contiguous() for x in (qw, kw, vw, key_valid)),
             "window_attention: inputs must be contiguous")
    _require(tuple(key_valid.shape) == (n, t),
             f"window_attention: key_valid must be {(n, t)}, got {tuple(key_valid.shape)}")
    _require(0 < t <= 1024, f"window_attention: T={t} must be in 1..1024 (one thread a query)")
    _require(num_heads > 0 and c % num_heads == 0,
             f"window_attention: C={c} not divisible by {num_heads} heads")
    hd = c // num_heads
    _require(hd <= 64 and (2 * t * hd + t) * 4 <= 48 * 1024,
             f"window_attention: head_dim {hd} at T={t} exceeds the kernel's shared memory")
    out = torch.empty_like(vw)
    lib = load()
    bf16 = dtype == torch.bfloat16
    fn = lib.mde_window_attention_bf16 if bf16 else lib.mde_window_attention_f32
    err = fn(qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
             b, n, t, c, num_heads, hd**-0.5, _stream(qw))
    _check(lib, err, "window_attention")
    if bf16:
        window_attention.bf16_launches += 1
    else:
        window_attention.launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    """Kernel forward; the backward recomputes through the plain version and
    saves no probabilities, as ``_pallas_wa_bwd`` does
    (mde_tpu/ops/window_attention.py:103-110)."""

    @staticmethod
    def forward(ctx, qw, kw, vw, num_heads, key_valid):
        ctx.save_for_backward(qw, kw, vw, key_valid)
        ctx.num_heads = num_heads
        return _window_attention_forward(qw, kw, vw, num_heads, key_valid)

    @staticmethod
    def backward(ctx, grad):
        qw, kw, vw, key_valid = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in (qw, kw, vw))
            out = window_attention_plain(q, k, v, ctx.num_heads, key_valid)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad.to(vw.dtype))
        return dq, dk, dv, None, None


def window_attention(qw, kw, vw, num_heads: int, key_valid):
    """Windowed attention, (B, N, T, C) -> (B, N, T, C); see the plain version."""
    return _WindowAttention.apply(qw, kw, vw, num_heads, key_valid)


window_attention.launches = 0  # float32 kernel
window_attention.bf16_launches = 0


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


def _si_loss_sums_forward(pred, target, eps: float):
    if pred.device.type == "cpu":
        return si_loss_sums_plain(pred, target, eps)
    p, t = _si_flat(pred, target, "si_loss_sums")
    b, n = p.shape
    chunks = -(-n // 2048)
    partial = torch.empty((2, b, chunks), dtype=torch.float32, device=p.device)
    s1 = torch.empty(b, dtype=torch.float32, device=p.device)
    s2 = torch.empty_like(s1)
    lib = load()
    err = lib.mde_si_loss_sums_f32(p.data_ptr(), t.data_ptr(), partial.data_ptr(),
                                   s1.data_ptr(), s2.data_ptr(), b, n, eps, _stream(p))
    _check(lib, err, "si_loss_sums")
    si_loss_sums.launches += 1
    return s1, s2


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


def _bilinear_taps(in_size: int, out_size: int):
    """Half-pixel bilinear taps of one axis, float32, as the JAX reference
    computes them (mde_tpu/ops/resize.py::_interp_taps): the source coordinate
    ``(o + 0.5) * in/out - 0.5`` is rounded after the multiply and after the
    subtract, then clamped at 0. ``F.interpolate`` fuses the two into one
    multiply-add, which moves a coordinate near 256 by an ulp and the
    normalised output by up to 6e-5, so neither version uses it."""
    o = np.arange(out_size, dtype=np.float32)
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.maximum(np.float32(0.0), (o + np.float32(0.5)) * scale - np.float32(0.5))
    i0 = np.minimum(src.astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (src - i0).astype(np.float32)
    return i0, i1, frac


def resize_half_pixel(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel bilinear resize of an NCHW float tensor with the JAX
    reference's taps (``_bilinear_taps``): gather the two taps of each axis
    and blend them, rows then columns."""
    dev = x.device
    for axis, out_size in ((2, int(size[0])), (3, int(size[1]))):
        if x.shape[axis] == out_size:
            continue  # the identity in this convention (src == o)
        i0, i1, frac = _bilinear_taps(x.shape[axis], out_size)
        shape = [1, 1, 1, 1]
        shape[axis] = out_size
        w1 = torch.from_numpy(frac).to(dev).view(shape)
        a = x.index_select(axis, torch.from_numpy(i0).to(dev))
        b = x.index_select(axis, torch.from_numpy(i1).to(dev))
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


def preprocess_u8(rgb_u8: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, size[0], size[1]) normalised float32."""
    if rgb_u8.device.type == "cpu":
        return preprocess_u8_plain(rgb_u8, size)
    _require(rgb_u8.device.type == "cuda", f"preprocess_u8: unsupported device {rgb_u8.device}")
    _require(rgb_u8.dtype == torch.uint8, f"preprocess_u8: expected uint8, got {rgb_u8.dtype}")
    _require(rgb_u8.dim() == 4 and rgb_u8.shape[-1] == 3,
             f"preprocess_u8: expected (B, H, W, 3), got {tuple(rgb_u8.shape)}")
    _require(rgb_u8.is_contiguous(), "preprocess_u8: input must be contiguous")
    b, h, w, _ = rgb_u8.shape
    oh, ow = int(size[0]), int(size[1])
    _require(0 < b <= 65535 and 0 < oh <= 65535 and ow > 0,
             f"preprocess_u8: batch {b} or output {oh}x{ow} out of the kernel's grid")
    out = torch.empty((b, 3, oh, ow), dtype=torch.float32, device=rgb_u8.device)
    lib = load()
    err = lib.mde_preprocess_u8_f32(rgb_u8.data_ptr(), out.data_ptr(), b, h, w, oh, ow,
                                    *IMAGENET_MEAN, *IMAGENET_STD, _stream(rgb_u8))
    _check(lib, err, "preprocess_u8")
    preprocess_u8.launches += 1
    return out


preprocess_u8.launches = 0
