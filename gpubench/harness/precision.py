"""Where the reference computes: the configuration's precision, or the
control's, the nearest precision below it.

- ``float32``: float32 with TF32 off in matrix products and cuDNN's
  convolutions (torch's default would run float32 convolutions in TF32).
- ``tf32``: the control of a float32 configuration: TF32 on in both.
- ``bf16``: bfloat16 autocast, as a bfloat16 configuration's program runs
  (a witness of what its rounding alone does, not a control).
- ``fp8``: the control of a bfloat16 configuration: where bfloat16
  autocast computes in bfloat16, float8 instead, as fp8 training runs
  (Micikevicius et al., "FP8 Formats for Deep Learning", 2022): the inputs
  of every convolution, linear and matrix product and its output rounded to
  float8 e4m3, and the gradient that reaches that output rounded to float8
  e5m2 before its backward, each with a per-tensor scale (its largest
  magnitude to the format's largest); the products run in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def _tf32(enabled: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def float32():
    return _tf32(False)


def tf32():
    return _tf32(True)


@contextlib.contextmanager
def bf16():
    with _tf32(False), torch.autocast("cuda", dtype=torch.bfloat16):
        yield


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = largest / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 in the forward; its gradient passes unchanged."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    rounded = _round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
    return x + (rounded - x.detach())


def _e5m2_grad(out):
    """The gradient that reaches ``out`` rounded to e5m2."""
    if isinstance(out, torch.Tensor) and out.requires_grad:
        out.register_hook(lambda g: _round(g, torch.float8_e5m2, E5M2_MAX))
    return out


_QUANTISED = {F.conv2d, F.conv_transpose2d, F.linear, torch.einsum, torch.matmul, torch.bmm}


class _Fp8(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUANTISED:
            if func is torch.einsum:
                args = (args[0], *(_e4m3(a) for a in args[1:]))
            else:
                args = tuple(_e4m3(a) for a in args[:2]) + tuple(args[2:])
            return _e5m2_grad(_e4m3(func(*args, **kwargs)))
        return func(*args, **kwargs)


@contextlib.contextmanager
def fp8():
    with _tf32(False), _Fp8():
        yield


PRECISIONS = {"float32": float32, "tf32": tf32, "bf16": bf16, "fp8": fp8}
# the control's precision: the nearest below the one a configuration states
CONTROL_OF = {"float32": "tf32", "bfloat16": "fp8"}
