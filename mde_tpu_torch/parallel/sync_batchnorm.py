"""BatchNorm with statistics over the global batch of every process.

The JAX package gets global BatchNorm statistics from GSPMD without asking
(mde_tpu/parallel/mesh.py:10-11). ``torch.nn.SyncBatchNorm`` cannot stand in:
it refuses CPU tensors, where the tests run, and its all-gathers are not
what gloo offers for CUDA tensors. This one is a ``torch.autograd.Function``
in plain PyTorch on ``all_reduce`` alone:

- forward: two all-reduces over the data group, summed in float64 (the input computes in
  float32, or float64 if it is float64): the local sum of x with the element
  count, which gives the global mean, then the local sum of (x - mean)^2,
  which gives the biased variance over the global n. One pass of the sums
  of x and x^2 would be one all-reduce fewer, but their difference loses
  the variance of a channel whose mean is far from 0 (0.1% at a mean of
  100 standard deviations, in float32). The running variance takes torch's
  unbiased correction n / (n - 1) with the global n, as ``nn.BatchNorm2d``
  does in one process. Under tensor parallelism the model ranks of a data
  index hold the same rows: a reduction over the world would count each row
  T times, which leaves the mean and the variance as they are but makes the
  running variance's n / (n - 1) that of T n rows;
- backward: the sums of dy and dy * x_hat go out in one all-reduce; the
  weight and bias gradients are this process's own sums (the
  ``DistributedDataParallel`` reduction adds the processes' shares).

``SyncBatchNorm`` subclasses ``nn.BatchNorm2d`` (``SyncBatchNorm1d``,
``nn.BatchNorm1d``), so state_dict keys are unchanged;
``convert_sync_batchnorm`` swaps them in (``parallel.mesh.
data_parallel``, which the training tool calls at W > 1 only), and
``local_statistics`` turns the reduction off for a batch that runs whole on
every process. In eval mode, and in a process that joined no process group,
it is ``nn.BatchNorm2d``; in a group of one it runs the function above,
whose all-reduces then change nothing (the smoke run's world of one).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn as nn

from .distributed import data_group


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float64 stays float64; every other type computes in float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


class _SyncBatchNormFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.to(_compute_dtype(x))
        c = xf.shape[1]
        dims = [0] + list(range(2, xf.dim()))
        shape = [1, c] + [1] * (xf.dim() - 2)
        # two passes, each summed in float64: the mean, then the squares
        # about it (the sum of x^2 less n mean^2 loses the variance of a
        # channel whose mean is far from 0)
        local = torch.cat([xf.sum(dims, dtype=torch.float64),
                           torch.full((1,), xf.numel() // c, dtype=torch.float64,
                                      device=x.device)])
        dist.all_reduce(local, group=group)
        n = local[c]
        centered = xf - (local[:c] / n).to(xf.dtype).view(shape)
        sq = (centered * centered).sum(dims, dtype=torch.float64)
        dist.all_reduce(sq, group=group)
        mean, var = (local[:c] / n).to(xf.dtype), (sq / n).to(xf.dtype)
        invstd = torch.rsqrt(var + eps)
        x_hat = centered * invstd.view(shape)
        y = x_hat * weight.to(xf.dtype).view(shape) + bias.to(xf.dtype).view(shape)
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.input_dtype, ctx.group = x.dtype, group
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dn):
        x_hat, weight, invstd, n = ctx.saved_tensors
        c = x_hat.shape[1]
        dims = [0] + list(range(2, x_hat.dim()))
        shape = [1, c] + [1] * (x_hat.dim() - 2)
        dyf = dy.to(x_hat.dtype)
        packed = torch.cat([dyf.sum(dims, dtype=torch.float64),
                            (dyf * x_hat).sum(dims, dtype=torch.float64)])
        # this process's shares, copied before the all-reduce sums in place
        grad_bias = packed[:c].to(weight.dtype, copy=True)
        grad_weight = packed[c:].to(weight.dtype, copy=True)
        dist.all_reduce(packed, group=ctx.group)
        mean_dy = (packed[:c] / n).to(x_hat.dtype).view(shape)
        mean_dy_xhat = (packed[c:] / n).to(x_hat.dtype).view(shape)
        dx = (dyf - mean_dy - x_hat * mean_dy_xhat) * (weight.to(x_hat.dtype) * invstd).view(shape)
        return dx.to(ctx.input_dtype), grad_weight, grad_bias, None, None


class _SyncForward:
    """The forward of both classes below: training-mode statistics over every
    process (module docstring). ``sync`` False (``local_statistics``) falls
    back to this process's batch."""

    sync = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.sync and dist.is_initialized()):
            return super().forward(x)
        self._check_input_dim(x)
        y, mean, var, n = _SyncBatchNormFunction.apply(x, self.weight, self.bias, self.eps,
                                                       data_group())
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                factor = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                          else self.momentum)
                self.running_mean.mul_(1 - factor).add_(mean.to(self.running_mean.dtype),
                                                        alpha=factor)
                unbiased = var * n / torch.clamp(n - 1, min=1.0)
                self.running_var.mul_(1 - factor).add_(unbiased.to(self.running_var.dtype),
                                                       alpha=factor)
        return y


class SyncBatchNorm(_SyncForward, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with cross-process statistics."""


class SyncBatchNorm1d(_SyncForward, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with cross-process statistics: LeViT's BN over
    (B*N, C) tokens (nn/levit.py::LinearBN)."""


_SYNC = {nn.BatchNorm2d: SyncBatchNorm, nn.BatchNorm1d: SyncBatchNorm1d}


def convert_sync_batchnorm(model: nn.Module) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` and ``nn.BatchNorm1d`` of ``model`` a
    ``SyncBatchNorm`` / ``SyncBatchNorm1d`` in place, keeping its parameters
    and buffers (the same tensors, so an optimizer built before still holds
    them). Returns ``model``."""
    for m in model.modules():
        if type(m) in _SYNC:
            if not m.affine:
                raise ValueError("SyncBatchNorm needs an affine BatchNorm")
            m.__class__ = _SYNC[type(m)]
    return model


@contextlib.contextmanager
def local_statistics(model: nn.Module):
    """Within the block, the ``SyncBatchNorm`` layers of ``model`` use this
    process's batch alone: a batch that runs replicated is already whole."""
    layers = [m for m in model.modules() if isinstance(m, _SyncForward)]
    for m in layers:
        m.sync = False
    try:
        yield
    finally:
        for m in layers:
            m.sync = True
