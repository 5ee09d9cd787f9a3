"""Depth losses (port of mde_tpu/losses/losses.py).

Each function cites the reference formula it matches, as the JAX module does:

- ``scale_invariant_loss``            src/util.py:129-156, through the
                                      ``si_loss_sums`` kernel (K2)
- ``silog_loss``                      src/util.py:90-127
- ``gradient_loss``                   src/util.py:24-44
- ``edge_aware_loss``                 src/util.py:46-88
- ``per_pixel_scale_invariant_loss``  src/util.py:159-181
- ``combined_loss``                   src/main.py:51-89

Depth maps are channel-less (B, H, W), as in the JAX package; RGB is the
model's NCHW (B, 3, H, W) where the JAX package takes NHWC. Masked means are
where-masked sums, as in the JAX package (the reference indexes ``pred[mask]``).

``sharded=True`` gives the loss of the global batch when each of the W
data-parallel ranks (the data group; the model ranks of a data index hold
the same rows) holds an equal share of its rows: each term is a function of
sums over the batch (the SiLog term's masked means, the edge term's RGB
gradient span among them), and those sums go through ``global_sum`` (the
span through ``global_max``), as GSPMD reduces them across devices in the
JAX package. Unsharded, the same formulas run on this process's sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels import si_loss_sums
from ..parallel.distributed import data_count, data_group, global_max, global_sum


def _over_batch(sums: torch.Tensor, sharded: bool) -> tuple[torch.Tensor, int]:
    """(``sums`` over every process that holds a share of the batch, the
    number of those processes): this process's own sums and 1 unless
    ``sharded``. The shares are equal, so a count of this process's rows
    times the number of processes is the global batch's."""
    if sharded:
        return global_sum(sums, data_group()), data_count()
    return sums, 1


def scale_invariant_loss(pred: torch.Tensor, target: torch.Tensor, epsilon: float = 1e-6,
                         sqroot: bool = False, sums=si_loss_sums,
                         sharded: bool = False) -> torch.Tensor:
    """Per-sample scale-invariant log MSE, batch-averaged.

    loss_b = mean(d^2) - mean(d)^2 with d = log(pred+eps) - log(target+eps)
    over every pixel of the sample (unmasked, as the reference), optionally
    square-rooted per sample (the Kaggle SI-RMSE), then the batch mean. The
    per-sample sums come from one pass of ``sums``: the ``si_loss_sums``
    kernel, or ``kernels.si_loss_sums_plain`` to run the plain version on any
    device.
    """
    b = pred.shape[0]
    n = float(pred.numel() // b)  # float: n^2 overflows int32 at 448x576 pixels
    s1, s2 = sums(pred, target, epsilon)
    loss = s2 / n - torch.square(s1) / (n * n)
    if sqroot:
        loss = torch.sqrt(loss)
    total, w = _over_batch(loss.sum(), sharded)
    return total / (b * w)


def silog_loss(pred, target, mask=None, variance_focus: float = 0.85, epsilon: float = 1e-6,
               sharded: bool = False):
    """Masked SiLog loss with a whole-batch masked mean (src/util.py:107-127)."""
    if mask is None:
        mask = target > 0
    mask = mask.to(pred.dtype)
    log_diff = (torch.log(pred + epsilon) - torch.log(target + epsilon)) * mask
    (sum_sq, sum_, count), _ = _over_batch(
        torch.stack([(log_diff * log_diff).sum(), log_diff.sum(), mask.sum()]), sharded)
    count = torch.clamp(count, min=1.0)
    mean_sq = sum_sq / count
    mean = sum_ / count
    return mean_sq - variance_focus * mean * mean


def gradient_loss(pred, target, sharded: bool = False):
    """L1 difference of absolute spatial gradients; each direction is a mean
    over its own gradient tensor, then the two are summed."""
    pred_dx = torch.abs(pred[:, :, :-1] - pred[:, :, 1:])
    pred_dy = torch.abs(pred[:, :-1, :] - pred[:, 1:, :])
    target_dx = torch.abs(target[:, :, :-1] - target[:, :, 1:])
    target_dy = torch.abs(target[:, :-1, :] - target[:, 1:, :])
    dx, dy = torch.abs(pred_dx - target_dx), torch.abs(pred_dy - target_dy)
    (sum_dx, sum_dy), w = _over_batch(torch.stack([dx.sum(), dy.sum()]), sharded)
    return sum_dx / (dx.numel() * w) + sum_dy / (dy.numel() * w)


def _padded_grads(x):
    """|forward differences| of the two trailing axes, zero-padded at the end."""
    dx = F.pad(torch.abs(x[..., :-1] - x[..., 1:]), (0, 1))
    dy = F.pad(torch.abs(x[..., :-1, :] - x[..., 1:, :]), (0, 0, 0, 1))
    return dx, dy


def edge_aware_loss(pred, target, rgb, beta: float = 0.5, sharded: bool = False):
    """RGB-gradient-weighted depth-gradient L1, already scaled by ``beta``.

    ``rgb`` is NCHW (B, 3, H, W) (the JAX function takes NHWC); pred/target
    are (B, H, W). The RGB gradient magnitude is min-max normalised over the
    whole batch, as in the reference.
    """
    rgb_dx, rgb_dy = _padded_grads(rgb)
    grad_mag = torch.sqrt(torch.square(rgb_dx).mean(dim=1) + torch.square(rgb_dy).mean(dim=1))
    span = torch.stack([grad_mag.max(), -grad_mag.min()])
    hi, neg_lo = (global_max(span, data_group()) if sharded else span).unbind()
    grad_mag = (grad_mag + neg_lo) / (hi + neg_lo + 1e-6)
    pred_dx, pred_dy = _padded_grads(pred)
    target_dx, target_dy = _padded_grads(target)
    (dx_sum, dy_sum), w = _over_batch(
        torch.stack([(grad_mag * torch.abs(pred_dx - target_dx)).sum(),
                     (grad_mag * torch.abs(pred_dy - target_dy)).sum()]), sharded)
    return beta * (dx_sum / (pred.numel() * w) + dy_sum / (pred.numel() * w))


def per_pixel_scale_invariant_loss(pred, target):
    """Single-sample (H, W) SI loss map for visualisation; pred and target
    must be positive (no epsilon, as the reference)."""
    log_diff = torch.log(pred) - torch.log(target)
    return torch.square(log_diff - log_diff.mean())


def combined_loss(pred, target, config, rgb=None, sums=si_loss_sums, sharded: bool = False):
    """Config-weighted loss mix (src/main.py:51-89) -> (total, parts).

    Every part is computed and returned, alpha-scaled, even where its alpha
    is 0, because the parts are logged under the reference's keys
    (si_loss, silog_loss, grad_loss, edge_loss). ``rgb`` is NCHW; ``sums`` as
    in ``scale_invariant_loss``. ``sharded``: this process holds an equal
    share of a global batch, and the loss is the global batch's, the same on
    every process (module docstring).
    """
    lf = config.model.loss_function
    si = scale_invariant_loss(pred, target, sums=sums, sharded=sharded) * lf.si_loss_alpha
    slog = silog_loss(pred, target, mask=target > 0, variance_focus=lf.silog_loss.variance_focus,
                      sharded=sharded) * lf.silog_loss.alpha
    grad = gradient_loss(pred, target, sharded=sharded) * lf.grad_loss_alpha
    if rgb is not None:
        edge = edge_aware_loss(pred, target, rgb, beta=lf.edge_loss_alpha, sharded=sharded)
    else:
        edge = torch.zeros((), dtype=pred.dtype, device=pred.device)
    total = si + slog + grad + edge
    return total, {"si_loss": si, "silog_loss": slog, "grad_loss": grad, "edge_loss": edge}
