"""Depth evaluation metrics (port of mde_tpu/metrics/metrics.py).

- ``delta_thres``              src/util.py:183-207 (log-scale aligned ratio accuracy)
- ``absolute_relative_error``  src/util.py:210-219
- ``masked_si_rmse``           the per-image loop of src/main.py:298-323 as one
                               masked batch reduction
- ``evaluation_metrics``       the evaluation protocol (src/evaluation.py:143-185);
                               its SI-RMSE goes through the ``si_loss_sums`` kernel
- ``full_metric_suite``        the 7-metric in-train suite (src/main.py:254-392)

All metrics take (B, H, W) depth maps and return 0-d tensors on the input's
device; callers convert to floats once a batch.
"""

from __future__ import annotations

import torch

from ..losses.losses import scale_invariant_loss

EPSILON = 1e-6


def delta_thres(pred, target, thres: float):
    """Fraction of pixels whose log-scale-aligned ratio is below ``thres``,
    per sample, then the batch mean."""
    b = pred.shape[0]
    pred = pred.reshape(b, -1)
    target = target.reshape(b, -1)
    scale = torch.exp(torch.mean(torch.log(target + EPSILON) - torch.log(pred + EPSILON),
                                 dim=1, keepdim=True))
    aligned = pred * scale
    ratio = torch.maximum(aligned / target, target / aligned)
    return (ratio < thres).to(torch.float32).mean(dim=1).mean()


def absolute_relative_error(pred, target):
    """mean(|target - pred| / (target + 1e-6)) over everything."""
    return (torch.abs(target - pred) / (target + EPSILON)).mean()


def masked_si_rmse(pred, target):
    """Per-image masked scale-invariant RMSE, summed over the batch.

    valid = target > 1e-6, pred clamped to >= 1e-6, d = log p - log t over the
    valid pixels, per image sqrt(mean((d - mean d)^2)); an image with no valid
    pixel adds 0 (the reference ``continue``s). The caller divides by N.
    """
    b = pred.shape[0]
    pred = pred.reshape(b, -1)
    target = target.reshape(b, -1)
    valid = (target > EPSILON).to(pred.dtype)
    count = valid.sum(dim=1)
    safe_count = torch.clamp(count, min=1.0)
    log_t = torch.log(torch.where(valid > 0, target, torch.ones_like(target)))
    log_p = torch.log(torch.clamp(pred, min=EPSILON))
    diff = (log_p - log_t) * valid
    mean = diff.sum(dim=1) / safe_count
    var = (torch.square(diff - mean[:, None]) * valid).sum(dim=1) / safe_count
    per_image = torch.sqrt(var)
    return torch.where(count > 0, per_image, torch.zeros_like(per_image)).sum()


def evaluation_metrics(pred, target, base_thres: float = 1.05, n_delta: int = 3) -> dict:
    """Batch means of the evaluation protocol: ``si_rmse`` (square-rooted SI
    loss, the Kaggle metric), ``abs_rel`` and ``delta_1..n`` at base_thres**j."""
    out = {
        "si_rmse": scale_invariant_loss(pred, target, sqroot=True),
        "abs_rel": absolute_relative_error(pred, target),
    }
    for j in range(1, n_delta + 1):
        out[f"delta_{j}"] = delta_thres(pred, target, thres=base_thres**j)
    return out


def full_metric_suite(pred, target) -> dict:
    """Batch sums of the in-train suite; the epoch loop applies the
    reference's normalisations. Delta uses the unaligned ratio
    max(p/(t+eps), t/(p+eps)) < 1.25^k (src/main.py:326-329)."""
    abs_diff = torch.abs(pred - target)
    ratio = torch.maximum(pred / (target + EPSILON), target / (pred + EPSILON))
    return {
        "mae_sum": abs_diff.sum(),
        "sq_sum": torch.square(abs_diff).sum(),
        "rel_sum": (abs_diff / (target + EPSILON)).sum(),
        "sirmse_sum": masked_si_rmse(pred, target),
        "delta1_count": (ratio < 1.25).sum(),
        "delta2_count": (ratio < 1.25**2).sum(),
        "delta3_count": (ratio < 1.25**3).sum(),
    }
