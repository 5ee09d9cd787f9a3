"""Image value maps of the serving and training paths (port of mde_tpu/ops/image.py).

The port keeps images in the model's NCHW layout, so ``normalize_imagenet``
normalises along dim 1 and the colour jitter works on (B, 3, H, W) batches in
[0, 1]. The jitter follows the JAX package (``ops/image.py:61-170``):
torchvision's factor distributions, PIL ImageEnhance blends for brightness,
contrast and saturation, torchvision's tensor hue formula, and a per-sample
random order of the four adjustments. Its random draws come from an explicit
``torch.Generator`` on the CPU (``color_jitter_draws``);
``color_jitter_apply`` takes them as arguments, so a test can hand it the
JAX package's draws, and the train step hands the same draws to the fused
kernel (``ops.kernels.preprocess_u8_train``). The paired
augmentations (PairAug) are not ported yet (ROADMAP, the augmentation path).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_GRAY_WEIGHTS = (0.2989, 0.587, 0.114)


def to_float(u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] (torchvision ToTensor value semantics)."""
    return u8.to(torch.float32) / 255.0


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) float -> ImageNet-normalised, per channel."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# Colour jitter. ``factor`` arguments are (B,) tensors, one value a sample.
# ---------------------------------------------------------------------------


def _per_sample(factor: torch.Tensor) -> torch.Tensor:
    return factor.reshape(-1, 1, 1, 1)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1, H, W) luma with the ITU-R 601 weights."""
    w = torch.tensor(_GRAY_WEIGHTS, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    return (x * w).sum(dim=1, keepdim=True)


def _blend(a: torch.Tensor, b: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    ratio = _per_sample(ratio)
    return torch.clamp(ratio * a + (1.0 - ratio) * b, 0.0, 1.0)


def adjust_brightness(x, factor):
    return _blend(x, torch.zeros_like(x), factor)


def adjust_contrast(x, factor):
    mean = rgb_to_grayscale(x).mean(dim=(-2, -1), keepdim=True)
    return _blend(x, mean, factor)


def adjust_saturation(x, factor):
    return _blend(x, rgb_to_grayscale(x), factor)


def _rgb_to_hsv(x):
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    maxc = x.amax(dim=1)
    minc = x.amin(dim=1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), torch.zeros_like(maxc))
    safe_delta = torch.where(delta > 0, delta, torch.ones_like(delta))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    # Sector i takes (r, g, b) from these per-sector choices (jnp.select in JAX).
    sectors = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))
    r, g, b = torch.zeros_like(v), torch.zeros_like(v), torch.zeros_like(v)
    for k in range(5, -1, -1):
        sel = i == k
        r = torch.where(sel, sectors[k][0], r)
        g = torch.where(sel, sectors[k][1], g)
        b = torch.where(sel, sectors[k][2], b)
    return torch.stack([r, g, b], dim=1)


def adjust_hue(x, factor):
    h, s, v = _rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    h = torch.remainder(h + factor.reshape(-1, 1, 1), 1.0)
    return _hsv_to_rgb(h, s, v)


_ADJUSTMENTS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter_apply(x, fb, fc, fs, fh, perms) -> torch.Tensor:
    """Apply per-sample jitter factors in a per-sample order.

    x: (B, 3, H, W) in [0, 1]; fb/fc/fs/fh: (B,) brightness, contrast,
    saturation and hue factors; perms: (B, 4) integers, a permutation of
    0..3 (brightness, contrast, saturation, hue) a sample. The samples that
    take the same adjustment at the same position go through it together.
    """
    factors = [f.to(device=x.device, dtype=x.dtype) for f in (fb, fc, fs, fh)]
    perms = torch.as_tensor(perms).cpu()
    out = x
    for pos in range(perms.shape[1]):
        parts = []
        for op, adjust in enumerate(_ADJUSTMENTS):
            idx = torch.nonzero(perms[:, pos] == op).flatten()
            if idx.numel():
                idx = idx.to(x.device)
                parts.append((idx, adjust(out.index_select(0, idx),
                                          factors[op].index_select(0, idx))))
        out = out.clone()
        for idx, value in parts:
            out[idx] = value
    return out


def color_jitter_draws(b: int, brightness: float = 0.2, contrast: float = 0.2,
                       saturation: float = 0.2, hue: float = 0.1,
                       generator: torch.Generator | None = None):
    """The jitter's random draws for a batch of ``b``: (fb, fc, fs, fh), each
    (B,) float32, and perms (B, 4) int64, from ``generator`` (a CPU
    ``torch.Generator``): four ``torch.rand(b)`` and then ``b`` calls to
    ``randperm(4)``, in that order.

    Factors ~ U[max(0, 1 - a), 1 + a] (hue ~ U[-h, h]) and one random order
    of the four adjustments a sample.
    """
    def uniform(lo, hi):
        return torch.rand(b, generator=generator) * (hi - lo) + lo

    fb = uniform(max(0.0, 1 - brightness), 1 + brightness)
    fc = uniform(max(0.0, 1 - contrast), 1 + contrast)
    fs = uniform(max(0.0, 1 - saturation), 1 + saturation)
    fh = uniform(-hue, hue)
    perms = torch.stack([torch.randperm(4, generator=generator) for _ in range(b)])
    return fb, fc, fs, fh, perms


def color_jitter(x, brightness: float = 0.2, contrast: float = 0.2, saturation: float = 0.2,
                 hue: float = 0.1, generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample torchvision-style colour jitter on an NCHW batch, with the
    draws of ``color_jitter_draws``. The reference's default path uses
    (0.2, 0.2, 0.2, 0.1) (src/main.py:580).
    """
    draws = color_jitter_draws(x.shape[0], brightness, contrast, saturation, hue, generator)
    return color_jitter_apply(x, *draws)
