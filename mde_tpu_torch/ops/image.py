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
kernel (``ops.kernels.preprocess_u8_train``).

The paired augmentations of PairAug (mde_tpu/ops/image.py:178-323) follow the
same split: ``pair_geometric_draws``, ``bernoulli_draws`` and
``gaussian_blur_draws`` make the draws on the CPU, and
``pair_geometric_affine``, ``affine_sample``, ``random_gaussian_noise`` and
``random_gaussian_blur`` are the math, on the device of their inputs. They
are plain PyTorch on the card too: XLA, not Pallas, runs them in the JAX
package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_GRAY_WEIGHTS = (0.2989, 0.587, 0.114)


def to_float(u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] (torchvision ToTensor value semantics)."""
    return u8.to(torch.float32) / 255.0


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) float -> ImageNet-normalised, per channel. The constants
    are scalars: nothing is copied to the card."""
    return torch.stack([(x[:, c] - IMAGENET_MEAN[c]) / IMAGENET_STD[c] for c in range(3)], dim=1)


# ---------------------------------------------------------------------------
# Colour jitter. ``factor`` arguments are (B,) tensors, one value a sample.
# ---------------------------------------------------------------------------


def _per_sample(factor: torch.Tensor) -> torch.Tensor:
    return factor.reshape(-1, 1, 1, 1)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 1, H, W) luma with the ITU-R 601 weights (scalars:
    nothing is copied to the card)."""
    r, g, b = (x[:, c:c + 1] * _GRAY_WEIGHTS[c] for c in range(3))
    return r + g + b


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
    0..3 (brightness, contrast, saturation, hue) a sample. Each sample goes
    through its four adjustments on its own, so nothing but the factors
    (stacked, and moved to ``x``'s device if they are elsewhere) is copied
    to the card: the order is read on the host.
    """
    factors = torch.stack([fb, fc, fs, fh], dim=1).to(device=x.device, dtype=x.dtype)
    out = []
    for i, order in enumerate(torch.as_tensor(perms).tolist()):
        img = x[i:i + 1]
        for op in order:
            img = _ADJUSTMENTS[op](img, factors[i:i + 1, op])
        out.append(img)
    return torch.cat(out)


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
                 hue: float = 0.1, generator: torch.Generator | None = None,
                 rows=None) -> torch.Tensor:
    """Per-sample torchvision-style colour jitter on an NCHW batch, with the
    draws of ``color_jitter_draws``. The reference's default path uses
    (0.2, 0.2, 0.2, 0.1) (src/main.py:580). ``rows`` (start, stop, total):
    ``x`` is rows [start, stop) of a batch of ``total``, which the draws are
    made for (one data-parallel process's share).
    """
    b = x.shape[0] if rows is None else rows[2]
    draws = color_jitter_draws(b, brightness, contrast, saturation, hue, generator)
    if rows is not None:
        draws = [d[rows[0]:rows[1]] for d in draws]
    return color_jitter_apply(x, *draws)


# ---------------------------------------------------------------------------
# Paired geometric augmentation: one affine warp of RGB and depth together
# ---------------------------------------------------------------------------


def bernoulli_draws(b: int, p: float, generator: torch.Generator | None = None) -> torch.Tensor:
    """(B,) float32 gates, 1 with probability ``p``: ``torch.rand(b) < p``."""
    return (torch.rand(b, generator=generator) < p).float()


def pair_geometric_draws(b: int, generator: torch.Generator | None = None,
                         crop_scale: tuple[float, float] = (0.8, 1.0), hflip_p: float = 0.5,
                         rot_degrees: float = 3.0, rot_p: float = 0.3):
    """PairAug's geometric draws for a batch of ``b`` (src/main.py:479-486),
    each (B,) float32 from ``generator`` in this order: the crop's area
    fraction ~ U[crop_scale], its top and left as fractions of the free
    margin ~ U[0, 1), the flip gate (p = ``hflip_p``), the angle in degrees
    ~ U[-rot_degrees, rot_degrees] and the rotation gate (p = ``rot_p``)."""
    def uniform(lo, hi):
        return torch.rand(b, generator=generator) * (hi - lo) + lo

    area = uniform(*crop_scale)
    top = uniform(0.0, 1.0)
    left = uniform(0.0, 1.0)
    flip = bernoulli_draws(b, hflip_p, generator)
    angle = uniform(-rot_degrees, rot_degrees)
    rot_gate = bernoulli_draws(b, rot_p, generator)
    return area, top, left, flip, angle, rot_gate


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose (..., 2, 3) affines as 3x3: the result maps through b after a."""
    bottom = torch.tensor([[0.0, 0.0, 1.0]], dtype=a.dtype, device=a.device)
    a3 = torch.cat([a, bottom.expand(*a.shape[:-2], 1, 3)], dim=-2)
    b3 = torch.cat([b, bottom.expand(*b.shape[:-2], 1, 3)], dim=-2)
    return (a3 @ b3)[..., :2, :]


def pair_geometric_affine(area, top, left, flip, angle, rot_gate, height: int,
                          width: int) -> torch.Tensor:
    """PairAug's geometric pipeline as one (B, 2, 3) inverse affine from the
    draws of ``pair_geometric_draws`` (mde_tpu/ops/image.py:230-291): a crop
    of relative side sqrt(area) (aspect ratio 1) resized back, a horizontal
    flip and a rotation about the centre, composed so that RGB and depth are
    interpolated once. It maps output pixel coordinates (x, y, 1) to input
    ones."""
    side = torch.sqrt(area)
    crop_h = side * height
    crop_w = side * width
    top = top * (height - crop_h)
    left = left * (width - crop_w)
    zeros = torch.zeros_like(area)
    ones = torch.ones_like(area)

    # Crop and resize, inverted: output pixel -> crop box (half-pixel convention).
    sx = crop_w / width
    sy = crop_h / height
    crop_theta = torch.stack([torch.stack([sx, zeros, left + 0.5 * sx - 0.5], dim=-1),
                              torch.stack([zeros, sy, top + 0.5 * sy - 0.5], dim=-1)], dim=-2)

    # Horizontal flip (its own inverse): x -> W - 1 - x.
    fsx = 1.0 - 2.0 * flip
    ftx = flip * (width - 1.0)
    flip_theta = torch.stack([torch.stack([fsx, zeros, ftx], dim=-1),
                              torch.stack([zeros, ones, zeros], dim=-1)], dim=-2)

    # Rotation, inverted: by -angle about the image centre.
    rad = -(angle * rot_gate) * (math.pi / 180.0)
    cos, sin = torch.cos(rad), torch.sin(rad)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    rot_theta = torch.stack([torch.stack([cos, -sin, cx - cos * cx + sin * cy], dim=-1),
                             torch.stack([sin, cos, cy - sin * cx - cos * cy], dim=-1)], dim=-2)

    # Applied crop -> flip -> rotate; the inverse maps compose innermost first.
    return _compose(crop_theta, _compose(flip_theta, rot_theta))


def affine_sample(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Inverse-warp an NCHW batch with per-sample (B, 2, 3) affines ``theta``
    (output pixel (x, y, 1) -> input coordinates), bilinear, each of the four
    taps outside the image read as 0 (mde_tpu/ops/image.py:178-213): the
    JAX code's floor, fractions and sum order, tap by tap."""
    b, c, h, w = img.shape
    t = theta.to(device=img.device, dtype=img.dtype).reshape(b, 6, 1, 1)
    xs = torch.arange(w, dtype=img.dtype, device=img.device).view(1, 1, w)
    ys = torch.arange(h, dtype=img.dtype, device=img.device).view(1, h, 1)
    sx = t[:, 0] * xs + t[:, 1] * ys + t[:, 2]  # (B, H, W)
    sy = t[:, 3] * xs + t[:, 4] * ys + t[:, 5]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0).unsqueeze(1)
    fy = (sy - y0).unsqueeze(1)
    flat = img.reshape(b, c, h * w)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = flat.gather(2, idx.view(b, 1, h * w).expand(b, c, h * w)).view(b, c, h, w)
        return vals * valid.unsqueeze(1).to(img.dtype)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


# ---------------------------------------------------------------------------
# Gaussian noise and blur, gated per sample
# ---------------------------------------------------------------------------


def standard_normal(shape, seed: int, device) -> torch.Tensor:
    """float32 N(0, 1) of ``shape`` on ``device``, from a generator on that
    device seeded with ``seed``: the CPU's mt19937 and the card's Philox give
    different numbers for one seed (and both differ from ``jax.random``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device)


def random_gaussian_noise(x: torch.Tensor, gate: torch.Tensor, noise: torch.Tensor,
                          std: float = 0.005) -> torch.Tensor:
    """x + std * noise where the sample's gate is 1 (mde_tpu/ops/image.py:294-298);
    ``noise`` is N(0, 1) of x's shape, ``gate`` (B,) of 0 and 1."""
    return x + (noise * std) * gate.to(x).view(-1, 1, 1, 1)


def gaussian_blur_draws(b: int, generator: torch.Generator | None = None,
                        sigma: tuple[float, float] = (0.1, 2.0), p: float = 0.2):
    """The blur's draws from ``generator``: the (B,) gate (p = ``p``), then
    the (B,) sigma ~ U[sigma]."""
    gate = bernoulli_draws(b, p, generator)
    sig = torch.rand(b, generator=generator) * (sigma[1] - sigma[0]) + sigma[0]
    return gate, sig


def random_gaussian_blur(x: torch.Tensor, gate: torch.Tensor, sigma: torch.Tensor,
                         kernel_size: int = 3) -> torch.Tensor:
    """Separable per-sample gaussian blur of an NCHW batch, along W then H,
    with the edge value as padding (as the JAX code pads,
    mde_tpu/ops/image.py:301-323), where the sample's gate is 1."""
    b, _, h, w = x.shape
    half = kernel_size // 2
    offs = torch.arange(-half, half + 1, dtype=x.dtype, device=x.device)
    taps = torch.exp(-0.5 * (offs[None, :] / sigma.to(x)[:, None]) ** 2)
    taps = (taps / taps.sum(dim=1, keepdim=True)).view(b, kernel_size, 1, 1, 1)
    pad_w = F.pad(x, (half, half, 0, 0), mode="replicate")
    out = taps[:, 0] * pad_w[..., 0:w]
    for i in range(1, kernel_size):
        out = out + taps[:, i] * pad_w[..., i:i + w]
    pad_h = F.pad(out, (0, 0, half, half), mode="replicate")
    out = taps[:, 0] * pad_h[..., 0:h, :]
    for i in range(1, kernel_size):
        out = out + taps[:, i] * pad_h[..., i:i + h, :]
    return x + (out - x) * gate.to(x).view(-1, 1, 1, 1)
