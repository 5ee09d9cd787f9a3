"""Plain PyTorch reference of what surrounds the model: the serving and
training preprocessing, the loss and the optimizer step.

Written from the reference's specification (src/main.py, src/util.py) and
independent of the program:

- ``preprocess_eval``: uint8 RGB -> float in [0, 1] -> half-pixel bilinear
  resize to the input size -> ImageNet normalisation. The source coordinate
  of each output pixel is ``(o + 0.5) * (in / out) - 0.5``, the product and
  the difference each rounded to float32 (as jax.image.resize computes it),
  clamped at 0.
- ``predict``: the model in eval mode on that, then an align-corners
  bilinear resize to the native size (src/util.py:305-313).
- ``jitter_draws`` and ``preprocess_train``: torchvision's
  ColorJitter(0.2, 0.2, 0.2, 0.1) with PIL-style blends for brightness,
  contrast and saturation, torchvision's tensor hue shift, and one random
  order of the four a sample (src/main.py:578-583). The draws come from the
  step's CPU generator: four ``torch.rand(B)`` (brightness, contrast,
  saturation, hue), then ``B`` calls of ``randperm(4)``. The depth target is
  resized with align corners (src/main.py:37-48).
- ``si_loss``: the per-sample scale-invariant log loss, batch-averaged
  (src/util.py:129-156); the configuration's other loss terms are 0.
- ``AdamW``: torch's AdamW update written out (decoupled weight decay, then
  the bias-corrected Adam step).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
GREY = (0.2989, 0.587, 0.114)
JITTER = (0.2, 0.2, 0.2, 0.1)  # brightness, contrast, saturation, hue


def _taps(n_in: int, n_out: int, device):
    scale = float(np.float32(n_in) / np.float32(n_out))
    o = torch.arange(n_out, dtype=torch.float32, device=device)
    src = torch.clamp((o + 0.5) * scale - 0.5, min=0.0)
    lo = torch.clamp(src.long(), max=n_in - 1)
    hi = torch.clamp(lo + 1, max=n_in - 1)
    return lo, hi, src - lo


def resize_half_pixel(x: torch.Tensor, size) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *size), half-pixel bilinear, rows then columns."""
    for axis, n_out in ((2, int(size[0])), (3, int(size[1]))):
        if x.shape[axis] == n_out:
            continue
        lo, hi, frac = _taps(x.shape[axis], n_out, x.device)
        shape = [1, 1, 1, 1]
        shape[axis] = n_out
        frac = frac.view(shape)
        x = x.index_select(axis, lo) * (1.0 - frac) + x.index_select(axis, hi) * frac
    return x


def normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def to_unit(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32 in [0, 1]."""
    return rgb_u8.permute(0, 3, 1, 2).float() / 255.0


def preprocess_eval(rgb_u8: torch.Tensor, input_size) -> torch.Tensor:
    return normalize(resize_half_pixel(to_unit(rgb_u8), input_size))


@torch.no_grad()
def predict(model, rgb_u8: torch.Tensor, input_size, native_size) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, *native_size) float32 depth."""
    model.eval()
    pred = model(preprocess_eval(rgb_u8, input_size))
    return F.interpolate(pred[:, None], size=tuple(native_size), mode="bilinear",
                         align_corners=True)[:, 0]


def jitter_draws(b: int, generator: torch.Generator):
    """(factors (B, 4): brightness, contrast, saturation, hue; orders (B, 4))."""
    cols = []
    for i, a in enumerate(JITTER):
        lo, hi = (-a, a) if i == 3 else (max(0.0, 1.0 - a), 1.0 + a)
        cols.append(torch.rand(b, generator=generator) * (hi - lo) + lo)
    orders = torch.stack([torch.randperm(4, generator=generator) for _ in range(b)])
    return torch.stack(cols, dim=1), orders


def _grey(x):
    return x[:, 0:1] * GREY[0] + x[:, 1:2] * GREY[1] + x[:, 2:3] * GREY[2]


def _blend(a, b, f):
    return torch.clamp(f * a + (1.0 - f) * b, 0.0, 1.0)


def _hue(x, shift):
    x = torch.clamp(x, 0.0, 1.0)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    maxc, minc = x.amax(dim=1), x.amin(dim=1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), torch.zeros_like(maxc))
    d = torch.where(delta > 0, delta, torch.ones_like(delta))
    rc, gc, bc = (maxc - r) / d, (maxc - g) / d, (maxc - b) / d
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    h = torch.remainder(h + shift, 1.0)
    v = maxc
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - f * s), v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.long(), 6)
    table = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))
    out = [torch.zeros_like(v) for _ in range(3)]
    for k, row in enumerate(table):
        for c in range(3):
            out[c] = torch.where(i == k, row[c], out[c])
    return torch.stack(out, dim=1)


def jitter(x: torch.Tensor, factors: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """Each sample of (B, 3, H, W) through its four adjustments in its order."""
    out = []
    for i in range(x.shape[0]):
        img = x[i:i + 1]
        for op in orders[i].tolist():
            f = float(factors[i, op])
            if op == 0:
                img = _blend(img, torch.zeros_like(img), f)
            elif op == 1:
                img = _blend(img, _grey(img).mean(dim=(-2, -1), keepdim=True), f)
            elif op == 2:
                img = _blend(img, _grey(img), f)
            else:
                img = _hue(img, f)
        out.append(img)
    return torch.cat(out)


def preprocess_train(rgb_u8, depth, input_size, generator: torch.Generator):
    """(B, H, W, 3) uint8 and (B, H, W) depth -> (normalised jittered rgb,
    depth at the input size), the draws from ``generator``."""
    factors, orders = jitter_draws(rgb_u8.shape[0], generator)
    rgb = normalize(jitter(resize_half_pixel(to_unit(rgb_u8), input_size), factors, orders))
    depth = F.interpolate(depth[:, None].float(), size=tuple(input_size), mode="bilinear",
                          align_corners=True)[:, 0]
    return rgb, depth


def si_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    d = (torch.log(pred + eps) - torch.log(target + eps)).flatten(1)
    return (d.square().mean(dim=1) - d.mean(dim=1).square()).mean()


class AdamW:
    """torch.optim.AdamW's update, written out, over named parameters."""

    def __init__(self, params: dict, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = p.grad
            if g is None:  # a leaf no forward reads: torch's AdamW skips it
                continue
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
