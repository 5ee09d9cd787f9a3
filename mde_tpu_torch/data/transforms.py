"""Batched preprocessing of the serving and training paths (port of
mde_tpu/data/transforms.py).

- ``preprocess_eval`` = Resize + ToTensor + ImageNet Normalize of the
  reference's test transform (src/main.py:585-589), plus the align-corners
  depth-target resize (src/main.py:37-48) when given depth. On a CUDA tensor
  the image part is one kernel (``ops.kernels.preprocess_u8``); on the CPU,
  that kernel's plain version.
- ``preprocess_train`` = the default train path, Resize + ColorJitter(0.2,
  0.2, 0.2, 0.1) + ToTensor + Normalize (src/main.py:578-583), then the depth
  resize. On a CUDA tensor the image part is one kernel with the jitter
  inside (``ops.kernels.preprocess_u8_train``), fed the jitter's draws from
  the step's generator; on the CPU, or with ``plain=True``, the same
  operations in plain PyTorch from the same draws.
- ``preprocess_pairaug`` = the PairAug path (``augmentation: True``,
  src/main.py:469-527): the same RGB resize and depth resize, one affine
  warp of RGB and depth together (resized crop, flip and rotation composed),
  then on RGB alone the colour jitter (0.4, 0.4, 0.4, 0.15) at p = 0.8,
  gaussian noise (std 0.005, p = 0.25) and a 3-tap gaussian blur (sigma in
  [0.1, 2], p = 0.2), then ImageNet normalisation. It is plain PyTorch on
  every device, as it is XLA in the JAX package. Its draws
  (``pairaug_draws``) come from the step's CPU generator, and go to the card
  as one (B, 14) copy of per-sample numbers; the noise is drawn on the
  step's device from a generator seeded by one of those draws.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..ops.image import (affine_sample, bernoulli_draws, color_jitter, color_jitter_apply,
                         color_jitter_draws, gaussian_blur_draws, normalize_imagenet,
                         pair_geometric_affine, pair_geometric_draws, random_gaussian_blur,
                         random_gaussian_noise, standard_normal, to_float)
from ..ops.kernels import (pack_jitter_draws, preprocess_u8, preprocess_u8_train,
                           resize_half_pixel)
from ..ops.resize import resize_bilinear


def _size(input_size) -> tuple[int, int]:
    return int(input_size[0]), int(input_size[1])


def resize_depth(depth: torch.Tensor, input_size) -> torch.Tensor:
    """(B, H, W) float32 depth -> (B, *input_size), align-corners bilinear."""
    return resize_bilinear(depth.to(torch.float32), _size(input_size), align_corners=True)


def preprocess_eval(rgb_u8: torch.Tensor, depth: torch.Tensor | None = None,
                    input_size=(448, 576)):
    """(B, H, W, 3) uint8 -> (B, 3, *input_size) normalised float32 NCHW;
    with ``depth`` (B, H, W), returns (rgb, resized depth)."""
    rgb = preprocess_u8(rgb_u8, _size(input_size))
    if depth is None:
        return rgb
    return rgb, resize_depth(depth, input_size)


JITTER = (0.2, 0.2, 0.2, 0.1)  # brightness, contrast, saturation, hue (src/main.py:580)


def preprocess_train(rgb_u8: torch.Tensor, depth: torch.Tensor, input_size=(448, 576),
                     generator: torch.Generator | None = None, plain: bool = False,
                     rows=None):
    """(B, H, W, 3) uint8 and (B, H, W) depth -> (rgb (B, 3, *input_size)
    float32, depth (B, *input_size)): half-pixel resize with the JAX rounding,
    colour jitter with draws from ``generator``, ImageNet normalisation.

    Both branches make the same generator calls and compute the same
    function: the kernel's plain version (``preprocess_u8_train_plain``) is
    this plain branch with the draws made first. ``rows`` (start, stop,
    total): the batch is rows [start, stop) of a microbatch of ``total``
    split over data-parallel processes; the draws are the whole microbatch's
    and each row gets its own, as in one process.
    """
    size = _size(input_size)
    if plain or rgb_u8.device.type == "cpu":
        rgb = resize_half_pixel(to_float(rgb_u8).permute(0, 3, 1, 2), size)
        rgb = normalize_imagenet(color_jitter(rgb, *JITTER, generator=generator,
                                              rows=rows)).contiguous()
    else:
        draws = color_jitter_draws(rgb_u8.shape[0] if rows is None else rows[2], *JITTER,
                                   generator=generator)
        if rows is not None:
            draws = [d[rows[0]:rows[1]] for d in draws]
        rgb = preprocess_u8_train(rgb_u8, pack_jitter_draws(*draws), size)
    return rgb, resize_depth(depth, size)


# PairAug's settings (mde_tpu/data/transforms.py:72-76)
PAIRAUG_JITTER = (0.4, 0.4, 0.4, 0.15)  # brightness, contrast, saturation, hue
PAIRAUG_JITTER_P, PAIRAUG_NOISE_STD, PAIRAUG_NOISE_P = 0.8, 0.005, 0.25
PAIRAUG_BLUR_KERNEL, PAIRAUG_BLUR_SIGMA, PAIRAUG_BLUR_P = 3, (0.1, 2.0), 0.2


class PairAugDraws(NamedTuple):
    """The draws of one PairAug batch, on the CPU: the geometry's (B,) area,
    top, left, flip, angle and rotation gate (``pair_geometric_draws``), the
    jitter's (fb, fc, fs, fh, perms) (``color_jitter_draws``), and the (B,)
    jitter, noise and blur gates, the noise's seed and the blur's sigma."""

    area: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    flip: torch.Tensor
    angle: torch.Tensor
    rot_gate: torch.Tensor
    jitter: tuple
    jitter_gate: torch.Tensor
    noise_gate: torch.Tensor
    noise_seed: int
    blur_gate: torch.Tensor
    blur_sigma: torch.Tensor


def pairaug_draws(b: int, generator: Optional[torch.Generator] = None) -> PairAugDraws:
    """A batch's PairAug draws from ``generator``, in the order of the fields."""
    geometry = pair_geometric_draws(b, generator)
    jitter = color_jitter_draws(b, *PAIRAUG_JITTER, generator=generator)
    jitter_gate = bernoulli_draws(b, PAIRAUG_JITTER_P, generator)
    noise_gate = bernoulli_draws(b, PAIRAUG_NOISE_P, generator)
    noise_seed = int(torch.randint(0, 2**62, (), generator=generator))
    blur_gate, blur_sigma = gaussian_blur_draws(b, generator, PAIRAUG_BLUR_SIGMA, PAIRAUG_BLUR_P)
    return PairAugDraws(*geometry, jitter, jitter_gate, noise_gate, noise_seed, blur_gate,
                        blur_sigma)


def pairaug_apply(rgb_u8: torch.Tensor, depth: torch.Tensor, draws: PairAugDraws,
                  input_size=(448, 576), noise: Optional[torch.Tensor] = None):
    """(B, H, W, 3) uint8 and (B, H, W) depth -> (rgb (B, 3, *input_size)
    float32, depth (B, *input_size)) through PairAug with the given draws
    (mde_tpu/data/transforms.py:59-78). ``noise`` is the (B, 3, *input_size)
    N(0, 1) draw; None draws it from ``draws.noise_seed`` on the batch's
    device. A stage whose gates are all 0 is skipped: it would add 0.

    The per-sample numbers (the warp's affine, the jitter's factors, the
    gates and sigma) are computed on the host and sent to the batch's device
    in one copy; the jitter's order stays on the host.
    """
    size = _size(input_size)
    b = rgb_u8.shape[0]
    rgb = resize_half_pixel(to_float(rgb_u8).permute(0, 3, 1, 2), size)
    depth = resize_depth(depth, size)

    theta = pair_geometric_affine(draws.area, draws.top, draws.left, draws.flip, draws.angle,
                                  draws.rot_gate, *size)
    fb, fc, fs, fh, perms = draws.jitter
    per_sample = torch.cat([theta.reshape(b, 6), torch.stack(
        [fb, fc, fs, fh, draws.jitter_gate, draws.noise_gate, draws.blur_gate,
         draws.blur_sigma], dim=1)], dim=1).to(rgb.device)
    theta, factors = per_sample[:, :6].view(b, 2, 3), per_sample[:, 6:10].unbind(1)
    jitter_gate, noise_gate, blur_gate, blur_sigma = per_sample[:, 10:].unbind(1)

    pair = affine_sample(torch.cat([rgb, depth[:, None]], dim=1), theta)
    rgb, depth = pair[:, :3], pair[:, 3]
    if bool(draws.jitter_gate.any()):
        jittered = color_jitter_apply(rgb, *factors, perms)
        rgb = rgb + (jittered - rgb) * jitter_gate.view(-1, 1, 1, 1)
    if bool(draws.noise_gate.any()):
        if noise is None:
            noise = standard_normal(rgb.shape, draws.noise_seed, rgb.device)
        rgb = random_gaussian_noise(rgb, noise_gate, noise, std=PAIRAUG_NOISE_STD)
    if bool(draws.blur_gate.any()):
        rgb = random_gaussian_blur(rgb, blur_gate, blur_sigma, kernel_size=PAIRAUG_BLUR_KERNEL)
    return normalize_imagenet(rgb).contiguous(), depth


def preprocess_pairaug(rgb_u8: torch.Tensor, depth: torch.Tensor, input_size=(448, 576),
                       generator: Optional[torch.Generator] = None, plain: bool = False,
                       rows=None):
    """PairAug with draws from ``generator`` (``pairaug_draws``, then
    ``pairaug_apply``). ``plain`` changes nothing: no kernel runs here.
    ``rows`` as in ``preprocess_train``: the draws and the noise are the whole
    microbatch's, and the batch takes its rows of them."""
    del plain
    if rows is None:
        return pairaug_apply(rgb_u8, depth, pairaug_draws(rgb_u8.shape[0], generator),
                             input_size)
    start, stop, total = rows
    draws = pairaug_draws(total, generator)
    fields = {k: (v[start:stop] if isinstance(v, torch.Tensor) else v)
              for k, v in draws._asdict().items()}
    fields["jitter"] = tuple(d[start:stop] for d in draws.jitter)
    draws = PairAugDraws(**fields)
    noise = None
    if bool(draws.noise_gate.any()):
        noise = standard_normal((total, 3, *_size(input_size)), draws.noise_seed,
                                rgb_u8.device)[start:stop]
    return pairaug_apply(rgb_u8, depth, draws, input_size, noise=noise)


def make_train_pipeline(augmentation: bool, input_size):
    """fn(rgb_u8, depth, generator, plain, rows) -> (rgb, depth) per the config
    switch (src/main.py:575-583): PairAug if ``augmentation`` else the
    default jitter path."""
    fn = preprocess_pairaug if augmentation else preprocess_train
    return functools.partial(fn, input_size=_size(input_size))
