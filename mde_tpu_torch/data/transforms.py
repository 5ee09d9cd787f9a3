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

The PairAug path (``augmentation: True``) is not ported yet.
"""

from __future__ import annotations

import functools

import torch

from ..ops.image import color_jitter, color_jitter_draws, normalize_imagenet, to_float
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
                     generator: torch.Generator | None = None, plain: bool = False):
    """(B, H, W, 3) uint8 and (B, H, W) depth -> (rgb (B, 3, *input_size)
    float32, depth (B, *input_size)): half-pixel resize with the JAX rounding,
    colour jitter with draws from ``generator``, ImageNet normalisation.

    Both branches make the same generator calls and compute the same
    function: the kernel's plain version (``preprocess_u8_train_plain``) is
    this plain branch with the draws made first.
    """
    size = _size(input_size)
    if plain or rgb_u8.device.type == "cpu":
        rgb = resize_half_pixel(to_float(rgb_u8).permute(0, 3, 1, 2), size)
        rgb = normalize_imagenet(color_jitter(rgb, *JITTER, generator=generator)).contiguous()
    else:
        draws = color_jitter_draws(rgb_u8.shape[0], *JITTER, generator=generator)
        rgb = preprocess_u8_train(rgb_u8, pack_jitter_draws(*draws), size)
    return rgb, resize_depth(depth, size)


def make_train_pipeline(augmentation: bool, input_size):
    """fn(rgb_u8, depth, generator) -> (rgb, depth) per the config switch
    (src/main.py:575-583)."""
    if augmentation:
        raise NotImplementedError(
            "augmentation: True (PairAug) is not ported to mde_tpu_torch yet "
            "(ROADMAP.md, Queue 1: the augmentation path)")
    return functools.partial(preprocess_train, input_size=_size(input_size))
