"""MiDaS-style host preprocessing (port of mde_tpu/data/midas_transforms.py).

A copy of mde_tpu's numpy + cv2 code, which reimplements the numeric contract
of the reference's vendored MiDaS transforms (src/preprocessing/transforms.py):
the resize-shape rules (keep-aspect x lower/upper-bound/minimal x snap to a
multiple), the ImageNet and MiDaS normalisation constants and the per-model
pipelines of ``transforms()``. Its outputs equal mde_tpu's bit for bit.

Host utilities for inference on arbitrary images; training and serving use
the fused pipeline on the card (ops/image.py, K3). Images stay HWC float32:
``PrepareForNet`` only casts and makes contiguous (a caller that feeds the
port's NCHW models transposes).

Behavioural reference: transforms.py:5-137 (registry), :138-177
(apply_min_size), :180-326 (Resize), :329-340 (NormalizeImage), :343-363
(PrepareForNet).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import cv2
import numpy as np


def snap_to_multiple(x: float, multiple: int, min_val: int = 0, max_val: int | None = None) -> int:
    """Round ``x`` to the nearest multiple, preferring floor/ceil to respect
    the [min_val, max_val] bounds (transforms.py:205-223)."""
    y = int(round(x / multiple) * multiple)
    if max_val is not None and y > max_val:
        y = int(math.floor(x / multiple) * multiple)
    if y < min_val:
        y = int(math.ceil(x / multiple) * multiple)
    return y


def compute_resize_shape(
    in_w: int,
    in_h: int,
    target_w: int,
    target_h: int,
    keep_aspect_ratio: bool = False,
    multiple_of: int = 1,
    method: str = "lower_bound",
) -> tuple[int, int]:
    """Pure resize-shape selection (transforms.py:226-286). Returns (w, h).

    method:
      lower_bound — output >= target on both axes (fit-outside when keeping AR)
      upper_bound — output <= target on both axes (fit-inside when keeping AR)
      minimal     — scale each axis to target; when keeping AR, use whichever
                    axis scale is closest to 1.
    """
    if method not in ("lower_bound", "upper_bound", "minimal"):
        raise ValueError(f"resize_method {method} not implemented")

    scale_w = target_w / in_w
    scale_h = target_h / in_h
    if keep_aspect_ratio:
        if method == "lower_bound":
            s = max(scale_w, scale_h)
        elif method == "upper_bound":
            s = min(scale_w, scale_h)
        else:  # minimal: the scale closest to identity
            s = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
        scale_w = scale_h = s

    if method == "lower_bound":
        return (
            snap_to_multiple(scale_w * in_w, multiple_of, min_val=target_w),
            snap_to_multiple(scale_h * in_h, multiple_of, min_val=target_h),
        )
    if method == "upper_bound":
        return (
            snap_to_multiple(scale_w * in_w, multiple_of, max_val=target_w),
            snap_to_multiple(scale_h * in_h, multiple_of, max_val=target_h),
        )
    return (
        snap_to_multiple(scale_w * in_w, multiple_of),
        snap_to_multiple(scale_h * in_h, multiple_of),
    )


def _resize_sample_targets(sample: dict, wh: tuple[int, int],
                           include_depth: bool = True) -> None:
    """Nearest-resize the non-image planes present. ``include_depth=False``
    for apply_min_size parity: the reference's apply_min_size touches only
    disparity+mask (transforms.py:166-175), while Resize also handles depth."""
    keys = ("disparity", "depth") if include_depth else ("disparity",)
    for key in keys:
        if key in sample:
            sample[key] = cv2.resize(sample[key], wh, interpolation=cv2.INTER_NEAREST)
    if "mask" in sample:
        # nearest-resize through float32, back to bool (transforms.py:171-175,
        # :306-311 — both reference paths do the round-trip cast).
        sample["mask"] = cv2.resize(
            sample["mask"].astype(np.float32), wh, interpolation=cv2.INTER_NEAREST
        ).astype(bool)


def apply_min_size(sample: dict, size, image_interpolation_method=cv2.INTER_AREA):
    """Upscale (never downscale) so the sample reaches at least ``size``
    (transforms.py:138-177)."""
    h, w = sample["disparity"].shape[:2]
    if h >= size[0] and w >= size[1]:
        return sample
    scale = max(size[0] / h, size[1] / w)
    out_h, out_w = math.ceil(scale * h), math.ceil(scale * w)
    sample["image"] = cv2.resize(
        sample["image"], (out_w, out_h), interpolation=image_interpolation_method
    )
    _resize_sample_targets(sample, (out_w, out_h), include_depth=False)
    return (out_h, out_w)


@dataclasses.dataclass(frozen=True)
class Resize:
    """Sample-dict resize over ``compute_resize_shape`` (transforms.py:180-326)."""

    width: int
    height: int
    resize_target: bool = True
    keep_aspect_ratio: bool = False
    ensure_multiple_of: int = 1
    resize_method: str = "lower_bound"
    image_interpolation_method: int = cv2.INTER_AREA

    def get_size(self, width: int, height: int) -> tuple[int, int]:
        return compute_resize_shape(
            width, height, self.width, self.height,
            self.keep_aspect_ratio, self.ensure_multiple_of, self.resize_method,
        )

    def __call__(self, sample: dict) -> dict:
        h, w = sample["image"].shape[:2]
        wh = self.get_size(w, h)
        sample["image"] = cv2.resize(
            sample["image"], wh, interpolation=self.image_interpolation_method
        )
        if self.resize_target:
            _resize_sample_targets(sample, wh)
        return sample


@dataclasses.dataclass(frozen=True)
class NormalizeImage:
    """image <- (image - mean) / std (transforms.py:329-340)."""

    mean: np.ndarray
    std: np.ndarray

    def __call__(self, sample: dict) -> dict:
        sample["image"] = (sample["image"] - self.mean) / self.std
        return sample


class PrepareForNet:
    """Cast every plane to contiguous float32 (transforms.py:343-363). Images
    stay HWC, as mde_tpu's (the reference transposes to CHW here)."""

    def __call__(self, sample: dict) -> dict:
        for key in ("image", "disparity", "depth", "mask"):
            if key in sample:
                sample[key] = np.ascontiguousarray(sample[key], dtype=np.float32)
        return sample


@dataclasses.dataclass(frozen=True)
class Compose:
    transforms: Sequence[Callable]

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


_IMAGENET = (np.asarray([0.485, 0.456, 0.406]), np.asarray([0.229, 0.224, 0.225]))
_MIDAS = (np.asarray([0.5, 0.5, 0.5]), np.asarray([0.5, 0.5, 0.5]))

# name -> (side, keep_aspect_ratio, resize_method, (mean, std));
# every pipeline snaps to /32 and resizes with bicubic (transforms.py:5-137).
_PIPELINES = {
    "default": (384, True, "upper_bound", _MIDAS),
    "small": (256, True, "upper_bound", _MIDAS),
    "dpt": (384, True, "minimal", _IMAGENET),
    "beit512": (512, True, "minimal", _IMAGENET),
    "swin384": (384, False, "minimal", _IMAGENET),
    "swin256": (256, False, "minimal", _IMAGENET),
    "levit": (224, False, "minimal", _IMAGENET),
}


def transforms() -> dict:
    """Named pipeline registry mirroring transforms.py:5-137."""
    return {
        name: Compose(
            (
                Resize(
                    side, side,
                    keep_aspect_ratio=keep_ar,
                    ensure_multiple_of=32,
                    resize_method=method,
                    image_interpolation_method=cv2.INTER_CUBIC,
                ),
                NormalizeImage(mean=mean_std[0], std=mean_std[1]),
                PrepareForNet(),
            )
        )
        for name, (side, keep_ar, method, mean_std) in _PIPELINES.items()
    }
