"""Depth-Anything-V2 (port of mde_tpu/models/depth_anything.py).

A DINOv2 trunk with a DPT head: four ViT blocks' tokens (``DA2_CONFIGS``
taps) reassembled by the flagship's ``Dinov2Head`` at the DA-V2 widths, the
release depth tail (3x3 conv to 32, ReLU, 1x1 conv to 1), then ReLU (or
``sigmoid * max_depth``, the metric variant) and an align-corners resize to
the input size. Every ViT attention runs through K4.

Submodules carry DA-V2's release names (trunk ``pretrained``, head
``depth_head``, the final 1x1 at ``depth_head.scratch.output_conv2.2``), so
``state_dict()`` is a release checkpoint's, the grammar that
mde_tpu/train/torch_import.py::map_depth_anything_key reads. The JAX module
calls that final 1x1 ``final``.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from ..nn.blocks import Conv
from ..nn.vit import VIT_CONFIGS, ViT
from ..ops.resize import resize_bilinear
from .midas_semantics import Dinov2Head

# Per size: ViT variant, tap blocks, head features and reassembly widths
# (DA-V2 model cards), as mde_tpu/models/depth_anything.py:32-36.
DA2_CONFIGS = {
    "vits": ("dinov2_vits14", (2, 5, 8, 11), 64, (48, 96, 192, 384)),
    "vitb": ("dinov2_vitb14", (2, 5, 8, 11), 128, (96, 192, 384, 768)),
    "vitl": ("dinov2_vitl14", (4, 11, 17, 23), 256, (256, 512, 1024, 1024)),
}

# Keys of the release grammar that no forward reads: refinenet4 is only ever
# called with one input, and mask_token serves masked-image training only.
DEAD_KEY_PREFIXES = (
    "pretrained.mask_token",
    "depth_head.scratch.refinenet4.resConfUnit1.",
)


class DepthAnythingV2(nn.Module):
    """forward(x (B, 3, H, W), H and W multiples of 14) -> (B, H, W) depth."""

    DEAD_KEY_PREFIXES = DEAD_KEY_PREFIXES

    def __init__(self, size: str = "vits", max_depth: Optional[float] = None):
        super().__init__()
        if size not in DA2_CONFIGS:
            raise ValueError(f"Depth-Anything-V2 size {size!r} is not one of {sorted(DA2_CONFIGS)}")
        variant, self.hooks, features, out_channels = DA2_CONFIGS[size]
        self.max_depth = max_depth
        self.pretrained = ViT(variant)
        self.depth_head = Dinov2Head(VIT_CONFIGS[variant][0], features, out_channels)
        self.depth_head.scratch.output_conv2 = nn.Sequential(
            Conv(features // 2, 32, 3, 1, 1), nn.ReLU(), Conv(32, 1, 1, 1, 0),
            nn.Sigmoid() if max_depth is not None else nn.ReLU())

    def forward(self, x, plain: bool = False):
        """``plain=True`` runs K4's plain version on any device."""
        _, _, h, w = x.shape
        patch = self.pretrained.patch
        taps = self.pretrained(x, out_indices=self.hooks, plain=plain)
        depth = self.depth_head(taps, h // patch, w // patch)
        if self.max_depth is not None:
            depth = depth * self.max_depth
        return resize_bilinear(depth, (h, w), align_corners=True)[:, 0]
