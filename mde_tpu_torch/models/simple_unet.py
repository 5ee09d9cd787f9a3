"""SimpleUNet, the course's baseline model (port of mde_tpu/models/simple_unet.py).

Two UNetBlocks down (3 -> 64 -> 128, a 2x2 max-pool between), a bilinear
align-corners upsample back, a skip concat, two blocks up (192 -> 64 -> 32),
a 1x1 head and ``sigmoid * 10``. Named as the example notebook's module
(enc1, enc2, dec2, dec1, final), the grammar that
mde_tpu/train/torch_import.py::map_simple_unet_key reads.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import BatchNorm, Conv
from ..ops.resize import resize_bilinear


class UNetBlock(nn.Module):
    """(conv3x3, BN, ReLU) twice."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, 1, 1)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, 1, 1)
        self.bn2 = BatchNorm(features)

    def forward(self, x):
        return F.relu(self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x))))))


class SimpleUNet(nn.Module):
    """forward(x (B, 3, H, W) normalised RGB) -> (B, H, W) depth in (0, 10)."""

    DEAD_KEY_PREFIXES = ()

    def __init__(self):
        super().__init__()
        self.enc1 = UNetBlock(3, 64)
        self.enc2 = UNetBlock(64, 128)
        self.dec2 = UNetBlock(192, 64)
        self.dec1 = UNetBlock(64, 32)
        self.final = Conv(32, 1, 1)

    def forward(self, x, plain: bool = False):
        """No kernel runs here: ``plain`` is taken for the common signature."""
        enc1 = self.enc1(x)
        h = self.enc2(F.max_pool2d(enc1, 2, 2))
        h = resize_bilinear(h, enc1.shape[-2:], align_corners=True)
        h = self.dec1(self.dec2(torch.cat([h, enc1], dim=1)))
        return (torch.sigmoid(self.final(h)) * 10.0)[:, 0]
