"""MidasNet, the full MiDaS v2.1 model (port of mde_tpu/models/midas_net.py).

ResNeXt101-32x8d encoder (``pretrained``), features=256 reassemble convs (no
expand), four plain FeatureFusionBlocks (an RCU and a 2x align-corners
upsample), and the v2.1 head ``scratch.output_conv``: conv256->128, a 2x
half-pixel upsample, conv128->32, ReLU, 1x1 -> 1, ReLU (the reference's
indices 0, 2 and 4; src/network/midas_net.py:12-76). The state_dict is a
midas_v21_384.pt's, the grammar of mde_tpu/train/torch_import.py::
map_midas_net_key.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import Conv, FeatureFusionBlock, ScratchConvs, interpolate
from ..nn.resnext import ResNetBackbone


class MidasNet(nn.Module):
    """forward(x (B, 3, H, W), H and W multiples of 32) -> (B, H, W) depth."""

    # refinenet4 is only ever called with one input
    DEAD_KEY_PREFIXES = ("scratch.refinenet4.resConfUnit1.",)

    def __init__(self, features: int = 256, encoder_layers=(3, 4, 23, 3)):
        super().__init__()
        self.pretrained = ResNetBackbone(encoder_layers)
        self.scratch = ScratchConvs((256, 512, 1024, 2048), features, expand=False)
        for i in (1, 2, 3, 4):
            self.scratch.add_module(f"refinenet{i}", FeatureFusionBlock(features))
        # indices 1 (the Interpolate), 3 and 5 (ReLUs) hold no weights
        self.scratch.output_conv = nn.Sequential(
            Conv(features, 128, 3, 1, 1), nn.Identity(), Conv(128, 32, 3, 1, 1), nn.ReLU(),
            Conv(32, 1, 1), nn.ReLU())

    def forward(self, x, plain: bool = False):
        """No kernel runs here: ``plain`` is taken for the common signature."""
        l1, l2, l3, l4 = self.scratch(self.pretrained(x))
        s = self.scratch
        path_4 = s.refinenet4(l4)
        path_3 = s.refinenet3(path_4, l3)
        path_2 = s.refinenet2(path_3, l2)
        path_1 = s.refinenet1(path_2, l1)
        h = interpolate(s.output_conv[0](path_1), scale_factor=2, align_corners=False)
        h = F.relu(s.output_conv[2](h))
        return F.relu(s.output_conv[4](h))[:, 0]
