"""MidasNetSmall, the MiDaS-small model (port of mde_tpu/models/midas_small.py).

EfficientNet-Lite3 encoder (``pretrained``); 3x3 reassemble convs expanding to
features * (1, 2, 4, 8); optional DGR edge sharpening on them
(``use_dgr``, src/network/midas_net_custom.py:14-43); four
FeatureFusionBlockCustom refinenets (no BN, align_corners=True, expand on
4..2); then the head ``scratch.output_conv`` (the reference's indices 0, 2 and
4): conv64->32, a 2x half-pixel upsample, conv32->32, ReLU, 1x1 -> 1, ReLU.
``use_lb`` puts the LocalBins metric head over [depth, layer_4_rn, path_4,
path_3, path_2, path_1] (midas_net_custom.py:115-132).

``head_32`` stops the head before its final 1x1, as MidasNetSemantics does
to the reference (src/network/midas_semantics.py:159-163), and returns the
32-channel features with the decoder pyramid.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import Conv, FeatureFusionBlockCustom, ScratchConvs, interpolate
from ..nn.registry import encoder_channels, make_encoder
from .localbins import LocalBinsBlock

_LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))

# The reference's DGR Laplacian taps (constants rebuilt in the model, which
# mde_tpu neither holds nor loads) and LogBinomial's buffers.
CONSTANT_KEY_PREFIXES = (
    *(f"dgr{i}.lap{j}." for i in range(1, 5) for j in (2, 3)),
    "local_bins.conditional_log_binomial.log_binomial_transform.",
)


class FixedDepthwise3x3(nn.Module):
    """A frozen depthwise 3x3 with constant taps (the reference's ``lapN``
    conv). The taps are a buffer named ``weight``, so the state_dict keeps the
    reference's key and no optimizer, DDP or parameter count sees them."""

    def __init__(self, channels: int, squared: bool):
        super().__init__()
        self.squared = squared
        self.register_buffer("weight", torch.empty(channels, 1, 3, 3))

    def init_leaves_(self, generator):
        taps = torch.tensor(_LAPLACIAN)
        self.weight.copy_((taps * taps if self.squared else taps).expand_as(self.weight))

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), padding=1, groups=x.shape[1])


class DGR(nn.Module):
    """Depth Gradient Refinement (midas_net_custom.py:14-43): the Laplacian
    pair, an SE-style recalibration (mean, 1x1 to c//8, exact GELU, 1x1 to 3c,
    sigmoid), a depthwise 3x3 over 3c channels; the first c channels plus x."""

    def __init__(self, c: int):
        super().__init__()
        self.lap2 = FixedDepthwise3x3(c, squared=False)
        self.lap3 = FixedDepthwise3x3(c, squared=True)
        # AdaptiveAvgPool2d(1), conv, GELU, conv, Sigmoid: weights at 1 and 3
        self.recalib = nn.Sequential(nn.AdaptiveAvgPool2d(1), Conv(3 * c, max(c // 8, 1), 1),
                                     nn.GELU(), Conv(max(c // 8, 1), 3 * c, 1), nn.Sigmoid())
        self.spatial = nn.Conv2d(3 * c, 3 * c, 3, 1, 1, groups=3 * c)

    def forward(self, x):
        f = torch.cat([x, self.lap2(x), self.lap3(x)], dim=1)
        f = self.spatial(f * self.recalib(f))
        return f[:, :x.shape[1]] + x


def dgr_blocks(module: nn.Module, features: int) -> None:
    """Add dgr1..dgr4 on the reassembled levels' widths to ``module``."""
    for i in range(4):
        module.add_module(f"dgr{i + 1}", DGR(features * 2**i))


class MidasNetSmall(nn.Module):
    """forward(x (B, 3, H, W)) -> (B, H, W) non-negative depth (metric depth
    with ``use_lb``); with ``head_32``, the (B, 32, H, W) features and the
    pyramid (layer_4_rn, path_4, path_3, path_2, path_1)."""

    DEAD_KEY_PREFIXES = ("scratch.refinenet4.resConfUnit1.", *CONSTANT_KEY_PREFIXES)

    def __init__(self, features: int = 64, backbone: str = "efficientnet_lite3",
                 head_32: bool = False, use_lb: bool = False, use_dgr: bool = False):
        super().__init__()
        f = features
        self.head_32, self.use_lb, self.use_dgr = head_32, use_lb, use_dgr
        self.pretrained = make_encoder(backbone)
        self.scratch = ScratchConvs(encoder_channels(backbone), f, expand=True)
        for i in (4, 3, 2, 1):
            self.scratch.add_module(
                f"refinenet{i}", FeatureFusionBlockCustom(f * 2 ** (i - 1), expand=i > 1))
        if use_dgr:
            dgr_blocks(self, f)
        # indices 1 (the Interpolate), 3 and 5 (ReLUs) hold no weights and are
        # applied in forward
        head = [Conv(f, f // 2, 3, 1, 1), nn.Identity(), Conv(f // 2, 32, 3, 1, 1)]
        if not head_32:
            head += [nn.ReLU(), Conv(32, 1, 1), nn.ReLU()]
        self.scratch.output_conv = nn.Sequential(*head)
        if use_lb:
            self.local_bins = LocalBinsBlock((8 * f, 4 * f, 2 * f, f, f))

    def forward(self, x, plain: bool = False):
        """No kernel runs here: ``plain`` is taken for the common signature."""
        rn = self.scratch(self.pretrained(x))
        if self.use_dgr:
            rn = [getattr(self, f"dgr{i + 1}")(r) for i, r in enumerate(rn)]
        l1, l2, l3, l4 = rn
        s = self.scratch
        path_4 = s.refinenet4(l4)
        path_3 = s.refinenet3(path_4, l3)
        path_2 = s.refinenet2(path_3, l2)
        path_1 = s.refinenet1(path_2, l1)
        # The reference's Interpolate(scale_factor=2) defaults to
        # align_corners=False (src/network/blocks.py:212).
        h = interpolate(s.output_conv[0](path_1), scale_factor=2, align_corners=False)
        h = F.relu(s.output_conv[2](h))
        pyramid = (l4, path_4, path_3, path_2, path_1)
        if self.head_32:
            return h, pyramid
        out = F.relu(s.output_conv[4](h))
        if self.use_lb:
            return self.local_bins([out, *pyramid], out[:, 0])
        return out[:, 0]
