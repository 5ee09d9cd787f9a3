"""Building blocks of the MiDaS decoders (port of mde_tpu/nn/blocks.py).

PyTorch layers in NCHW, named in the reference checkpoint's key grammar
(src/network/blocks.py), so a module's ``state_dict()`` is a reference
``.pth``. ``Conv``/``ConvTranspose``/``BatchNorm``/``LayerNorm`` build the
torch layers with the reference's padding and epsilons; ``init_weights_``
gives every parameter and buffer a value from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear


def Conv(cin: int, cout: int, kernel_size: int = 3, stride: int = 1, padding: int = 0,
         bias: bool = True) -> nn.Conv2d:
    """Conv2d with torch padding semantics: ``padding`` on each side."""
    return nn.Conv2d(cin, cout, kernel_size, stride, padding, bias=bias)


def ConvTranspose(cin: int, cout: int, kernel_size: int = 4, stride: int = 2,
                  padding: int = 1) -> nn.ConvTranspose2d:
    """ConvTranspose2d: out = (in - 1) * stride - 2 * padding + kernel_size.

    The JAX package flips its kernel to run the transpose as a dilated
    convolution (mde_tpu/nn/blocks.py:146-153); ConvTranspose2d needs no
    flip, only the (in, out, kh, kw) weight layout of a reference checkpoint.
    """
    return nn.ConvTranspose2d(cin, cout, kernel_size, stride, padding)


def BatchNorm(c: int, eps: float = 1e-5) -> nn.BatchNorm2d:
    """BatchNorm2d with torch defaults (eps 1e-5, momentum 0.1)."""
    return nn.BatchNorm2d(c, eps=eps)


def LayerNorm(c: int, eps: float = 1e-5) -> nn.LayerNorm:
    """LayerNorm over the last axis (1e-5 here; the ViT passes 1e-6)."""
    return nn.LayerNorm(c, eps=eps)


def interpolate(x, scale_factor=None, size=None, align_corners=False):
    """The reference's Interpolate module as a function (blocks.py:208-240)."""
    if size is None:
        size = (int(x.shape[-2] * scale_factor), int(x.shape[-1] * scale_factor))
    return resize_bilinear(x, size, align_corners=align_corners)


class ResidualConvUnit(nn.Module):
    """relu-conv3x3-relu-conv3x3 plus relu(x) (blocks.py:243-279): the
    reference's in-place ReLU rewrites its input, so the skip adds the
    ReLU'd input, as mde_tpu/nn/blocks.py:210-227 does."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features, 3, 1, 1)
        self.conv2 = Conv(features, features, 3, 1, 1)

    def forward(self, x):
        h = F.relu(x)
        return self.conv2(F.relu(self.conv1(h))) + h


class FeatureFusionBlock(nn.Module):
    """MidasNet's fusion block (blocks.py:282-314): the skip's RCU added to
    the input, an RCU, then a 2x align-corners upsample; no out conv.
    ``resConfUnit1`` exists on refinenet4 too, which is called with one input."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, *xs):
        output = xs[0]
        if len(xs) == 2:
            output = output + self.resConfUnit1(xs[1])
        return interpolate(self.resConfUnit2(output), scale_factor=2, align_corners=True)


class ResidualConvUnitCustom(nn.Module):
    """relu-conv3x3-relu-conv3x3 + x (blocks.py:319-376). The optional BN of
    the reference serves the DPT heads and comes with the zoo."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv(features, features, 3, 1, 1)
        self.conv2 = Conv(features, features, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlockCustom(nn.Module):
    """MiDaS-small fusion block (blocks.py:379-438).

    ``expand`` halves the channels in the 1x1 out conv; the upsample
    (align_corners=True) is 2x, or to ``size`` when given. ``resConfUnit1``
    exists even where the block is only ever called with one input
    (refinenet4), as in the reference, so the state_dict keeps its keys.
    """

    def __init__(self, features: int, expand: bool = False):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnitCustom(features)
        self.resConfUnit2 = ResidualConvUnitCustom(features)
        self.out_conv = Conv(features, features // 2 if expand else features, 1, 1, 0)

    def forward(self, *xs, size=None):
        output = xs[0]
        if len(xs) == 2:
            output = output + self.resConfUnit1(xs[1])
        output = self.resConfUnit2(output)
        output = interpolate(output, scale_factor=None if size else 2, size=size,
                             align_corners=True)
        return self.out_conv(output)


class ScratchConvs(nn.Module):
    """The per-level 3x3 reassemble convs of _make_scratch (blocks.py:133-163),
    ``layer{i}_rn``: ``features * (1, 2, 4, 8)`` channels when ``expand``,
    else ``features`` on every level. The owning model adds its refinenets
    and output convs to this module, as the reference's ``scratch`` holds them.
    """

    def __init__(self, in_channels: Sequence[int], features: int, expand: bool = False):
        super().__init__()
        for i, cin in enumerate(in_channels):
            mult = 2**i if expand else 1
            self.add_module(f"layer{i + 1}_rn", Conv(cin, features * mult, 3, 1, 1, bias=False))

    def forward(self, layers):
        return [getattr(self, f"layer{i + 1}_rn")(x) for i, x in enumerate(layers)]


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Give every parameter and buffer of ``model`` (on the CPU) a value.

    Convs (grouped ones too), transposed convs and Linears take torch's
    defaults (kaiming-uniform with a=sqrt(5), bias uniform in +-1/sqrt(fan_in));
    norms (batch, layer and group) are ones/zeros and BN running statistics
    0/1. A module with leaves of its own (the ViTs' tokens and pos-embed,
    LayerScale, DGR's Laplacian taps, LogBinomial's buffers) sets them in its
    ``init_leaves_``. Every
    draw comes from ``generator``, so a seed fixes the weights.
    """
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
            _uniform_(m.weight, math.sqrt(1.0 / fan_in) if fan_in else 0.0, generator)
            if m.bias is not None:
                _uniform_(m.bias, 1.0 / math.sqrt(fan_in) if fan_in else 0.0, generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        if hasattr(m, "init_leaves_"):
            m.init_leaves_(generator)
    return model
