"""ResNetV2-50 stem of DPT_Hybrid's ViT-Hybrid backbone (port of
mde_tpu/nn/resnetv2.py; timm vit_base_r50_s16_384).

Weight-standardised convs (eps 1e-6 inside the standardisation) with TF SAME
asymmetric padding, GroupNorm(32, eps 1e-5), a 'same' stem with a TF SAME
max-pool, and pre-activation bottlenecks in stages of (3, 4, 9). Its stage-1
and stage-2 outputs (256 and 512 channels at /4 and /8) are DPT's first two
levels; the /16 stage feeds the ViT's 1x1 patch embedding. Named as timm's
ResNetV2 (``stem.{conv,norm}``, ``stages.i.blocks.j.{norm1,conv1,norm2,conv2,
norm3,conv3,downsample.conv}``), the grammar of
mde_tpu/train/torch_import.py::_map_resnetv2_key.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .efficientnet import Conv2dSame, tf_same_pad


class StdConv(Conv2dSame):
    """Conv2dSame over the standardised weight: each output filter less its
    mean, over sqrt(its biased variance + 1e-6); no bias."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, bias=False)

    def forward(self, x):
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), unbiased=False, keepdim=True)
        return self._same(x, (self.weight - mean) / torch.sqrt(var + 1e-6))


def GroupNorm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-5)


class PreactBottleneck(nn.Module):
    """gn1-relu, then 1x1, gn2-relu, 3x3 (stride here), gn3-relu, 1x1 to
    planes * 4; the shortcut a strided 1x1 of the pre-activation where the
    shape changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.norm1 = GroupNorm(cin)
        self.conv1 = StdConv(cin, planes, 1)
        self.norm2 = GroupNorm(planes)
        self.conv2 = StdConv(planes, planes, 3, stride)
        self.norm3 = GroupNorm(planes)
        self.conv3 = StdConv(planes, out, 1)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Module()
            self.downsample.conv = StdConv(cin, out, 1, stride)

    def forward(self, x):
        h = F.relu(self.norm1(x))
        shortcut = x if self.downsample is None else self.downsample.conv(h)
        h = F.relu(self.norm2(self.conv1(h)))
        h = F.relu(self.norm3(self.conv2(h)))
        return self.conv3(h) + shortcut


class ResNetV2Stem(nn.Module):
    """forward(x) -> (stage 1 /4 256 ch, stage 2 /8 512 ch, final /16 1024 ch)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 9)):
        super().__init__()
        self.stem = nn.Module()
        self.stem.conv = StdConv(3, 64, 7, 2)
        self.stem.norm = GroupNorm(64)
        self.stages = nn.ModuleList()
        cin = 64
        for si, depth in enumerate(layers):
            planes = 64 * 2**si
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                PreactBottleneck(cin if bi == 0 else planes * 4, planes,
                                 2 if (si > 0 and bi == 0) else 1) for bi in range(depth))
            self.stages.append(stage)
            cin = planes * 4

    def forward(self, x):
        h = F.relu(self.stem.norm(self.stem.conv(x)))
        h = F.max_pool2d(tf_same_pad(h, 3, 2, value=float("-inf")), 3, 2)  # MaxPool2dSame
        feats = []
        for stage in self.stages:
            for blk in stage.blocks:
                h = blk(h)
            feats.append(h)
        return tuple(feats)
