"""ResNeXt101-32x8d encoder, stage-sliced for MidasNet (port of
mde_tpu/nn/resnext.py).

Named as the reference's ``_make_resnet_backbone`` (src/network/blocks.py:
189-199) over torchvision's ResNet: ``layer1`` = Sequential(conv1, bn1, relu,
maxpool, resnet.layer1), so the stem conv is ``layer1.0``, its BN
``layer1.1`` and stage 1's bottlenecks ``layer1.4.N``; ``layer2..4`` are the
other stages. Bottlenecks are torchvision's (conv1/bn1..conv3/bn3,
downsample.0/.1), with grouped 3x3 convs of width planes * base_width / 64 *
groups.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm, Conv


class Bottleneck(nn.Module):
    """1x1, grouped 3x3 (stride here), 1x1 to planes * 4, each with BN; the
    shortcut a strided 1x1 + BN where the shape changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1, groups: int = 32,
                 base_width: int = 8):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * 4
        self.conv1 = Conv(cin, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv(width, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(Conv(cin, out, 1, stride, bias=False), BatchNorm(out))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


def _stage(cin: int, planes: int, blocks: int, stride: int, groups: int,
           base_width: int) -> nn.Sequential:
    return nn.Sequential(*(Bottleneck(cin if i == 0 else planes * 4, planes,
                                      stride if i == 0 else 1, groups, base_width)
                           for i in range(blocks)))


class ResNetBackbone(nn.Module):
    """forward(x) -> (layer1 /4 256 ch, layer2 /8 512, layer3 /16 1024,
    layer4 /32 2048). ``layers=(3, 4, 23, 3)``, groups 32 and base width 8 are
    ResNeXt101-32x8d, the WSL checkpoint's architecture; fewer layers serve
    the tests (the blocks are the same)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), groups: int = 32,
                 base_width: int = 8):
        super().__init__()
        stages = [_stage(cin, planes, n, 1 if i == 0 else 2, groups, base_width)
                  for i, (cin, planes, n) in enumerate(zip((64, 256, 512, 1024),
                                                           (64, 128, 256, 512), layers))]
        self.layer1 = nn.Sequential(Conv(3, 64, 7, 2, 3, bias=False), BatchNorm(64), nn.ReLU(),
                                    nn.MaxPool2d(3, 2, 1), stages[0])
        self.layer2, self.layer3, self.layer4 = stages[1:]

    def forward(self, x):
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return l1, l2, l3, self.layer4(l3)
