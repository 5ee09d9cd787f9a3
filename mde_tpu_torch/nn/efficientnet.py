"""EfficientNet-Lite encoder, stage-sliced (port of mde_tpu/nn/efficientnet.py).

Named as gen-efficientnet's ``tf_efficientnet_lite*`` sliced into
``layer1..layer4`` Sequentials (src/network/blocks.py:176-186):

  layer1 = stem conv, bn, ReLU6, stages 1-2  -> 32 ch @ /4   (lite3)
  layer2 = stage 3                           -> 48 ch @ /8
  layer3 = stages 4-5                        -> 136 ch @ /16
  layer4 = stages 6-7                        -> 384 ch @ /32

Lite variants use ReLU6 and no squeeze-excite, and do not depth-scale the first
or last stage. The ``tf_`` prefix means TensorFlow SAME padding, asymmetric for
strided convs, which torch's symmetric conv padding cannot express: every conv
pads explicitly with ``F.pad``. TF batch norm eps is 1e-3.
"""

from __future__ import annotations

import math

import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm


def _round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def _tf_same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow SAME padding: asymmetric, extra pixel on the high side."""
    total = max(k - s, 0) if size % s == 0 else max(k - (size % s), 0)
    return total // 2, total - total // 2


def tf_same_pad(x, k: int, s: int, value: float = 0.0):
    """``x`` padded for a TF SAME window of ``k`` at stride ``s``."""
    top, bottom = _tf_same_pads(x.shape[-2], k, s)
    left, right = _tf_same_pads(x.shape[-1], k, s)
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv2dSame(nn.Conv2d):
    """Conv2d with TF SAME padding (gen-efficientnet's Conv2dSame)."""

    def forward(self, x):
        return self._same(x, self.weight)

    def _same(self, x, weight):
        x = tf_same_pad(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, weight, self.bias, self.stride, 0, self.dilation, self.groups)


def TFBatchNorm(c: int) -> nn.BatchNorm2d:
    """BN with TF-effnet eps 1e-3 (momentum 0.1, torch convention)."""
    return BatchNorm(c, eps=1e-3)


class DepthwiseSeparableConv(nn.Module):
    """Stage-1 block (expand 1): conv_dw/bn1/conv_pw/bn2."""

    def __init__(self, cin: int, cout: int, k: int, s: int):
        super().__init__()
        self.conv_dw = Conv2dSame(cin, cin, k, s, groups=cin, bias=False)
        self.bn1 = TFBatchNorm(cin)
        self.conv_pw = Conv2dSame(cin, cout, 1, bias=False)
        self.bn2 = TFBatchNorm(cout)
        self.residual = s == 1 and cin == cout

    def forward(self, x):
        h = F.relu6(self.bn1(self.conv_dw(x)))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class InvertedResidual(nn.Module):
    """Mobile inverted bottleneck, Lite flavour (ReLU6, no squeeze-excite):
    conv_pw/bn1/conv_dw/bn2/conv_pwl/bn3."""

    def __init__(self, cin: int, cout: int, k: int, s: int, expand: int):
        super().__init__()
        mid = cin * expand
        self.conv_pw = Conv2dSame(cin, mid, 1, bias=False)
        self.bn1 = TFBatchNorm(mid)
        self.conv_dw = Conv2dSame(mid, mid, k, s, groups=mid, bias=False)
        self.bn2 = TFBatchNorm(mid)
        self.conv_pwl = Conv2dSame(mid, cout, 1, bias=False)
        self.bn3 = TFBatchNorm(cout)
        self.residual = s == 1 and cin == cout

    def forward(self, x):
        h = F.relu6(self.bn1(self.conv_pw(x)))
        h = F.relu6(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


# Per-stage base config of EfficientNet-B0: (expand, channels, repeats, stride, kernel)
_B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width_mult, depth_mult) per lite variant
LITE_MULTIPLIERS = {
    "efficientnet_lite0": (1.0, 1.0),
    "efficientnet_lite1": (1.0, 1.1),
    "efficientnet_lite2": (1.1, 1.2),
    "efficientnet_lite3": (1.2, 1.4),
    "efficientnet_lite4": (1.4, 1.8),
}


def lite_stage_channels(variant: str) -> list[int]:
    """Output channels of the four sliced stages (lite3 -> [32, 48, 136, 384])."""
    width, _ = LITE_MULTIPLIERS[variant]
    ch = [_round_filters(c, width) for (_, c, _, _, _) in _B0_STAGES]
    return [ch[1], ch[2], ch[4], ch[6]]


class EfficientNetLite(nn.Module):
    """Stage-sliced encoder: forward(x) -> (layer1, layer2, layer3, layer4)."""

    def __init__(self, variant: str = "efficientnet_lite3"):
        super().__init__()
        width, depth = LITE_MULTIPLIERS[variant]
        stages, cin = [], 32  # Lite: fixed 32-ch stem
        for si, (expand, ch, repeats, stride, k) in enumerate(_B0_STAGES):
            cout = _round_filters(ch, width)
            # Lite: first and last stage keep their base repeat count.
            reps = repeats if si in (0, len(_B0_STAGES) - 1) else _round_repeats(repeats, depth)
            blocks = []
            for r in range(reps):
                s = stride if r == 0 else 1
                if expand == 1:
                    blocks.append(DepthwiseSeparableConv(cin, cout, k, s))
                else:
                    blocks.append(InvertedResidual(cin, cout, k, s, expand))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        stem = Conv2dSame(3, 32, 3, 2, bias=False)
        self.layer1 = nn.Sequential(stem, TFBatchNorm(32), nn.ReLU6(), stages[0], stages[1])
        self.layer2 = nn.Sequential(stages[2])
        self.layer3 = nn.Sequential(stages[3], stages[4])
        self.layer4 = nn.Sequential(stages[5], stages[6])

    def forward(self, x):
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return l1, l2, l3, self.layer4(l3)
