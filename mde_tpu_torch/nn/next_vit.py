"""Next-ViT-Large trunk for DPT-Next-ViT (port of mde_tpu/nn/next_vit.py).

mde_tpu builds it from the Next-ViT paper (arXiv:2207.05501), because the
reference's own integration imports a module that does not exist:

- stem: four 3x3 ConvBNReLU (64, 32, 64, 64 channels, strides 2, 1, 1, 2) -> /4;
- stages of (96, 256, 512, 1024) channels at /4, /8, /16 and /32 with
  (3, 4, 30, 3) blocks; ``forward`` returns each stage's last output (the
  reference's hooks 2, 6, 36 and 39), NCHW;
- NCB: a 2x2 average-pool patch embedding where the stride or width
  changes, then multi-head conv attention (grouped 3x3 + BN + ReLU, 1x1 + BN)
  and a ConvFFN (1x1 to 3C + BN + ReLU, 1x1 + BN), each residual;
- NTB: a 1x1 projection to 3/4 of the width, E-MHSA over it (K and V
  average-pooled by sr 8, 4, 2, 1 by stage) residual, a 1x1 projection of
  that to the last quarter with an MHCA residual, the two concatenated, then
  a ConvFFN residual. Stages 2 and 4 end in one NTB, stage 3 has one every
  fifth block;
- BatchNorm everywhere.

No reference checkpoint grammar or import map exists for this model
(mde_tpu/train/torch_import.py has no Next-ViT entry), so the module names
are mde_tpu's (``stem{i}``, ``stage{s}_block{b}``, ``mhca.group_conv.conv``,
``emhsa.q`` ...), under the DPT's ``pretrained.model``;
``train/convert.py::state_dict_from_flax`` is the only bridge.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm, biased_attention

NEXT_VIT_LARGE_CHANNELS = (96, 256, 512, 1024)
_DEPTHS = (3, 4, 30, 3)
_SR_RATIO = (8, 4, 2, 1)
_HEAD_DIM = 32


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class MHCA(nn.Module):
    """Multi-head conv attention: grouped 3x3 + BN + ReLU, 1x1 + BN."""

    def __init__(self, c: int):
        super().__init__()
        self.group_conv = ConvBNReLU(c, c, 3, 1, max(c // _HEAD_DIM, 1))
        self.proj = nn.Conv2d(c, c, 1, bias=False)
        self.proj_bn = BatchNorm(c)

    def forward(self, x):
        return self.proj_bn(self.proj(self.group_conv(x)))


class ConvFFN(nn.Module):
    def __init__(self, c: int, ratio: int = 3):
        super().__init__()
        self.fc1 = ConvBNReLU(c, c * ratio, 1)
        self.fc2 = nn.Conv2d(c * ratio, c, 1, bias=False)
        self.fc2_bn = BatchNorm(c)

    def forward(self, x):
        return self.fc2_bn(self.fc2(self.fc1(x)))


class NCB(nn.Module):
    def __init__(self, cin: int, c: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        if stride == 2 or cin != c:
            self.patch_embed = nn.Conv2d(cin, c, 1, bias=False)
            self.patch_bn = BatchNorm(c)
        self.mhca = MHCA(c)
        self.ffn = ConvFFN(c)

    def forward(self, x):
        if hasattr(self, "patch_embed"):
            if self.stride == 2:
                x = F.avg_pool2d(x, 2)
            x = self.patch_bn(self.patch_embed(x))
        x = x + self.mhca(x)
        return x + self.ffn(x)


class EMHSA(nn.Module):
    """Efficient MHSA: K and V from the input average-pooled by ``sr_ratio``."""

    # under tensor parallelism (parallel/tensor.py): q, k and v hold this
    # rank's heads, and proj sums them
    tp_linears = {"q": "column", "k": "column", "v": "column", "proj": "row"}

    def __init__(self, c: int, sr_ratio: int = 1):
        super().__init__()
        self.sr_ratio = sr_ratio
        self.num_heads = max(c // _HEAD_DIM, 1)
        self.q = nn.Linear(c, c)
        self.k = nn.Linear(c, c)
        self.v = nn.Linear(c, c)
        self.proj = nn.Linear(c, c)

    def forward(self, x):
        b, c, h, w = x.shape
        hd = c // self.num_heads
        kv_in = F.avg_pool2d(x, self.sr_ratio) if self.sr_ratio > 1 else x

        q = self.q(x.flatten(2).transpose(1, 2))
        heads = q.shape[-1] // hd  # all, or this model rank's share
        q = q.reshape(b, h * w, heads, hd).transpose(1, 2)
        kv = kv_in.flatten(2).transpose(1, 2)
        k = self.k(kv).reshape(b, -1, heads, hd).transpose(1, 2)
        v = self.v(kv).reshape(b, -1, heads, hd).transpose(1, 2)
        out = biased_attention(q, k, v, scale=hd**-0.5).transpose(1, 2).reshape(b, h * w, -1)
        return self.proj(out).transpose(1, 2).reshape(b, c, h, w)


class NTB(nn.Module):
    def __init__(self, cin: int, c: int, sr_ratio: int = 1, stride: int = 1,
                 shrink: float = 0.75):
        super().__init__()
        self.stride = stride
        c_t = int(c * shrink)
        c_c = c - c_t
        self.proj1 = nn.Conv2d(cin, c_t, 1, bias=False)
        self.proj1_bn = BatchNorm(c_t)
        self.emhsa = EMHSA(c_t, sr_ratio)
        self.proj2 = nn.Conv2d(c_t, c_c, 1, bias=False)
        self.proj2_bn = BatchNorm(c_c)
        self.mhca = MHCA(c_c)
        self.ffn = ConvFFN(c)

    def forward(self, x):
        if self.stride == 2:
            x = F.avg_pool2d(x, 2)
        x1 = self.proj1_bn(self.proj1(x))
        x1 = x1 + self.emhsa(x1)
        x2 = self.proj2_bn(self.proj2(x1))
        x2 = x2 + self.mhca(x2)
        h = torch.cat([x1, x2], dim=1)
        return h + self.ffn(h)


class NextViT(nn.Module):
    """next_vit_large; forward(x (B, 3, H, W)) -> the four stage maps (96,
    256, 512 and 1024 channels), NCHW."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, s) in enumerate(zip((64, 32, 64, 64), (2, 1, 1, 2))):
            self.add_module(f"stem{i}", ConvBNReLU(cin, ch, 3, s))
            cin = ch
        self.stages = []
        for si, (ch, depth, sr) in enumerate(zip(NEXT_VIT_LARGE_CHANNELS, _DEPTHS, _SR_RATIO)):
            names = []
            for bi in range(depth):
                stride = 2 if (si > 0 and bi == 0) else 1
                # stage 3 has an NTB every fifth block, stages 2 and 4 end in
                # one, stage 1 is all convolution
                is_ntb = ((si == 1 and bi == depth - 1) or (si == 2 and bi % 5 == 4)
                          or (si == 3 and bi == depth - 1))
                block = (NTB(cin, ch, sr, stride) if is_ntb else NCB(cin, ch, stride))
                self.add_module(f"stage{si}_block{bi}", block)
                names.append(f"stage{si}_block{bi}")
                cin = ch
            self.stages.append(names)

    def forward(self, x):
        for i in range(4):
            x = getattr(self, f"stem{i}")(x)
        feats = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats
