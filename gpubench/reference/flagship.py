"""Plain PyTorch reference of the flagship, MidasNetSemantics (MiDaS v2.1 small
with a frozen DINOv2 ViT-S/14 fused through windowed cross-attention).

A frozen copy of the test suite's reference rebuild (``tests/torch_flagship_ref.py``),
kept here so that the benchmark's yardstick does not move with the test suite.
Its ``state_dict()`` has the key grammar of a reference MidasNetSemantics
checkpoint (src/network/midas_semantics.py:153-205, gen-efficientnet's
``pretrained.layer*`` slicing, the Dinov2Head of src/network/dpt_depth.py:32-153
and facebookresearch/dinov2's ViT names), which is the grammar of the
program's ``state_dict()`` too, so one set of weights loads into both.

It imports nothing of the program. Where it departs from the reference code:
- the windowed cross-attention takes clean rectangular windows, batched, in
  place of the reference's overlapping flat-slice loop;
- DINOv2's pos-embed is resized off its 37x37 grid as the hub's
  ``interpolate_pos_encoding`` does it: bicubic, ``interpolate_offset`` 0.1
  folded into the scale factor.
``dinov2_image_size`` is where the DINOv2 branch runs (224x280 in the
flagship); the benchmark's CPU tests shrink it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# gen-efficientnet tf_efficientnet_lite3 (TF-SAME padding, exact naming)
# ---------------------------------------------------------------------------


def _tf_pad(x, k: int, s: int):
    ih, iw = x.shape[-2:]
    ph = max(k - s, 0) if ih % s == 0 else max(k - ih % s, 0)
    pw = max(k - s, 0) if iw % s == 0 else max(k - iw % s, 0)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


class Conv2dSame(nn.Conv2d):
    """gen-efficientnet's Conv2dSame: TF asymmetric SAME padding."""

    def forward(self, x):
        x = _tf_pad(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation, self.groups)


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-3)  # tf_ variants use TF eps


class DepthwiseSeparableConv(nn.Module):
    """Stage-0 block (expand==1): conv_dw/bn1/conv_pw/bn2 naming."""

    def __init__(self, cin, cout, k, s):
        super().__init__()
        self.conv_dw = Conv2dSame(cin, cin, k, s, groups=cin, bias=False)
        self.bn1 = _bn(cin)
        self.conv_pw = Conv2dSame(cin, cout, 1, bias=False)
        self.bn2 = _bn(cout)
        self.residual = s == 1 and cin == cout

    def forward(self, x):
        h = F.relu6(self.bn1(self.conv_dw(x)))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class InvertedResidual(nn.Module):
    """conv_pw/bn1/conv_dw/bn2/conv_pwl/bn3 naming (lite: ReLU6, no SE)."""

    def __init__(self, cin, cout, k, s, e):
        super().__init__()
        mid = cin * e
        self.conv_pw = Conv2dSame(cin, mid, 1, bias=False)
        self.bn1 = _bn(mid)
        self.conv_dw = Conv2dSame(mid, mid, k, s, groups=mid, bias=False)
        self.bn2 = _bn(mid)
        self.conv_pwl = Conv2dSame(mid, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.residual = s == 1 and cin == cout

    def forward(self, x):
        h = F.relu6(self.bn1(self.conv_pw(x)))
        h = F.relu6(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


_B0_STAGES = (  # (expand, channels, repeats, stride, kernel)
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
)


def _round_filters(f, w, d=8):
    f *= w
    new = max(d, int(f + d / 2) // d * d)
    if new < 0.9 * f:
        new += d
    return int(new)


class EffnetLite3Sliced(nn.Module):
    """layer1..layer4 Sequential slicing of src/network/blocks.py:176-186."""

    def __init__(self, width=1.2, depth=1.4):
        super().__init__()
        stages = []
        cin = 32
        for si, (e, c, r, s, k) in enumerate(_B0_STAGES):
            cout = _round_filters(c, width)
            reps = r if si in (0, 6) else int(math.ceil(r * depth))
            blocks = []
            for bi in range(reps):
                stride = s if bi == 0 else 1
                if e == 1:
                    blocks.append(DepthwiseSeparableConv(cin, cout, k, stride))
                else:
                    blocks.append(InvertedResidual(cin, cout, k, stride, e))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        stem = Conv2dSame(3, 32, 3, 2, bias=False)
        self.layer1 = nn.Sequential(stem, _bn(32), nn.ReLU6(True), stages[0], stages[1])
        self.layer2 = nn.Sequential(stages[2])
        self.layer3 = nn.Sequential(stages[3], stages[4])
        self.layer4 = nn.Sequential(stages[5], stages[6])

    def forward(self, x):
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        return l1, l2, l3, l4


# ---------------------------------------------------------------------------
# MiDaS decoder blocks (reference blocks.py naming)
# ---------------------------------------------------------------------------


class ResidualConvUnit_custom(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1, bias=True)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=True)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        out = self.conv2(F.relu(out))
        return out + x


class FeatureFusionBlock_custom(nn.Module):
    def __init__(self, features, expand=False):
        super().__init__()
        out_features = features // 2 if expand else features
        self.resConfUnit1 = ResidualConvUnit_custom(features)
        self.resConfUnit2 = ResidualConvUnit_custom(features)
        self.out_conv = nn.Conv2d(features, out_features, 1, bias=True)

    def forward(self, *xs, size=None):
        out = xs[0]
        if len(xs) == 2:
            out = out + self.resConfUnit1(xs[1])
        out = self.resConfUnit2(out)
        if size is None:
            out = F.interpolate(out, scale_factor=2, mode="bilinear", align_corners=True)
        else:
            out = F.interpolate(out, size=size, mode="bilinear", align_corners=True)
        return self.out_conv(out)


class _Scratch(nn.Module):
    """Attribute container matching the reference's scratch namespace."""


# ---------------------------------------------------------------------------
# DINOv2 ViT-S/14 (facebookresearch/dinov2 naming; LayerScale, fused qkv)
# ---------------------------------------------------------------------------


class _Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim, bias=True)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = torch.softmax(logits * hd**-0.5, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v.float()).reshape(b, n, c)
        return self.proj(out.to(x.dtype))


class _LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        return x * self.gamma


class _Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.ls1 = _LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, 4 * dim)
        self.ls2 = _LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, dim, patch):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)

    def forward(self, x):
        return self.proj(x)


class DinoVisionTransformer(nn.Module):
    """get_intermediate_layers(n=4, norm=True, patch tokens only) semantics."""

    def __init__(self, dim=384, depth=12, heads=6, patch=14, pos_grid=(37, 37)):
        super().__init__()
        self.patch, self.pos_grid = patch, pos_grid
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid[0] * pos_grid[1] + 1, dim))
        self.mask_token = nn.Parameter(torch.zeros(1, dim))  # unused (MIM only)
        self.patch_embed = _PatchEmbed(dim, patch)
        self.blocks = nn.ModuleList([_Block(dim, heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def get_intermediate_layers(self, x, n=4):
        b, _, h, w = x.shape
        ph, pw = h // self.patch, w // self.patch
        t = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, ph*pw, C)
        cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (ph, pw) != tuple(self.pos_grid):
            # hub interpolate_pos_encoding: bicubic, interpolate_offset=0.1
            # passed as scale_factor (antialias=False)
            grid = patch_pos.reshape(1, *self.pos_grid, -1).permute(0, 3, 1, 2)
            sx = float(ph + 0.1) / self.pos_grid[0]
            sy = float(pw + 0.1) / self.pos_grid[1]
            grid = F.interpolate(
                grid, scale_factor=(sx, sy), mode="bicubic", antialias=False
            )
            if grid.shape[-2:] != (ph, pw):
                raise ValueError(f"pos-embed resized to {tuple(grid.shape[-2:])}, not {(ph, pw)}")
            patch_pos = grid.permute(0, 2, 3, 1).reshape(1, ph * pw, -1)
        t = t + patch_pos
        cls = (self.cls_token + cls_pos).expand(b, -1, -1)
        t = torch.cat([cls, t], dim=1)
        outs = []
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i >= len(self.blocks) - n:
                outs.append(t)
        return [self.norm(o)[:, 1:] for o in outs]


# ---------------------------------------------------------------------------
# Dinov2Head (dpt_depth.py:32-153 naming, nclass=1)
# ---------------------------------------------------------------------------


class Dinov2Head(nn.Module):
    def __init__(self, in_channels=384, features=128, out_channels=(128, 256, 512, 512)):
        super().__init__()
        self.projects = nn.ModuleList(
            [nn.Conv2d(in_channels, c, 1) for c in out_channels]
        )
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(out_channels[0], out_channels[0], 4, 4, 0),
            nn.ConvTranspose2d(out_channels[1], out_channels[1], 2, 2, 0),
            nn.Identity(),
            nn.Conv2d(out_channels[3], out_channels[3], 3, 2, 1),
        ])
        self.scratch = _Scratch()
        for i, c in enumerate(out_channels):
            self.scratch.add_module(f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, 1, 1, bias=False))
        for i in range(1, 5):
            self.scratch.add_module(f"refinenet{i}", FeatureFusionBlock_custom(features, expand=False))
        self.scratch.output_conv1 = nn.Conv2d(features, features // 2, 3, 1, 1)
        self.scratch.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(True), nn.Identity()
        )

    def forward(self, taps, ph, pw):
        outs = []
        for i, t in enumerate(taps):
            g = t.permute(0, 2, 1).reshape(t.shape[0], t.shape[-1], ph, pw)
            outs.append(self.resize_layers[i](self.projects[i](g)))
        l1 = self.scratch.layer1_rn(outs[0])
        l2 = self.scratch.layer2_rn(outs[1])
        l3 = self.scratch.layer3_rn(outs[2])
        l4 = self.scratch.layer4_rn(outs[3])
        p4 = self.scratch.refinenet4(l4, size=l3.shape[2:])
        p3 = self.scratch.refinenet3(p4, l3, size=l2.shape[2:])
        p2 = self.scratch.refinenet2(p3, l2, size=l1.shape[2:])
        p1 = self.scratch.refinenet1(p2, l1)
        out = self.scratch.output_conv1(p1)
        out = F.interpolate(out, (ph * 14, pw * 14), mode="bilinear", align_corners=True)
        return self.scratch.output_conv2(out)


# ---------------------------------------------------------------------------
# CrossAttention (midas_semantics.py:14-127 naming; rectangular windows)
# ---------------------------------------------------------------------------


class CrossAttention(nn.Module):
    def __init__(self, dim, num_heads=8, window_size=16):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.norm_q = nn.LayerNorm(dim)
        self.norm_k = nn.LayerNorm(dim)
        self.norm_v = nn.LayerNorm(dim)
        self.q = nn.Linear(dim, dim, bias=False)
        self.k = nn.Linear(dim, dim, bias=False)
        self.v = nn.Linear(dim, dim, bias=False)
        self.norm_out = nn.LayerNorm(dim)
        self.proj = nn.Linear(dim, dim)
        self.spatial_reduction = nn.Sequential(
            nn.Conv2d(dim, dim, 3, 2, 1), nn.BatchNorm2d(dim), nn.ReLU(True),
            nn.Conv2d(dim, dim, 3, 2, 1), nn.BatchNorm2d(dim), nn.ReLU(True),
            nn.Conv2d(dim, dim, 3, 2, 1), nn.BatchNorm2d(dim), nn.ReLU(True),
        )
        self.spatial_upsample = nn.Sequential(
            nn.ConvTranspose2d(dim, dim, 4, 2, 1), nn.BatchNorm2d(dim), nn.ReLU(True),
            nn.ConvTranspose2d(dim, dim, 4, 2, 1), nn.BatchNorm2d(dim), nn.ReLU(True),
            nn.ConvTranspose2d(dim, dim, 4, 2, 1), nn.BatchNorm2d(dim), nn.ReLU(True),
        )

    def forward(self, x, context):
        b, c, H, W = x.shape
        xr = self.spatial_reduction(x)
        cr = self.spatial_reduction(context)
        h, w = xr.shape[2:]
        ws = self.window_size
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        xr = F.pad(xr, (0, wp - w, 0, hp - h))
        cr = F.pad(cr, (0, wp - w, 0, hp - h))

        def windows(t):  # (B,C,Hp,Wp) -> (B, N, T, C)
            t = t.reshape(b, c, hp // ws, ws, wp // ws, ws)
            return t.permute(0, 2, 4, 3, 5, 1).reshape(b, -1, ws * ws, c)

        q = self.q(self.norm_q(windows(xr)))
        k = self.k(self.norm_k(windows(cr)))
        v = self.v(self.norm_v(windows(cr)))
        hd = c // self.num_heads

        def split(t):
            return t.reshape(b, t.shape[1], t.shape[2], self.num_heads, hd)

        logits = torch.einsum("bnqhd,bnkhd->bnhqk", split(q).float(), split(k).float())
        # mask padded keys
        valid = torch.zeros(hp, wp, dtype=torch.bool, device=logits.device)
        valid[:h, :w] = True
        vw = valid.reshape(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
        logits = logits.masked_fill(~vw[None, :, None, None, :], torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits * hd**-0.5, dim=-1)
        o = torch.einsum("bnhqk,bnkhd->bnqhd", attn, split(v).float())
        o = o.reshape(b, -1, ws * ws, c).to(x.dtype)
        o = self.proj(self.norm_out(o))
        o = o.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 5, 1, 3, 2, 4)
        o = o.reshape(b, c, hp, wp)[:, :, :h, :w]
        return self.spatial_upsample(o)[:, :, :H, :W] + x


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.shortcut = nn.Sequential()
        if stride != 1 or cin != cout:
            self.shortcut = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout)
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        out = out + self.shortcut(x)
        return F.relu(out)


# ---------------------------------------------------------------------------
# The flagship
# ---------------------------------------------------------------------------


class MidasNetSemanticsTorch(nn.Module):
    """Post-surgery flagship with reference state_dict key grammar."""

    def __init__(self, features=64, dinov2_image_size=(224, 280)):
        super().__init__()
        self.dinov2_image_size = tuple(dinov2_image_size)
        self.pretrained = EffnetLite3Sliced()
        self.scratch = _Scratch()
        chans = (32, 48, 136, 384)
        mults = (1, 2, 4, 8)
        for i, (c, m) in enumerate(zip(chans, mults)):
            self.scratch.add_module(
                f"layer{i + 1}_rn", nn.Conv2d(c, features * m, 3, 1, 1, bias=False)
            )
        self.scratch.refinenet4 = FeatureFusionBlock_custom(features * 8, expand=True)
        self.scratch.refinenet3 = FeatureFusionBlock_custom(features * 4, expand=True)
        self.scratch.refinenet2 = FeatureFusionBlock_custom(features * 2, expand=True)
        self.scratch.refinenet1 = FeatureFusionBlock_custom(features, expand=False)
        # output_conv after the surgery [0:4]+[6:] (midas_semantics.py:159-163)
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, 1, 1),
            nn.Identity(),  # Interpolate(scale_factor=2) — applied in forward
            nn.Conv2d(features // 2, 32, 3, 1, 1),
            nn.ReLU(False),
            nn.Identity(),
        )
        self.dinov2 = DinoVisionTransformer()
        for p in self.dinov2.parameters():
            p.requires_grad = False
        self.dinov2_head = Dinov2Head(384, 128, (128, 256, 512, 512))
        self.cross_attention = CrossAttention(features // 2, window_size=16)
        self.fusion_blocks = nn.Sequential(ResidualBlock(features, features))
        self.fusion_head = nn.Sequential(
            ResidualBlock(features, features // 2),
            nn.Conv2d(features // 2, features // 2, 3, 1, 1),
            nn.BatchNorm2d(features // 2),
            nn.ReLU(True),
        )
        self.depth_head = nn.Sequential(
            ResidualBlock(features // 2, features // 4),
            nn.Conv2d(features // 4, 1, 3, 1, 1),
            nn.ReLU(True),
        )

    def forward(self, x):
        l1, l2, l3, l4 = self.pretrained(x)
        r1 = self.scratch.layer1_rn(l1)
        r2 = self.scratch.layer2_rn(l2)
        r3 = self.scratch.layer3_rn(l3)
        r4 = self.scratch.layer4_rn(l4)
        p4 = self.scratch.refinenet4(r4)
        p3 = self.scratch.refinenet3(p4, r3)
        p2 = self.scratch.refinenet2(p3, r2)
        p1 = self.scratch.refinenet1(p2, r1)
        h = self.scratch.output_conv[0](p1)
        h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=False)
        midas = F.relu(self.scratch.output_conv[2](h))

        dh, dw = self.dinov2_image_size
        xd = F.interpolate(x, (dh, dw), mode="bilinear", align_corners=True)
        taps = self.dinov2.get_intermediate_layers(xd, 4)
        dino = self.dinov2_head(taps, dh // 14, dw // 14)
        dino = F.interpolate(dino, midas.shape[2:], mode="bilinear", align_corners=True)

        att = self.cross_attention(midas, dino)
        fused = self.fusion_blocks(torch.cat([att, midas], dim=1))
        feats = self.fusion_head(fused)
        depth = self.depth_head(feats)
        return depth.squeeze(1)


def build(features: int = 64, dinov2_image_size=(224, 280)) -> MidasNetSemanticsTorch:
    """The flagship reference, its DINOv2 branch frozen as the flagship's is."""
    return MidasNetSemanticsTorch(features, tuple(dinov2_image_size))
