"""MidasNetSemantics, the flagship model (port of mde_tpu/models/midas_semantics.py).

A MidasNetSmall trunk ending at 32-channel features, fused with a frozen
DINOv2 branch (run at 224x280, patch 14 -> 16x20 tokens) through a Dinov2Head
reassembly and a windowed cross-attention (8x spatially reduced, window 16),
then residual fusion blocks and a depth head. Submodules carry the reference
checkpoint's names (src/network/midas_semantics.py:153-205), which
mde_tpu/train/torch_import.py::map_midas_semantics_key reads, so
``state_dict()`` is a reference ``.pth``.

``use_lb`` puts the LocalBins metric head over [depth, layer_4_rn, path_4,
path_3, path_2, path_1] (midas_semantics.py:261-265). ``use_dgr`` is taken
and not applied, as in the reference and mde_tpu
(mde_tpu/models/midas_semantics.py:233-236): the reference's forward never
calls the DGR blocks its base class builds, so their keys are dead.

Differences from the JAX module: the frozen branch runs under
``torch.no_grad()`` (the JAX package uses stop_gradient), and ResidualBlock
runs its entry as two convs (the JAX ``merge_entry`` merges them for the TPU's
matrix unit; the parameters are the same either way).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import (BatchNorm, Conv, ConvTranspose, FeatureFusionBlockCustom, LayerNorm,
                         ScratchConvs)
from ..nn.vit import VIT_CONFIGS, ViT
from ..ops.resize import resize_bilinear
from ..ops.window_attention import windowed_cross_attention
from .midas_small import CONSTANT_KEY_PREFIXES, MidasNetSmall, dgr_blocks

# Keys of the reference grammar that no forward reads: refinenet4 is only ever
# called with one input, mask_token serves masked-image training only, and
# the DGR blocks of a use_dgr checkpoint are never called; and LogBinomial's
# constant buffers (mde_tpu neither holds nor loads them).
DEAD_KEY_PREFIXES = (
    "dinov2.mask_token",
    "scratch.refinenet4.resConfUnit1.",
    "dinov2_head.scratch.refinenet4.resConfUnit1.",
    *(f"dgr{i}." for i in range(1, 5)),
    *CONSTANT_KEY_PREFIXES,
)


class ResidualBlock(nn.Module):
    """conv-bn-relu-conv-bn + (1x1-bn shortcut), relu (midas_semantics.py:129-151)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.shortcut = nn.Sequential()
        if cin != features:
            self.shortcut = nn.Sequential(Conv(cin, features, 1, 1, 0, bias=False),
                                          BatchNorm(features))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + self.shortcut(x))


def _conv_bn_relu(conv: nn.Module, c: int) -> list[nn.Module]:
    return [conv, BatchNorm(c), nn.ReLU()]


class CrossAttention(nn.Module):
    """Windowed cross-attention with an 8x conv reduction and upsampling
    (midas_semantics.py:14-127). ``spatial_reduction`` is one module applied
    to both inputs, as in the reference."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 16):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.norm_q = LayerNorm(dim)
        self.norm_k = LayerNorm(dim)
        self.norm_v = LayerNorm(dim)
        self.q = nn.Linear(dim, dim, bias=False)
        self.k = nn.Linear(dim, dim, bias=False)
        self.v = nn.Linear(dim, dim, bias=False)
        self.norm_out = LayerNorm(dim)
        self.proj = nn.Linear(dim, dim)
        self.spatial_reduction = nn.Sequential(
            *(m for _ in range(3) for m in _conv_bn_relu(Conv(dim, dim, 3, 2, 1), dim)))
        self.spatial_upsample = nn.Sequential(
            *(m for _ in range(3) for m in _conv_bn_relu(ConvTranspose(dim, dim, 4, 2, 1), dim)))

    def forward(self, x, context, plain: bool = False):
        h, w = x.shape[-2:]
        x_r = self.spatial_reduction(x).permute(0, 2, 3, 1)  # (B, h/8, w/8, C)
        ctx_r = self.spatial_reduction(context).permute(0, 2, 3, 1)
        q = self.q(self.norm_q(x_r))
        k = self.k(self.norm_k(ctx_r))
        v = self.v(self.norm_v(ctx_r))
        out = windowed_cross_attention(q, k, v, self.num_heads, self.window_size, plain)
        out = self.proj(self.norm_out(out)).permute(0, 3, 1, 2)
        # The transposed convs restore exactly 8x; crop if the input was not
        # divisible by 8.
        return self.spatial_upsample(out)[:, :, :h, :w] + x


class Dinov2Head(nn.Module):
    """Token pyramid -> 32-channel dense features (src/network/dpt_depth.py:32-153).

    Four 1x1 projections with 4x/2x/identity/stride-2 resizes, a scratch and
    refinenet cascade at ``features`` channels, then output_conv1, a bilinear
    resize to (14 ph, 14 pw), output_conv2 and ReLU (its final 1x1 is commented
    out in the reference).
    """

    def __init__(self, in_channels: int = 384, features: int = 128,
                 out_channels=(128, 256, 512, 512)):
        super().__init__()
        oc = out_channels
        self.projects = nn.ModuleList([Conv(in_channels, c, 1, 1, 0) for c in oc])
        self.resize_layers = nn.ModuleList([
            ConvTranspose(oc[0], oc[0], 4, 4, 0),
            ConvTranspose(oc[1], oc[1], 2, 2, 0),
            nn.Identity(),
            Conv(oc[3], oc[3], 3, 2, 1),
        ])
        self.scratch = ScratchConvs(oc, features, expand=False)
        for i in (1, 2, 3, 4):
            self.scratch.add_module(f"refinenet{i}", FeatureFusionBlockCustom(features))
        self.scratch.output_conv1 = Conv(features, features // 2, 3, 1, 1)
        self.scratch.output_conv2 = nn.Sequential(Conv(features // 2, 32, 3, 1, 1), nn.ReLU())

    def forward(self, token_layers, patch_h: int, patch_w: int):
        outs = []
        for i, tokens in enumerate(token_layers):
            b, _, c = tokens.shape
            xm = tokens.transpose(1, 2).reshape(b, c, patch_h, patch_w)
            outs.append(self.resize_layers[i](self.projects[i](xm)))
        s = self.scratch
        l1, l2, l3, l4 = s(outs)
        path_4 = s.refinenet4(l4, size=l3.shape[-2:])
        path_3 = s.refinenet3(path_4, l3, size=l2.shape[-2:])
        path_2 = s.refinenet2(path_3, l2, size=l1.shape[-2:])
        path_1 = s.refinenet1(path_2, l1)
        out = s.output_conv1(path_1)
        out = resize_bilinear(out, (patch_h * 14, patch_w * 14), align_corners=True)
        return s.output_conv2(out)


class MidasNetSemantics(MidasNetSmall):
    """forward(x (B, 3, H, W)) -> (B, H, W) non-negative relative depth, or
    metric depth with ``use_lb``."""

    DEAD_KEY_PREFIXES = DEAD_KEY_PREFIXES

    def __init__(self, features: int = 64, backbone: str = "efficientnet_lite3",
                 dinov2_type: str = "dinov2_vits14", dinov2_image_size=(224, 280),
                 use_lb: bool = False, use_dgr: bool = False):
        super().__init__(features, backbone, head_32=True, use_lb=use_lb)
        f = features
        if use_dgr:
            dgr_blocks(self, f)  # dead: built, as the reference's base class does, never called
        self.dinov2_image_size = tuple(int(s) for s in dinov2_image_size)
        self.dinov2 = ViT(dinov2_type)
        self.dinov2.requires_grad_(False)
        self.dinov2_head = Dinov2Head(VIT_CONFIGS[dinov2_type][0], 128)
        self.cross_attention = CrossAttention(f // 2)
        self.fusion_blocks = nn.Sequential(ResidualBlock(f, f))
        self.fusion_head = nn.Sequential(
            ResidualBlock(f, f // 2), *_conv_bn_relu(Conv(f // 2, f // 2, 3, 1, 1), f // 2))
        self.depth_head = nn.Sequential(
            ResidualBlock(f // 2, f // 4), Conv(f // 4, 1, 3, 1, 1), nn.ReLU())

    def forward(self, x, plain: bool = False):
        """``plain=True`` runs every kernel op's plain version (K4 in the
        DINOv2 branch, K1 in the cross-attention) on any device."""
        midas_features, pyramid = super().forward(x)
        dh, dw = self.dinov2_image_size
        patch = self.dinov2.patch
        with torch.no_grad():  # the DINOv2 branch is frozen
            x_d = resize_bilinear(x, (dh, dw), align_corners=True)
            token_layers = self.dinov2(x_d, n_layers=4, plain=plain)
        dinov2_features = self.dinov2_head(token_layers, dh // patch, dw // patch)
        dinov2_features = resize_bilinear(dinov2_features, midas_features.shape[-2:],
                                          align_corners=True)
        attended = self.cross_attention(midas_features, dinov2_features, plain)
        fused = self.fusion_blocks(torch.cat([attended, midas_features], dim=1))
        depth = self.depth_head(self.fusion_head(fused))
        if self.use_lb:
            return self.local_bins([depth, *pyramid], depth[:, 0])
        return depth[:, 0]
