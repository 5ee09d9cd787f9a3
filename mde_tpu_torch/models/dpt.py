"""DPT depth models, the ViT trunks (port of mde_tpu/models/dpt.py):
``vitl16_384`` (DPT_Large), ``vitb16_384`` and ``vitb_rn50_384``
(DPT_Hybrid).

- ViT: the raw token taps at the hook blocks, a readout per tap ("project":
  the class token folded in by Linear(2C -> C) and exact GELU; "add";
  "ignore"), unflattened, a 1x1 projection, then ConvTranspose 4x4/s4,
  ConvTranspose 2x2/s2, identity and a 3x3/s2 conv
  (src/network/backbones/utils.py:144-249).
- Hybrid: ResNetV2 stages 1-2 are levels 1-2; a 1x1 patch embedding of the /16
  stage feeds 12 ViT-B blocks, tapped at 8 and 11, reassembled as above
  (src/network/backbones/vit.py:120-205).

Then the fusion cascade at ``features`` with explicit ``size=`` targets
(dpt_depth.py:252-257) and the monocular head: conv to features / 2, a 2x
align-corners upsample (unlike MiDaS-small's head), conv to 32, ReLU, 1x1 to 1,
ReLU. Every attention block runs through K4.

Named as the reference's DPT (trunk ``pretrained.model``, reassembly
``pretrained.act_postprocess{1..4}`` with the readout at 0, the 1x1 at 3 and
the resize at 4, head ``scratch.output_conv`` at 0, 2 and 4), the grammar of
mde_tpu/train/torch_import.py::map_dpt_key. The other backbones of
``DPT_BACKBONE_HOOKS`` are ROADMAP.md's item 6.6 and raise.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import Conv, ConvTranspose, FeatureFusionBlockCustom, ScratchConvs, interpolate
from ..nn.resnetv2 import ResNetV2Stem
from ..nn.vit import VIT_CONFIGS, ViT

DPT_BACKBONE_HOOKS = {
    "next_vit_large_6m": (2, 6, 36, 39),
    "beitl16_512": (5, 11, 17, 23),
    "beitl16_384": (5, 11, 17, 23),
    "beitb16_384": (2, 5, 8, 11),
    "swin2l24_384": (1, 1, 17, 1),
    "swin2b24_384": (1, 1, 17, 1),
    "swin2t16_256": (1, 1, 5, 1),
    "swinl12_384": (1, 1, 17, 1),
    "levit_384": (3, 11, 21),
    "vitb_rn50_384": (0, 1, 8, 11),  # hybrid: ResNet stages, then ViT blocks
    "vitb16_384": (2, 5, 8, 11),
    "vitl16_384": (5, 11, 17, 23),
}

# The ported backbones' reassembly widths (mde_tpu/models/dpt.py:62-75).
DPT_BACKBONE_CHANNELS = {
    "vitb_rn50_384": (256, 512, 768, 768),
    "vitb16_384": (96, 192, 384, 768),
    "vitl16_384": (256, 512, 1024, 1024),
}

# The trunk's final norm: DPT taps raw block outputs and never reads it.
# refinenet4 is only ever called with one input.
DEAD_KEY_PREFIXES = ("pretrained.model.norm.", "scratch.refinenet4.resConfUnit1.")


class ProjectReadout(nn.Module):
    """Fold the class token into every patch token (backbones/utils.py:26-39)."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        cls = tokens[:, :1].expand_as(tokens[:, 1:])
        return self.project(torch.cat([tokens[:, 1:], cls], dim=-1))


class AddReadout(nn.Module):
    """backbones/utils.py:14-23."""

    def forward(self, tokens):
        return tokens[:, 1:] + tokens[:, :1]


class SliceReadout(nn.Module):
    """The "ignore" readout: the class token dropped."""

    def forward(self, tokens):
        return tokens[:, 1:]


_READOUTS = {"project": ProjectReadout, "add": lambda dim: AddReadout(),
             "ignore": lambda dim: SliceReadout()}


def _postprocess(readout: str, dim: int, cout: int, level: int) -> nn.Sequential:
    """act_postprocess{level + 1}: readout, (transpose, unflatten: no weights,
    applied in forward), 1x1 projection, then the level's resize: 4x and 2x
    transposed convs, none, a stride-2 conv."""
    layers = [_READOUTS[readout](dim), nn.Identity(), nn.Identity(), Conv(dim, cout, 1)]
    if level < 2:
        layers.append(ConvTranspose(cout, cout, 4 // (level + 1), 4 // (level + 1), 0))
    elif level == 3:
        layers.append(Conv(cout, cout, 3, 2, 1))
    return nn.Sequential(*layers)


class HybridEmbed(nn.Module):
    """timm's HybridEmbed: the ResNetV2 stem (``backbone``) and a 1x1
    projection (``proj``) of its /16 stage to the token width."""

    def __init__(self, dim: int):
        super().__init__()
        self.backbone = ResNetV2Stem()
        self.proj = nn.Conv2d(1024, dim, 1)


class DPTDepthModel(nn.Module):
    """forward(x (B, 3, H, W), H and W multiples of 16) -> (B, H, W) depth."""

    DEAD_KEY_PREFIXES = DEAD_KEY_PREFIXES

    def __init__(self, backbone: str = "vitl16_384", features: int = 256,
                 readout: str = "project"):
        super().__init__()
        if backbone not in DPT_BACKBONE_CHANNELS:
            raise NotImplementedError(
                f"DPT backbone {backbone!r} is not ported to mde_tpu_torch yet (ROADMAP.md, "
                f"Queue 1, item 6.6); ported: {sorted(DPT_BACKBONE_CHANNELS)}")
        self.hybrid = backbone == "vitb_rn50_384"
        self.hooks = DPT_BACKBONE_HOOKS[backbone]
        out_channels = DPT_BACKBONE_CHANNELS[backbone]
        self.pretrained = nn.Module()
        self.pretrained.model = ViT("vitb16_384" if self.hybrid else backbone)
        dim = VIT_CONFIGS["vitb16_384" if self.hybrid else backbone][0]
        if self.hybrid:
            self.pretrained.model.patch_embed = HybridEmbed(dim)
        # the hybrid's levels 1-2 are ResNet stages: no act_postprocess1/2 weights
        for level in (2, 3) if self.hybrid else (0, 1, 2, 3):
            setattr(self.pretrained, f"act_postprocess{level + 1}",
                    _postprocess(readout, dim, out_channels[level], level))
        self.scratch = ScratchConvs(out_channels, features, expand=False)
        for i in (1, 2, 3, 4):
            self.scratch.add_module(f"refinenet{i}", FeatureFusionBlockCustom(features))
        # indices 1 (the Interpolate), 3 and 5 (ReLUs) hold no weights
        self.scratch.output_conv = nn.Sequential(
            Conv(features, features // 2, 3, 1, 1), nn.Identity(),
            Conv(features // 2, 32, 3, 1, 1), nn.ReLU(), Conv(32, 1, 1), nn.ReLU())

    def _levels(self, x, plain: bool):
        vit = self.pretrained.model
        if self.hybrid:
            s1, s2, final = vit.patch_embed.backbone(x)
            grid = vit.patch_embed.proj(final)
            taps = vit.forward_grid(grid, out_indices=self.hooks[2:], plain=plain, raw_taps=True)
            levels, first = [s1, s2], 2
        else:
            grid = vit.patch_embed(x)
            taps = vit.forward_grid(grid, out_indices=self.hooks, plain=plain, raw_taps=True)
            levels, first = [], 0
        b, _, gh, gw = grid.shape
        for level, tokens in enumerate(taps, start=first):
            post = getattr(self.pretrained, f"act_postprocess{level + 1}")
            t = post[0](tokens).transpose(1, 2).reshape(b, -1, gh, gw)
            for m in list(post)[3:]:
                t = m(t)
            levels.append(t)
        return levels

    def forward(self, x, plain: bool = False):
        """``plain=True`` runs K4's plain version on any device."""
        l1, l2, l3, l4 = self.scratch(self._levels(x, plain))
        s = self.scratch
        path_4 = s.refinenet4(l4, size=l3.shape[-2:])
        path_3 = s.refinenet3(path_4, l3, size=l2.shape[-2:])
        path_2 = s.refinenet2(path_3, l2, size=l1.shape[-2:])
        path_1 = s.refinenet1(path_2, l1)
        # DPT's head upsamples with align_corners=True (dpt_depth.py:277-285)
        h = interpolate(s.output_conv[0](path_1), scale_factor=2, align_corners=True)
        h = F.relu(s.output_conv[2](h))
        return F.relu(s.output_conv[4](h))[:, 0]
