"""DPT depth models over every trunk of ``DPT_BACKBONE_HOOKS`` (port of
mde_tpu/models/dpt.py).

- ViT (``vitb16_384``, ``vitl16_384``) and BEiT (``beitb16_384``,
  ``beitl16_384``, ``beitl16_512``): the raw token taps at the hook blocks, a
  readout per tap ("project": the class token folded in by Linear(2C -> C)
  and exact GELU; "add"; "ignore"), unflattened, a 1x1 projection, then
  ConvTranspose 4x4/s4, ConvTranspose 2x2/s2, identity and a 3x3/s2 conv
  (src/network/backbones/utils.py:144-249). ViT attention runs through K4;
  BEiT's carries a relative position bias and stays plain PyTorch.
- Hybrid (``vitb_rn50_384``, DPT_Hybrid): ResNetV2 stages 1-2 are levels 1-2;
  a 1x1 patch embedding of the /16 stage feeds 12 ViT-B blocks, tapped at 8
  and 11, reassembled as above (src/network/backbones/vit.py:120-205).
- Swin V1/V2 (``swinl12_384``, ``swin2l24_384``, ``swin2b24_384``,
  ``swin2t16_256``) and Next-ViT (``next_vit_large_6m``): the four stage maps
  feed the scratch convs directly.
- LeViT (``levit_384``): three levels at /16, /32 and /64, the cascade
  without refinenet4, and ``scratch.stem_transpose`` (two 3x3 stride-2
  transposed convs to features / 4 channels) after refinenet1
  (dpt_depth.py:219-222).

LeViT's bias tables, and a Swin V1 table whose stage grid is smaller than its
window, are sized for ``input_size`` (LeViT: 224x224 when None), as mde_tpu's
take their size from the input they are initialised at.

Then the fusion cascade at ``features`` with explicit ``size=`` targets
(dpt_depth.py:252-257) and the monocular head: conv to head_features_1 / 2, a
2x align-corners upsample (unlike MiDaS-small's head), conv to
head_features_2, ReLU, 1x1 to 1 and a ReLU where ``non_negative``
(``head_out_1=False`` stops before the 1x1 and returns the head_features_2
maps). dpt_levit_224 passes head_features_1=64 and head_features_2=8.

Named as the reference's DPT (trunk ``pretrained.model``, reassembly
``pretrained.act_postprocess{1..4}`` with the readout at 0, the 1x1 at 3 and
the resize at 4, head ``scratch.output_conv`` at 0, 2 and 4), the grammar of
mde_tpu/train/torch_import.py's DPT maps; each trunk's own names are in its
module (nn/vit.py, nn/beit.py, nn/swin.py, nn/levit.py, nn/next_vit.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.beit import BEIT_CONFIGS, BEiT
from ..nn.blocks import Conv, ConvTranspose, FeatureFusionBlockCustom, ScratchConvs, interpolate
from ..nn.levit import HOOKS as LEVIT_HOOKS
from ..nn.levit import LeViT, LevitAttention, StemB4Transpose
from ..nn.next_vit import NextViT
from ..nn.resnetv2 import ResNetV2Stem
from ..nn.swin import SwinBackbone, swin_stage_channels
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
    "levit_384": LEVIT_HOOKS,
    "vitb_rn50_384": (0, 1, 8, 11),  # hybrid: ResNet stages, then ViT blocks
    "vitb16_384": (2, 5, 8, 11),
    "vitl16_384": (5, 11, 17, 23),
}

# Each trunk's level widths (mde_tpu/models/dpt.py:62-75).
DPT_BACKBONE_CHANNELS = {
    "next_vit_large_6m": (96, 256, 512, 1024),
    "beitl16_512": (256, 512, 1024, 1024),
    "beitl16_384": (256, 512, 1024, 1024),
    "beitb16_384": (96, 192, 384, 768),
    "swin2l24_384": tuple(swin_stage_channels("swin2l24_384")),
    "swin2b24_384": tuple(swin_stage_channels("swin2b24_384")),
    "swin2t16_256": tuple(swin_stage_channels("swin2t16_256")),
    "swinl12_384": tuple(swin_stage_channels("swinl12_384")),
    "levit_384": (384, 512, 768),
    "vitb_rn50_384": (256, 512, 768, 768),
    "vitb16_384": (96, 192, 384, 768),
    "vitl16_384": (256, 512, 1024, 1024),
}

# refinenet4 is only ever called with one input; the ViTs' final norm is
# never read (DPT taps raw block outputs). A model adds its trunk's own
# (``DPTDepthModel._dead_keys``).
DEAD_KEY_PREFIXES = ("pretrained.model.norm.", "scratch.refinenet4.resConfUnit1.")


def _family(backbone: str) -> str:
    if backbone == "vitb_rn50_384":
        return "hybrid"
    for prefix, family in (("vit", "vit"), ("beit", "beit"), ("swin", "swin"),
                           ("next_vit", "next_vit"), ("levit", "levit")):
        if backbone.startswith(prefix):
            return family
    raise AssertionError(backbone)


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
    """forward(x (B, 3, H, W)) -> (B, H', W') depth: H' = H for every trunk but
    LeViT's (H - 6: its transposed convs give 2n - 1). H and W are multiples
    of the trunk's patch (16, or 32 for the Swin and Next-ViT pyramids, and
    each Swin stage a multiple of its window)."""

    def __init__(self, backbone: str = "vitl16_384", features: int = 256,
                 readout: str = "project", non_negative: bool = True, head_out_1: bool = True,
                 head_features_1: int = None, head_features_2: int = 32,
                 input_size: tuple = None):
        super().__init__()
        if backbone not in DPT_BACKBONE_HOOKS:
            raise NotImplementedError(f"DPT backbone {backbone!r} is not implemented; "
                                      f"available: {sorted(DPT_BACKBONE_HOOKS)}")
        self.family = _family(backbone)
        self.hooks = DPT_BACKBONE_HOOKS[backbone]
        self.non_negative, self.head_out_1 = non_negative, head_out_1
        # a Swin's widths from SWIN_CONFIGS as it stands (tests narrow it)
        out_channels = (tuple(swin_stage_channels(backbone)) if self.family == "swin"
                        else DPT_BACKBONE_CHANNELS[backbone])
        self.pretrained = nn.Module()
        if self.family in ("vit", "hybrid", "beit"):
            self._token_trunk(backbone, readout, out_channels)
        elif self.family == "swin":
            self.pretrained.model = SwinBackbone(backbone, input_size)
        elif self.family == "next_vit":
            self.pretrained.model = NextViT()
        else:
            self.pretrained.model = LeViT(input_size or (224, 224))
        self.scratch = ScratchConvs(out_channels, features, expand=False)
        for i in range(1, len(out_channels) + 1):
            self.scratch.add_module(f"refinenet{i}", FeatureFusionBlockCustom(features))
        path_channels = features
        if self.family == "levit":
            # stem_b4_transpose(256, 128) in the reference: features -> /2 -> /4
            self.scratch.stem_transpose = StemB4Transpose(features, features // 2)
            path_channels = features // 4
        hf1 = head_features_1 or path_channels
        # indices 1 (the Interpolate), 3 and 5 (ReLUs) hold no weights
        self.scratch.output_conv = nn.Sequential(
            Conv(path_channels, hf1 // 2, 3, 1, 1), nn.Identity(),
            Conv(hf1 // 2, head_features_2, 3, 1, 1), nn.ReLU(),
            Conv(head_features_2, 1, 1) if head_out_1 else nn.Identity(), nn.ReLU())
        self.DEAD_KEY_PREFIXES = DEAD_KEY_PREFIXES + self._dead_keys()

    def _token_trunk(self, backbone: str, readout: str, out_channels):
        hybrid = self.family == "hybrid"
        if self.family == "beit":
            self.pretrained.model = BEiT(backbone)
            dim = BEIT_CONFIGS[backbone][0]
        else:
            self.pretrained.model = ViT("vitb16_384" if hybrid else backbone)
            dim = VIT_CONFIGS["vitb16_384" if hybrid else backbone][0]
        if hybrid:
            self.pretrained.model.patch_embed = HybridEmbed(dim)
        # the hybrid's levels 1-2 are ResNet stages: no act_postprocess1/2 weights
        for level in (2, 3) if hybrid else (0, 1, 2, 3):
            setattr(self.pretrained, f"act_postprocess{level + 1}",
                    _postprocess(readout, dim, out_channels[level], level))

    def _dead_keys(self) -> tuple:
        """Keys the JAX package has no leaf for: BEiT's and LeViT's index
        buffers (rebuilt from the grid), LeViT's blocks past its last tap and
        refinenet3's first RCU (its cascade calls refinenet3 with one input)."""
        trunk = self.pretrained.model
        if self.family == "beit":
            return tuple(f"pretrained.model.blocks.{i}.attn.relative_position_index"
                         for i in range(len(trunk.blocks)))
        if self.family == "levit":
            idxs = tuple(f"pretrained.model.{n}.attention_bias_idxs"
                         for n, m in trunk.named_modules() if isinstance(m, LevitAttention))
            tail = tuple(f"pretrained.model.blocks.{i}."
                         for i in range(max(self.hooks) + 1, len(trunk.blocks)))
            return idxs + tail + ("scratch.refinenet3.resConfUnit1.",)
        return ()

    def _levels(self, x, plain: bool):
        trunk = self.pretrained.model
        if self.family in ("swin", "next_vit", "levit"):
            return list(trunk(x))
        if self.family == "beit":
            taps, (gh, gw) = trunk(x, self.hooks)
            levels, first = [], 0
        else:
            if self.family == "hybrid":
                s1, s2, final = trunk.patch_embed.backbone(x)
                grid = trunk.patch_embed.proj(final)
                levels, first, hooks = [s1, s2], 2, self.hooks[2:]
            else:
                grid = trunk.patch_embed(x)
                levels, first, hooks = [], 0, self.hooks
            taps = trunk.forward_grid(grid, out_indices=hooks, plain=plain, raw_taps=True)
            gh, gw = grid.shape[-2:]
        for level, tokens in enumerate(taps, start=first):
            post = getattr(self.pretrained, f"act_postprocess{level + 1}")
            t = post[0](tokens).transpose(1, 2).reshape(tokens.shape[0], -1, gh, gw)
            for m in list(post)[3:]:
                t = m(t)
            levels.append(t)
        return levels

    def forward(self, x, plain: bool = False):
        """``plain=True`` runs K4's plain version (the ViT trunks) on any device."""
        rn = self.scratch(self._levels(x, plain))
        s = self.scratch
        if len(rn) == 3:
            l1, l2, l3 = rn
            path_3 = s.refinenet3(l3, size=l2.shape[-2:])
        else:
            l1, l2, l3, l4 = rn
            path_4 = s.refinenet4(l4, size=l3.shape[-2:])
            path_3 = s.refinenet3(path_4, l3, size=l2.shape[-2:])
        path_2 = s.refinenet2(path_3, l2, size=l1.shape[-2:])
        path_1 = s.refinenet1(path_2, l1)
        if self.family == "levit":
            path_1 = s.stem_transpose(path_1)
        # DPT's head upsamples with align_corners=True (dpt_depth.py:277-285)
        h = interpolate(s.output_conv[0](path_1), scale_factor=2, align_corners=True)
        h = F.relu(s.output_conv[2](h))
        if not self.head_out_1:
            return h
        out = s.output_conv[4](h)
        return (F.relu(out) if self.non_negative else out)[:, 0]
