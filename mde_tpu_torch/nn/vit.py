"""Vision Transformers returning chosen blocks' tokens (port of
mde_tpu/nn/vit.py): the DINOv2 variants and timm's ViT-B/16 and ViT-L/16 at
384, the DPT trunks.

Named as facebookresearch/dinov2's DinoVisionTransformer (cls_token,
pos_embed, mask_token, patch_embed.proj, blocks.i.{norm1,attn,ls1,norm2,mlp,ls2},
norm), so its state_dict is a DINOv2 checkpoint's; the timm rows have no
LayerScale (no ``ls1``/``ls2``) and no mask_token, as timm's
VisionTransformer. ``forward`` has ``get_intermediate_layers(x, n,
norm=True)`` semantics: the outputs of the last ``n`` blocks, or of the blocks
in ``out_indices``, each through the final LayerNorm, class token dropped;
``raw_taps=True`` returns the raw block outputs with the class token and no
norm (DPT's forward-hook taps, src/network/backbones/vit.py).

The pos-embed grid is resized to the token grid: DINOv2's 37x37 bicubic with
interpolate_offset 0.1; timm's 24x24 bilinear with align_corners=False
(src/network/backbones/vit.py:16-30).

Attention is ``ops.kernels.flash_attention`` (K4, a CUDA kernel on the card):
float32 logits and softmax, the math of the JAX einsum path
(mde_tpu/nn/vit.py:52-68). ``plain=True`` runs its plain version on any device.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import flash_attention, flash_attention_plain
from ..ops.resize import resize_bicubic, resize_bilinear
from .blocks import LayerNorm

VIT_CONFIGS = {
    # name: (embed_dim, depth, num_heads, patch_size)
    "dinov2_vits14": (384, 12, 6, 14),
    "dinov2_vitb14": (768, 12, 12, 14),
    "dinov2_vitl14": (1024, 24, 16, 14),
    "vitb16_384": (768, 12, 12, 16),
    "vitl16_384": (1024, 24, 16, 16),
}


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, plain: bool = False):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        attend = flash_attention_plain if plain else flash_attention
        out = attend(*qkv.unbind(2))  # q/k/v: (B, N, heads, hd) views, read in place
        return self.proj(out.reshape(b, n, c))


class LayerScale(nn.Module):
    INIT = 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), self.INIT))

    def init_leaves_(self, generator):
        self.gamma.fill_(self.INIT)

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    """Pre-norm block (LayerNorm eps 1e-6), with LayerScale for DINOv2 and
    plain residuals for the timm rows."""

    def __init__(self, dim: int, num_heads: int, layerscale: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim) if layerscale else nn.Identity()
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.ls2 = LayerScale(dim) if layerscale else nn.Identity()

    def forward(self, x, plain: bool = False):
        x = x + self.ls1(self.attn(self.norm1(x), plain))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)

    def forward(self, x):
        return self.proj(x)  # (B, dim, ph, pw)


class ViT(nn.Module):
    """forward(x (B, 3, H, W), n_layers | out_indices) -> list of (B, ph*pw, dim)
    token maps ((B, 1 + ph*pw, dim) with ``raw_taps``).

    ``patch_embed`` may be replaced by a module that maps the image to a
    (B, dim, ph, pw) grid; ``forward_grid`` runs the rest from such a grid
    (DPT_Hybrid's ResNet-fed trunk).
    """

    def __init__(self, variant: str = "dinov2_vits14"):
        super().__init__()
        dim, depth, heads, patch = VIT_CONFIGS[variant]
        self.dinov2 = variant.startswith("dinov2")
        # DINOv2's 518/14 pretrain grid; timm's 384/16
        self.pos_grid = (37, 37) if self.dinov2 else (24, 24)
        self.patch = patch
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.pos_grid[0] * self.pos_grid[1] + 1, dim))
        if self.dinov2:
            self.mask_token = nn.Parameter(torch.zeros(1, dim))  # masked-image training only
        self.patch_embed = PatchEmbed(dim, patch)
        self.blocks = nn.ModuleList([Block(dim, heads, self.dinov2) for _ in range(depth)])
        self.norm = LayerNorm(dim, eps=1e-6)

    def init_leaves_(self, generator):
        for p in (self.cls_token, self.pos_embed):
            p.copy_(torch.nn.init.trunc_normal_(torch.empty(p.shape), std=0.02, a=-0.04,
                                                b=0.04, generator=generator))
        if self.dinov2:
            self.mask_token.zero_()

    def _patch_pos(self, ph: int, pw: int):
        patch_pos = self.pos_embed[:, 1:]
        if (ph, pw) == self.pos_grid:
            return patch_pos
        gh, gw = self.pos_grid
        grid = patch_pos.reshape(1, gh, gw, -1).permute(0, 3, 1, 2)
        if self.dinov2:
            # interpolate_pos_encoding: bicubic with interpolate_offset=0.1
            # folded into the sampling scale
            grid = resize_bicubic(grid, (ph, pw), scale_factor=((ph + 0.1) / gh, (pw + 0.1) / gw))
        else:
            grid = resize_bilinear(grid, (ph, pw), align_corners=False)
        return grid.permute(0, 2, 3, 1).reshape(1, ph * pw, -1)

    def forward(self, x, n_layers: int = 4, out_indices=None, plain: bool = False,
                raw_taps: bool = False):
        """The last ``n_layers`` blocks' tokens, or those of the blocks in
        ``out_indices`` (in block order); ``plain=True`` runs K4's plain version."""
        return self.forward_grid(self.patch_embed(x), n_layers, out_indices, plain, raw_taps)

    def forward_grid(self, grid, n_layers: int = 4, out_indices=None, plain: bool = False,
                     raw_taps: bool = False):
        """``forward`` from the patch embedding's (B, dim, ph, pw) grid."""
        b, _, ph, pw = grid.shape
        tokens = grid.flatten(2).transpose(1, 2) + self._patch_pos(ph, pw)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(b, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        depth = len(self.blocks)
        take = set(out_indices if out_indices is not None else range(depth - n_layers, depth))
        outputs = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, plain)
            if i in take:
                outputs.append(tokens)
        if raw_taps:
            return outputs
        return [self.norm(t)[:, 1:] for t in outputs]
