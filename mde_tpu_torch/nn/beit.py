"""BEiT trunks for the DPT-BEiT models (port of mde_tpu/nn/beit.py):
``beitb16_384``, ``beitl16_384`` and ``beitl16_512``.

A ViT with a relative position bias in every block (a learned table over the
(2H-1)(2W-1) offsets of the token grid plus three class-token slots), q and v
biases and no k bias, LayerScale residuals (``gamma_1``/``gamma_2``) and no
absolute position embedding. ``forward`` returns the raw outputs of the
blocks in ``out_indices`` (DPT's hooks), class token first.

Named as timm's Beit (the reference's ``pretrained.model``): a fused
``attn.qkv.weight`` with ``attn.q_bias`` and ``attn.v_bias``, and a
``relative_position_index`` buffer for the pretraining grid, so the
state_dict is a MiDaS dpt_beit checkpoint's trunk. The table's three class
slots are in timm's order (class to token, token to class, class to class);
mde_tpu keeps them as (class to class, class to token, token to class), and
``train/convert.py`` reorders them.

On a token grid other than the pretraining one, the spatial part of the table
is resized to (2gh-1, 2gw-1) with align-corners bilinear (the reference's
patched timm, src/network/backbones/beit.py:29-62) and the index is built for
that grid. The logits and the softmax are float32 (``blocks.biased_attention``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.tensor import copy_to_model
from .blocks import LayerNorm, biased_attention, device_constant
from .vit import Mlp, PatchEmbed

BEIT_CONFIGS = {
    # name: (embed_dim, depth, num_heads, patch, pretrain_grid)
    "beitb16_384": (768, 12, 12, 16, (24, 24)),
    "beitl16_384": (1024, 24, 16, 16, (24, 24)),
    "beitl16_512": (1024, 24, 16, 16, (32, 32)),
}


def _relative_position_index(h: int, w: int) -> torch.Tensor:
    """(1+HW, 1+HW) index into the bias table; its last three slots are
    class to token, token to class and class to class (timm's order)."""
    coords = torch.stack(torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij"))
    coords = coords.flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    num_rel = (2 * h - 1) * (2 * w - 1)
    idx = torch.zeros((h * w + 1, h * w + 1), dtype=torch.long)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel      # class -> token
    idx[0:, 0] = num_rel + 1  # token -> class
    idx[0, 0] = num_rel + 2   # class -> class
    return idx


class BeitAttention(nn.Module):
    # under tensor parallelism (parallel/tensor.py): qkv, q_bias and v_bias
    # hold this rank's heads of q, k and v, the bias table their columns,
    # and proj sums the ranks' heads
    tp_linears = {"qkv": "column", "proj": "row"}
    tp_heads = {"q_bias": "column", "v_bias": "column", "relative_position_bias_table": "heads"}

    def __init__(self, dim: int, num_heads: int, pretrain_grid: tuple):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.pretrain_grid = tuple(pretrain_grid)
        ph, pw = self.pretrain_grid
        self.num_rel = (2 * ph - 1) * (2 * pw - 1)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(torch.zeros(self.num_rel + 3, num_heads))
        self.register_buffer("relative_position_index", _relative_position_index(ph, pw))
        self.proj = nn.Linear(dim, dim)

    def init_leaves_(self, generator):
        self.q_bias.zero_()
        self.v_bias.zero_()
        self.relative_position_bias_table.zero_()
        self.relative_position_index.copy_(_relative_position_index(*self.pretrain_grid))

    def _bias(self, grid: tuple) -> torch.Tensor:
        """(heads, 1+HW, 1+HW) float32 bias for the token grid ``grid``: all
        heads, or this model rank's (its share of the table)."""
        table = self.relative_position_bias_table.float()
        if grid == self.pretrain_grid:
            idx = self.relative_position_index
        else:
            (ph, pw), (gh, gw) = self.pretrain_grid, grid
            spatial = table[:self.num_rel].reshape(2 * ph - 1, 2 * pw - 1, -1).permute(2, 0, 1)
            spatial = F.interpolate(spatial[None], size=(2 * gh - 1, 2 * gw - 1), mode="bilinear",
                                    align_corners=True)[0]
            table = torch.cat([spatial.permute(1, 2, 0).reshape(-1, table.shape[1]),
                               table[self.num_rel:]])
            idx = device_constant(_relative_position_index, gh, gw, device=table.device)
        n = idx.shape[0]
        return table[idx.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)

    def forward(self, x, grid: tuple):
        b, n, _ = x.shape
        hd = self.head_dim
        heads = self.q_bias.shape[0] // hd  # all, or this model rank's share
        qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
        if heads < self.num_heads:  # the column layer's input collective: the
            x = copy_to_model(x)    # input's gradient sums the ranks' heads
        qkv = F.linear(x, self.qkv.weight, qkv_bias)
        q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        out = biased_attention(q, k, v, self._bias(tuple(grid))[None], hd**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, n, heads * hd))


class BeitBlock(nn.Module):
    """Pre-norm (LayerNorm eps 1e-6) with LayerScale residuals."""

    GAMMA_INIT = 1e-5  # mde_tpu's LayerScale(dim, 1e-5)

    def __init__(self, dim: int, num_heads: int, pretrain_grid: tuple):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, num_heads, pretrain_grid)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma_1 = nn.Parameter(torch.full((dim,), self.GAMMA_INIT))
        self.gamma_2 = nn.Parameter(torch.full((dim,), self.GAMMA_INIT))

    def init_leaves_(self, generator):
        self.gamma_1.fill_(self.GAMMA_INIT)
        self.gamma_2.fill_(self.GAMMA_INIT)

    def forward(self, x, grid: tuple):
        x = x + self.gamma_1 * self.attn(self.norm1(x), grid)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class BEiT(nn.Module):
    """forward(x (B, 3, H, W), out_indices) -> (raw taps (B, 1 + gh*gw, dim),
    (gh, gw))."""

    def __init__(self, variant: str = "beitl16_384"):
        super().__init__()
        dim, depth, heads, patch, pretrain_grid = BEIT_CONFIGS[variant]
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.patch_embed = PatchEmbed(dim, patch)
        self.blocks = nn.ModuleList(BeitBlock(dim, heads, pretrain_grid) for _ in range(depth))

    def init_leaves_(self, generator):
        self.cls_token.copy_(torch.nn.init.trunc_normal_(
            torch.empty(self.cls_token.shape), std=0.02, a=-0.04, b=0.04, generator=generator))

    def forward(self, x, out_indices):
        grid = self.patch_embed(x)
        b, _, gh, gw = grid.shape
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), grid.flatten(2).transpose(1, 2)], 1)
        take, outputs = set(out_indices), []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens, (gh, gw))
            if i in take:
                outputs.append(tokens)
        return outputs, (gh, gw)
