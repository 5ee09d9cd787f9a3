"""LeViT-384 trunk for DPT-LeViT (port of mde_tpu/nn/levit.py).

A stem of four 3x3 stride-2 convs (48, 96, 192, 384 channels, hardswish
between) to /16, then three stages of attention and MLP blocks (dims 384,
512, 768; heads 6, 9, 12; key_dim 32, attn_ratio 2, mlp_ratio 2, depth 4),
with an attention-subsample block (queries on every second grid point,
attn_ratio 4) and an MLP between stages. Every linear is Linear + BatchNorm
(``LinearBN``: BN over the B*N tokens); attention adds a learned bias per
|offset| between query and key points. ``forward`` returns the three maps
the reference taps at flat blocks 3, 11 and 21 (src/network/dpt_depth.py:182)
as NCHW; flat blocks 22-27 exist (they are in the checkpoint) but no tap
reads them, so they do not run.

Named as timm's levit_384 (the reference's ``pretrained.model``, grammar of
tests/torch_levit_ref.py): ``patch_embed.{0,2,4,6}.{c,bn}`` and one flat
``blocks`` list of Residual-wrapped Attention (``m.qkv``, ``m.proj.1``,
``m.attention_biases``, ``m.attention_bias_idxs``) and MLPs (``m.0``,
``m.2``), and unwrapped AttentionSubsamples (``kv``, ``q.1``, ``proj.1``).
timm fuses q, k and v per head ([q|k|v] for each head) and k and v of a
subsample per head; mde_tpu keeps q apart and k before v for all heads,
and ``train/convert.py`` regathers the rows (weights and BN vectors).
Both sides order the bias table's offsets lexicographically: timm orders
them by first occurrence, and the first query point (0, 0) meets every
offset in that order.

The bias tables and their index buffers are built for one input size
(timm's ``img_size``, 224 for dpt_levit_224), as mde_tpu's tables take their
size from the input it is initialised at; another grid raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from .blocks import biased_attention

KEY_DIM = 32
DIMS, HEADS, DEPTHS = (384, 512, 768), (6, 9, 12), (4, 4, 4)
HOOKS = (3, 11, 21)


@functools.lru_cache(maxsize=64)
def _bias_index(h: int, w: int, stride: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """(unique |offsets| (K, 2), index (Hq*Wq, H*W)) for the attention bias:
    queries on the grid taken every ``stride`` points, keys on all of it."""
    pts = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1).reshape(-1, 2)
    q_pts = np.stack(np.meshgrid(np.arange(0, h, stride), np.arange(0, w, stride),
                                 indexing="ij"), -1).reshape(-1, 2)
    offs = np.abs(q_pts[:, None, :] - pts[None, :, :])
    uniq, idx = np.unique(offs.reshape(-1, 2), axis=0, return_inverse=True)
    return uniq, idx.reshape(offs.shape[0], offs.shape[1])


class LinearBN(nn.Module):
    """Linear without bias, then BatchNorm over every token: (B, N, C) ->
    BatchNorm1d on (B*N, C)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.c = nn.Linear(cin, cout, bias=False)
        self.bn = nn.BatchNorm1d(cout)

    def forward(self, x):
        x = self.c(x)
        return self.bn(x.flatten(0, 1)).reshape_as(x)


class ConvBN(nn.Module):
    """timm's ConvNorm / ConvTransposeNorm: a bias-free conv, then BN."""

    def __init__(self, cin: int, cout: int, transpose: bool = False):
        super().__init__()
        conv = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.c = conv(cin, cout, 3, 2, 1, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return self.bn(self.c(x))


class Residual(nn.Module):
    def __init__(self, m: nn.Module):
        super().__init__()
        self.m = m

    def forward(self, x):
        return x + self.m(x)


class Subsample(nn.Module):
    """Tokens of the grid's every second point (no weights)."""

    def __init__(self, grid: tuple):
        super().__init__()
        self.grid = grid

    def forward(self, x):
        b, _, c = x.shape
        return x.reshape(b, *self.grid, c)[:, ::2, ::2].reshape(b, -1, c)


class LevitAttention(nn.Module):
    """Attention over a (h, w) token grid with per-offset biases; with
    ``subsample`` the queries sit on every second point (an
    AttentionSubsample: fused ``kv``, ``q`` after a Subsample, attn_ratio 4)."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: int, grid: tuple,
                 subsample: bool = False, out_dim: int = None):
        super().__init__()
        self.nh, self.kd, self.vd = num_heads, KEY_DIM, KEY_DIM * attn_ratio
        self.grid, self.subsample = tuple(grid), subsample
        if subsample:
            self.kv = LinearBN(dim, num_heads * (self.kd + self.vd))
            self.q = nn.Sequential(Subsample(self.grid), LinearBN(dim, num_heads * self.kd))
        else:
            self.qkv = LinearBN(dim, num_heads * (2 * self.kd + self.vd))
        self.proj = nn.Sequential(nn.Hardswish(), LinearBN(num_heads * self.vd, out_dim or dim))
        uniq, idx = _bias_index(*self.grid, 2 if subsample else 1)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, len(uniq)))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idx))

    def init_leaves_(self, generator):
        self.attention_biases.zero_()
        self.attention_bias_idxs.copy_(
            torch.from_numpy(_bias_index(*self.grid, 2 if self.subsample else 1)[1]))

    def forward(self, x):
        b, n, _ = x.shape
        if self.subsample:
            k, v = self.kv(x).reshape(b, n, self.nh, -1).split([self.kd, self.vd], dim=3)
            q = self.q(x).reshape(b, -1, self.nh, self.kd)
        else:
            q, k, v = self.qkv(x).reshape(b, n, self.nh, -1).split(
                [self.kd, self.kd, self.vd], dim=3)
        bias = self.attention_biases.float()[:, self.attention_bias_idxs]
        out = biased_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               bias, self.kd**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, q.shape[1], -1))


def LevitMlp(dim: int, ratio: int = 2) -> nn.Sequential:
    return nn.Sequential(LinearBN(dim, dim * ratio), nn.Hardswish(), LinearBN(dim * ratio, dim))


class LeViT(nn.Module):
    """levit_384 for ``input_size`` (h, w), multiples of 16; forward(x (B, 3,
    h, w)) -> three NCHW maps at /16, /32 and /64."""

    def __init__(self, input_size: tuple = (224, 224)):
        super().__init__()
        c0 = DIMS[0]
        stem = []
        for i, (cin, cout) in enumerate(zip((3, c0 // 8, c0 // 4, c0 // 2),
                                            (c0 // 8, c0 // 4, c0 // 2, c0))):
            stem += [ConvBN(cin, cout)] + ([nn.Hardswish()] if i < 3 else [])
        self.patch_embed = nn.Sequential(*stem)
        grid = (-(-int(input_size[0]) // 16), -(-int(input_size[1]) // 16))
        self.grids, blocks = [], []
        for si, (dim, nh, depth) in enumerate(zip(DIMS, HEADS, DEPTHS)):
            if si > 0:
                blocks += [LevitAttention(DIMS[si - 1], DIMS[si - 1] // KEY_DIM, 4, grid,
                                          subsample=True, out_dim=dim),
                           Residual(LevitMlp(dim))]
                grid = ((grid[0] + 1) // 2, (grid[1] + 1) // 2)
            self.grids.append(grid)
            for _ in range(depth):
                blocks += [Residual(LevitAttention(dim, nh, 2, grid)), Residual(LevitMlp(dim))]
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x):
        h = self.patch_embed(x)
        b, c, gh, gw = h.shape
        if (gh, gw) != self.grids[0]:
            raise ValueError(f"LeViT was built for a {self.grids[0]} token grid (its bias "
                             f"tables), not {(gh, gw)}")
        tokens = h.flatten(2).transpose(1, 2)
        feats = []
        for i, blk in enumerate(self.blocks[:max(HOOKS) + 1]):
            tokens = blk(tokens)
            if i in HOOKS:
                grid = self.grids[len(feats)]
                feats.append(tokens.transpose(1, 2).reshape(b, -1, *grid))
        return feats


class StemB4Transpose(nn.Sequential):
    """DPT-LeViT's 4x upsampling head stem (src/network/backbones/levit.py:
    86-96): a bias-free 3x3 stride-2 transposed conv + BN + hardswish to
    ``out_channels``, then another to half that (each 2n - 1 wide)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(ConvBN(in_channels, out_channels, transpose=True), nn.Hardswish(),
                         ConvBN(out_channels, out_channels // 2, transpose=True), nn.Hardswish())
