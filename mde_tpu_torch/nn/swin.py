"""Swin V1 and V2 trunks for the DPT-Swin models (port of mde_tpu/nn/swin.py).

``forward`` returns the four stage outputs (NCHW at /4, /8, /16 and /32 with
C, 2C, 4C and 8C channels), which feed DPT's scratch convs directly.

- swinl12_384   (V1): embed 192, depths (2, 2, 18, 2), heads (6, 12, 24, 48), window 12
- swin2l24_384  (V2): embed 192, the same depths and heads, window 24
- swin2b24_384  (V2): embed 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32), window 24
- swin2t16_256  (V2): embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 16

V1 blocks are pre-norm with a learned relative position bias table; V2 blocks
are post-norm with cosine attention (q / (|q| + 1e-6), as mde_tpu, not
``F.normalize``), a per-head logit scale clamped at log 100, and a
continuous position bias: a 2 -> 512 -> heads MLP on log-spaced offsets,
then 16 sigmoid. Odd blocks shift their windows by half a window, with the
nine-region mask; a window is ``min(window, h, w)``, and a window that covers
the grid does not shift.

Named as timm's SwinTransformer / SwinTransformerV2 (the reference's
``pretrained.model``, grammar of tests/torch_swin_ref.py): ``patch_embed.
{proj, norm}``, ``layers.i.blocks.j.{norm1, attn, norm2, mlp}`` and the
downsample at the END of stage i (``layers.i.downsample``), where mde_tpu
merges at the start of stage i+1 (``merge{i+1}``). Patch merging
concatenates the 2x2 neighbours in timm's order (even, even), (odd, even),
(even, odd), (odd, odd); mde_tpu's reshape gives (even, even), (even, odd),
(odd, even), (odd, odd), and ``train/convert.py`` swaps the middle groups.
V2's attention has no qkv bias but ``q_bias`` and ``v_bias`` (k's is zero);
mde_tpu's qkv bias carries a zero k third.

The V2 position bias runs its MLP over the (2w-1)^2 distinct offsets and
gathers the (T, T) map from them, as timm does; mde_tpu evaluates it on every
(T, T) pair, the same values per pair.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.tensor import copy_to_model
from .blocks import LayerNorm, biased_attention, device_constant
from .vit import Mlp

SWIN_CONFIGS = {
    # name: (version, embed, depths, heads, window)
    "swinl12_384": (1, 192, (2, 2, 18, 2), (6, 12, 24, 48), 12),
    "swin2l24_384": (2, 192, (2, 2, 18, 2), (6, 12, 24, 48), 24),
    "swin2b24_384": (2, 128, (2, 2, 18, 2), (4, 8, 16, 32), 24),
    "swin2t16_256": (2, 96, (2, 2, 6, 2), (3, 6, 12, 24), 16),
}


def swin_stage_channels(variant: str) -> list[int]:
    _, embed, _, _, _ = SWIN_CONFIGS[variant]
    return [embed * m for m in (1, 2, 4, 8)]


@functools.lru_cache(maxsize=64)
def _v1_rel_index(window: int) -> np.ndarray:
    """(T, T) index of each (query, key) pair's offset among the (2w-1)^2."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def _v2_log_coords(window: int) -> np.ndarray:
    """((2w-1)^2, 2) log-spaced offsets for the V2 position-bias MLP, in the
    order ``_v1_rel_index`` indexes: the float32 arithmetic of mde_tpu's
    per-pair coordinates, on each distinct offset once."""
    r = np.arange(-(window - 1), window, dtype=np.float32)
    rel = np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    rel = rel / max(window - 1, 1) * 8.0
    return (np.sign(rel) * np.log2(np.abs(rel) + 1.0) / np.log2(8.0)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _shift_mask(h: int, w: int, window: int, shift: int):
    """(nW, T, T) additive mask for shifted windows; None when shift == 0."""
    if shift == 0:
        return None
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Under tensor parallelism (parallel/tensor.py) qkv holds this rank's
    heads of q, k and v, and with them V1's bias table its columns, V2's
    q and v biases, logit scales and the last layer of its position-bias
    MLP (column-parallel: its input's gradient, which reaches the
    replicated first layer, sums the ranks' heads); proj sums the heads."""

    def __init__(self, dim: int, num_heads: int, window: int, version: int = 1):
        super().__init__()
        self.num_heads, self.window, self.version = num_heads, window, version
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=version == 1)
        if version == 1:
            self.tp_linears = {"qkv": "column", "proj": "row"}
            self.tp_heads = {"relative_position_bias_table": "heads"}
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * window - 1) ** 2, num_heads))
        else:
            self.tp_linears = {"qkv": "column", "proj": "row", "cpb_mlp.2": "column"}
            self.tp_heads = {"q_bias": "column", "v_bias": "column", "logit_scale": "column"}
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
            self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
            self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                         nn.Linear(512, num_heads, bias=False))
        self.proj = nn.Linear(dim, dim)

    def init_leaves_(self, generator):
        if self.version == 1:
            t = self.relative_position_bias_table
            t.copy_(torch.nn.init.trunc_normal_(torch.empty(t.shape), std=0.02, a=-0.04, b=0.04,
                                                generator=generator))
        else:
            self.q_bias.zero_()
            self.v_bias.zero_()
            self.logit_scale.fill_(math.log(10.0))

    def forward(self, x, window: int, mask=None):
        """x: (B nW, T, C) windows of side ``window``; mask: (nW, T, T) or None."""
        bnw, t, _ = x.shape
        hd = self.head_dim
        idx = device_constant(_v1_rel_index, window, device=x.device).reshape(-1)
        if self.version == 1:
            qkv = self.qkv(x)
            table, scale = self.relative_position_bias_table.float(), hd**-0.5
        else:
            if self.q_bias.shape[0] < self.num_heads * hd:  # the column layer's input
                x = copy_to_model(x)  # collective: the input's gradient sums the ranks' heads
            qkv = F.linear(x, self.qkv.weight,
                           torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias]))
            coords = device_constant(_v2_log_coords, window, device=x.device)
            coords = coords.to(self.cpb_mlp[0].weight.dtype)  # a float64 model's own type
            table = 16.0 * torch.sigmoid(self.cpb_mlp(coords).float())
            scale = torch.clamp(self.logit_scale.float(), max=math.log(100.0)).exp()
        nh = qkv.shape[-1] // (3 * hd)  # all, or this model rank's share
        q, k, v = qkv.reshape(bnw, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        if self.version == 2:
            q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
            k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
        bias = table[idx].reshape(t, t, nh).permute(2, 0, 1)  # (heads, T, T)
        if mask is None:
            out = biased_attention(q, k, v, bias, scale)
        else:
            nw = mask.shape[0]
            shape = (bnw // nw, nw, nh, t, -1)
            out = biased_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape),
                                   bias + mask[:, None], scale).reshape(bnw, nh, t, -1)
        return self.proj(out.transpose(1, 2).reshape(bnw, t, nh * hd))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, version: int = 1):
        super().__init__()
        self.window, self.shift, self.version = window, shift, version
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window, version)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def _attend(self, t):
        """Windowed (shifted) attention over (B, H, W, C)."""
        b, h, w, c = t.shape
        win = min(self.window, h, w)
        shift = self.shift if win < min(h, w) else 0
        if shift:
            t = torch.roll(t, (-shift, -shift), dims=(1, 2))
        tw = t.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
        mask = device_constant(_shift_mask, h, w, win, shift, device=t.device) if shift else None
        out = self.attn(tw.reshape(-1, win * win, c), win, mask)
        out = out.reshape(b, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, h, w, c)
        return torch.roll(out, (shift, shift), dims=(1, 2)) if shift else out

    def forward(self, x):
        if self.version == 1:  # pre-norm
            x = x + self._attend(self.norm1(x))
            return x + self.mlp(self.norm2(x))
        x = x + self.norm1(self._attend(x))  # V2: post-norm
        return x + self.norm2(self.mlp(x))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in timm's order, then V1: norm and
    reduction; V2: reduction and norm."""

    def __init__(self, dim: int, version: int = 1):
        super().__init__()
        self.version = version
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim if version == 1 else 2 * dim)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        if self.version == 1:
            return self.reduction(self.norm(x))
        return self.norm(self.reduction(x))


class _PatchEmbed(nn.Module):
    def __init__(self, embed: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed, 4, 4)
        self.norm = LayerNorm(embed)


class _Stage(nn.Module):
    def __init__(self, dim, depth, heads, window, version, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if bi % 2 == 0 else window // 2, version)
            for bi in range(depth))
        if downsample:
            self.downsample = PatchMerging(dim, version)


class SwinBackbone(nn.Module):
    """forward(x (B, 3, H, W)) -> the four stage outputs, NCHW.

    A stage whose grid at ``input_size`` is smaller than the window attends
    over the whole grid, and a V1 stage sizes its bias tables for that
    window, as timm builds for its ``img_size`` and mde_tpu for the input it
    is initialised at (None: every stage at least a window).
    """

    def __init__(self, variant: str = "swinl12_384", input_size: tuple = None):
        super().__init__()
        version, embed, depths, heads, window = SWIN_CONFIGS[variant]
        self.patch_embed = _PatchEmbed(embed)
        wins = [window] * len(depths)
        if input_size is not None:
            wins = [min(window, int(input_size[0]) // 2**(si + 2), int(input_size[1]) // 2**(si + 2))
                    for si in range(len(depths))]
        self.layers = nn.ModuleList(
            _Stage(embed * 2**si, depth, nh, wins[si], version, si < len(depths) - 1)
            for si, (depth, nh) in enumerate(zip(depths, heads)))

    def forward(self, x):
        t = self.patch_embed.norm(self.patch_embed.proj(x).permute(0, 2, 3, 1))
        feats = []
        for stage in self.layers:
            for blk in stage.blocks:
                t = blk(t)
            feats.append(t.permute(0, 3, 1, 2))
            if hasattr(stage, "downsample"):
                t = stage.downsample(t)
        return feats
