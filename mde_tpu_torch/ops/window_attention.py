"""Windowed cross-attention over a 2D feature grid (port of
mde_tpu/ops/window_attention.py).

Non-overlapping rectangular windows with ragged edges, as one batched
attention over all windows: pad the projected q/k/v with zeros to window
multiples, partition into (B, N_windows, T, C), attend with each window's
key-validity row so padded keys get no weight, then unpartition and crop.
The attention itself is ``ops.kernels.window_attention`` (a CUDA kernel on
the card, its plain version on the CPU, or on any device with ``plain=True``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import window_attention, window_attention_plain


def _window_partition(x: torch.Tensor, ws: int):
    """(B, Hp, Wp, C) -> (B, nWin, ws*ws, C); Hp/Wp must be multiples of ws."""
    b, hp, wp, c = x.shape
    nh, nw = hp // ws, wp // ws
    x = x.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, ws * ws, c), nh, nw


def _window_unpartition(x: torch.Tensor, ws: int, nh: int, nw: int) -> torch.Tensor:
    b, _, _, c = x.shape
    x = x.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * ws, nw * ws, c)


def _window_key_validity(h: int, w: int, hp: int, wp: int, ws: int) -> np.ndarray:
    """(N_windows, T) float32 validity of each window slot (1 = real token)."""
    valid = np.zeros((hp, wp), dtype=np.float32)
    valid[:h, :w] = 1.0
    nh, nw = hp // ws, wp // ws
    vw = valid.reshape(nh, ws, nw, ws).transpose(0, 2, 1, 3)
    return vw.reshape(nh * nw, ws * ws)


def windowed_cross_attention(q, k, v, num_heads: int, window_size: int = 16,
                             plain: bool = False) -> torch.Tensor:
    """Multi-head attention within aligned windows of a 2D grid.

    q, k, v: (B, H, W, C) projected token grids, C = num_heads * head_dim.
    ``plain=True`` runs the window op's plain version on any device.
    Returns (B, H, W, C) in ``v``'s dtype.
    """
    _, h, w, _ = q.shape
    ws = window_size
    hp = -(-h // ws) * ws
    wp = -(-w // ws) * ws
    pad = (0, 0, 0, wp - w, 0, hp - h)
    qw, nh, nw = _window_partition(F.pad(q, pad), ws)
    kw, _, _ = _window_partition(F.pad(k, pad), ws)
    vw, _, _ = _window_partition(F.pad(v, pad), ws)
    key_valid = torch.from_numpy(_window_key_validity(h, w, hp, wp, ws)).to(q.device)
    attention = window_attention_plain if plain else window_attention
    out = attention(qw.contiguous(), kw.contiguous(), vw.contiguous(), num_heads, key_valid)
    return _window_unpartition(out, ws, nh, nw)[:, :h, :w, :]
