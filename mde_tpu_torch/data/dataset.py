"""List-file depth dataset, host side: decode only (a copy of
mde_tpu/data/dataset.py).

Mirrors the reference ``DepthDataset`` contract (src/dataset.py:8-70): a
whitespace-split list file of ``<rgb>.png <depth>.npy`` pairs (train) or lines
whose first token is the RGB file (test), loaded relative to ``data_dir``. The
third element returned per sample is the raw list-file entry, used downstream to
name predictions (src/util.py:318 takes ``filenames[i].split(' ')[1]``).

Unlike the reference, no tensor transforms happen here — the host's only job is
decoding PNG -> uint8 HWC and ``np.load`` -> float32 depth; every resize/augment/
normalize runs batched on-device (see data/transforms.py). This keeps the host
loop cheap enough to overlap with the device's compute.

PNGs decode through PIL where it is installed. Where it is not (the GPU
machine), ``read_png`` decodes them with ``zlib`` and numpy: 8-bit grey, grey
and alpha, RGB or RGBA, not interlaced. Scanlines with the None, Sub or Up
filter (all that ``synthetic.write_png`` writes) decode vectorised; Average
and Paeth take a slow per-pixel loop.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 1:  # Sub: a running sum per byte lane, modulo 256
        lanes = row.reshape(-1, bpp).astype(np.uint64).cumsum(axis=0)
        return (lanes % 256).astype(np.uint8).reshape(-1)
    if kind == 2:  # Up
        return (row.astype(np.uint16) + prev).astype(np.uint8)
    out = row.astype(np.int32)
    up = prev.astype(np.int32)
    for i in range(out.size):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:  # Average
            out[i] = (out[i] + (left + up[i]) // 2) & 0xFF
        elif kind == 4:  # Paeth
            ul = up[i - bpp] if i >= bpp else 0
            p = left + up[i] - ul
            pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
            pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
            out[i] = (out[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {kind} is not defined")
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG to (H, W, 3) uint8 RGB with zlib."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type "
                         f"{colour}, interlace {interlace})")
    bpp = _PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    pixels = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prev = pixels[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    pixels = pixels.reshape(h, w, bpp)
    if bpp <= 2:  # grey, grey + alpha
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def decode_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB from a PNG file: PIL where installed, else ``read_png``."""
    try:
        from PIL import Image
    except ImportError:
        return read_png(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


class DepthDataset:
    def __init__(self, data_dir: str, list_file: str, has_gt: bool = True):
        self.data_dir = data_dir
        self.has_gt = has_gt
        with open(list_file, "r") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        self.entries = lines
        self.pairs = [ln.split() for ln in lines]

    def __len__(self) -> int:
        return len(self.entries)

    def paths(self, idx: int) -> tuple[str, Optional[str]]:
        tokens = self.pairs[idx]
        rgb = os.path.join(self.data_dir, tokens[0])
        depth = os.path.join(self.data_dir, tokens[1]) if self.has_gt else None
        return rgb, depth

    def load(self, idx: int) -> tuple[np.ndarray, Optional[np.ndarray], str]:
        """Returns (rgb uint8 HWC, depth float32 HW or None, list-file entry)."""
        tokens = self.pairs[idx]
        rgb_path = os.path.join(self.data_dir, tokens[0])
        rgb = decode_png(rgb_path)
        depth = None
        if self.has_gt:
            depth_path = os.path.join(self.data_dir, tokens[1])
            depth = np.load(depth_path).astype(np.float32)
        return rgb, depth, self.entries[idx]


def split_train_val(n: int, val_fraction: float = 0.15, seed: int = 0):
    """Deterministic 85/15 split.

    The reference uses ``torch.manual_seed(0)`` + ``random_split``
    (src/main.py:610-619); the JAX package documents a fixed numpy permutation
    instead (SURVEY.md §7.4 item 6), and the port keeps it, so both packages
    split a list file the same way. Same sizes as the reference (train =
    int(0.85 * n)), different membership: the reference's split is arbitrary.
    """
    train_size = int((1.0 - val_fraction) * n)
    perm = np.random.default_rng(seed).permutation(n)
    return perm[:train_size], perm[train_size:]
