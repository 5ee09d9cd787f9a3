"""Synthetic dataset fixtures matching the CIL on-disk format (a copy of
mde_tpu/data/synthetic.py that writes its PNGs with ``zlib`` and ``struct``,
so it runs where PIL is not installed; the arrays are the same).

The real competition data (23,970 ``sample_NNNNNN_rgb.png sample_NNNNNN_depth.npy``
pairs + 649 test images at 426x560; data/train_list.txt, data/test_list.txt) is
not distributed with either repo. This generator writes structurally identical
fixtures: 8-bit RGB PNGs and float32 ``.npy`` depth maps plus the two list files,
with depth a smooth deterministic function of the image content so that tiny
models can measurably overfit (used by the 16-image overfit integration test —
BASELINE.json config #1 — and by bench.py when no real data directory exists).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG: every scanline
    with filter type 0, the image data in one zlib stream."""
    h, w, c = rgb.shape
    if rgb.dtype != np.uint8 or c != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def _smooth_field(rng: np.random.Generator, h: int, w: int, octaves: int = 3) -> np.ndarray:
    """Sum of upsampled random grids -> smooth [0, 1] field."""
    field = np.zeros((h, w), dtype=np.float32)
    for o in range(octaves):
        gh, gw = 4 * 2**o, 5 * 2**o
        coarse = rng.random((gh, gw), dtype=np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        up = (
            coarse[y0][:, x0] * (1 - fy) * (1 - fx)
            + coarse[y0][:, x0 + 1] * (1 - fy) * fx
            + coarse[y0 + 1][:, x0] * fy * (1 - fx)
            + coarse[y0 + 1][:, x0 + 1] * fy * fx
        )
        field += up / 2**o
    field -= field.min()
    field /= max(field.max(), 1e-6)
    return field


def make_sample(rng: np.random.Generator, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (rgb uint8 HWC, depth float32 HW in (0.1, ~10])."""
    base = _smooth_field(rng, h, w)
    tint = rng.random(3, dtype=np.float32) * 0.5 + 0.5
    rgb = np.stack([base * t for t in tint], axis=-1)
    rgb = np.clip(rgb + 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32), 0, 1)
    # Depth is a smooth monotone function of the base field => learnable from RGB.
    depth = 0.1 + 9.9 * base.astype(np.float32)
    return (rgb * 255).astype(np.uint8), depth


def generate(
    root: str,
    n_train: int = 16,
    n_test: int = 4,
    size: tuple[int, int] = (426, 560),
    seed: int = 0,
) -> tuple[str, str]:
    """Write train/ and test/ image dirs plus list files under ``root``.

    Returns (train_list_path, test_list_path). Layout mirrors the competition
    data_dir convention used by the reference (src/main.py:536-540).
    """
    h, w = size
    rng = np.random.default_rng(seed)
    train_dir = os.path.join(root, "train")
    test_dir = os.path.join(root, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)

    train_lines = []
    for i in range(n_train):
        rgb, depth = make_sample(rng, h, w)
        rgb_name = f"sample_{i:06d}_rgb.png"
        depth_name = f"sample_{i:06d}_depth.npy"
        write_png(os.path.join(train_dir, rgb_name), rgb)
        np.save(os.path.join(train_dir, depth_name), depth)
        train_lines.append(f"{rgb_name} {depth_name}")

    test_lines = []
    for i in range(n_test):
        rgb, _ = make_sample(rng, h, w)
        rgb_name = f"test_{i:06d}_rgb.png"
        depth_name = f"test_{i:06d}_depth.npy"
        write_png(os.path.join(test_dir, rgb_name), rgb)
        test_lines.append(f"{rgb_name} {depth_name}")

    train_list = os.path.join(root, "train_list.txt")
    test_list = os.path.join(root, "test_list.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(train_lines) + "\n")
    with open(test_list, "w") as f:
        f.write("\n".join(test_lines) + "\n")
    return train_list, test_list
