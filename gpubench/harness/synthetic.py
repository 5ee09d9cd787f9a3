"""Training pairs in the CIL on-disk format, made from a seed.

A copy of the program's generator (``mde_tpu_torch/data/synthetic.py``):
8-bit RGB PNGs written with ``zlib`` and ``struct``, float32 ``.npy`` depth
maps in (0.1, 10] that are a smooth function of the image, and a list file
of ``<rgb>.png <depth>.npy`` lines. Each pair draws from its own generator
(the run's seed and its index), so the pairs are made by a pool of worker
processes and come out the same in any order.
"""

from __future__ import annotations

import os
import shutil
import struct
import zlib
import multiprocessing
from pathlib import Path

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 as an 8-bit RGB PNG, every scanline filter type 0."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The (H, W, 3) uint8 of a PNG that ``write_png`` wrote (filter type 0)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h = header[0], header[1]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * 3)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a scanline filter other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy()


def _smooth_field(rng: np.random.Generator, h: int, w: int, octaves: int = 3) -> np.ndarray:
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
        up = (coarse[y0][:, x0] * (1 - fy) * (1 - fx) + coarse[y0][:, x0 + 1] * (1 - fy) * fx
              + coarse[y0 + 1][:, x0] * fy * (1 - fx) + coarse[y0 + 1][:, x0 + 1] * fy * fx)
        field += up / 2**o
    field -= field.min()
    field /= max(field.max(), 1e-6)
    return field


def make_sample(rng: np.random.Generator, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """(rgb uint8 HWC, depth float32 HW in (0.1, 10])."""
    base = _smooth_field(rng, h, w)
    tint = rng.random(3, dtype=np.float32) * 0.5 + 0.5
    rgb = np.stack([base * t for t in tint], axis=-1)
    rgb = np.clip(rgb + 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32), 0, 1)
    depth = 0.1 + 9.9 * base.astype(np.float32)
    return (rgb * 255).astype(np.uint8), depth


def _write_pair(args) -> str:
    train, i, seed, h, w = args
    rgb, depth = make_sample(np.random.default_rng([seed, i]), h, w)
    rgb_name, depth_name = f"sample_{i:06d}_rgb.png", f"sample_{i:06d}_depth.npy"
    write_png(os.path.join(train, rgb_name), rgb)
    np.save(os.path.join(train, depth_name), depth)
    return f"{rgb_name} {depth_name}"


def generate(root: str, n: int, size, seed: int, processes: int) -> str:
    """Write ``n`` pairs of ``size`` under ``root``/train and their list file,
    in ``processes`` worker processes; returns the list file's path."""
    train = os.path.join(root, "train")
    os.makedirs(train, exist_ok=True)
    jobs = [(train, i, seed, int(size[0]), int(size[1])) for i in range(n)]
    if processes <= 1:
        lines = [_write_pair(job) for job in jobs]
    else:
        pool = multiprocessing.get_context("spawn").Pool(processes)
        try:
            lines = pool.map(_write_pair, jobs, chunksize=max(1, n // (4 * processes)))
        finally:
            pool.close()
            pool.join()
    path = os.path.join(root, "train_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


POOL_SEED = 0  # the pool's pairs are the same in every run; the run's seed draws the rest


def pool(cache: Path, n: int, size, processes: int) -> Path:
    """The directory of a pool of ``n`` pairs of ``size`` (its ``train`` and
    ``train_list.txt``) under ``cache``, at a fixed path: written once, by the
    first run in a checkout (into ``<pool>.partial``, then renamed whole), and
    read by every later run, so that a run writes no pairs to the disk."""
    h, w = int(size[0]), int(size[1])
    final = Path(cache) / f"{n}-{h}x{w}"
    if not (final / "train_list.txt").exists():
        staging = final.with_name(final.name + ".partial")
        shutil.rmtree(staging, ignore_errors=True)
        shutil.rmtree(final, ignore_errors=True)
        generate(str(staging), n, (h, w), POOL_SEED, processes)
        os.replace(staging, final)
    return final
