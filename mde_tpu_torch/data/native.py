"""ctypes binding for the native host data runtime (native/depthio.cpp); a
copy of mde_tpu/data/native.py that loads the same library.

Provides batch PNG+NPY decoding through a C++ thread pool, writing directly
into caller-owned numpy buffers (no per-sample Python objects, no PIL). Falls
back gracefully: ``available()`` is False when the shared library hasn't been
built (``make -C native``), and callers keep using the per-sample path
(``dataset.decode_png``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native", "libdepthio.so")
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.depthio_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
    ]
    lib.depthio_decode_png.restype = ctypes.c_int
    lib.depthio_png_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.depthio_png_info.restype = ctypes.c_int
    lib.depthio_read_npy.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
    ]
    lib.depthio_read_npy.restype = ctypes.c_int
    lib.depthio_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.depthio_load_batch.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def png_info(path: str) -> tuple[int, int]:
    lib = _load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.depthio_png_info(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"depthio_png_info({path}) failed with {rc}")
    return h.value, w.value


def decode_png(path: str, height: int, width: int) -> np.ndarray:
    lib = _load()
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.depthio_decode_png(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), height, width
    )
    if rc != 0:
        raise IOError(f"depthio_decode_png({path}) failed with {rc}")
    return out


def read_npy(path: str, height: int, width: int) -> np.ndarray:
    lib = _load()
    out = np.empty((height, width), np.float32)
    rc = lib.depthio_read_npy(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size
    )
    if rc != 0:
        raise IOError(f"depthio_read_npy({path}) failed with {rc}")
    return out


def load_batch(
    rgb_paths: Sequence[str],
    depth_paths: Optional[Sequence[str]],
    height: int,
    width: int,
    workers: int = 4,
) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Decode a whole batch in the native thread pool into packed arrays."""
    lib = _load()
    n = len(rgb_paths)
    rgb_out = np.empty((n, height, width, 3), np.uint8)
    depth_out = np.empty((n, height, width), np.float32) if depth_paths else None

    rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
    depth_arr = (
        (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths]) if depth_paths else None
    )
    rc = lib.depthio_load_batch(
        rgb_arr,
        depth_arr,
        n,
        rgb_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        depth_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) if depth_out is not None else None,
        height,
        width,
        workers,
    )
    if rc != 0:
        raise IOError(f"depthio_load_batch failed with {rc}")
    return rgb_out, depth_out
