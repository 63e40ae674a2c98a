"""Build and bind the native batch image transform (``native/transform.cpp``).

The source is compiled at first use by ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into ``build/native/`` beside the package, and loaded with
``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. A failed build raises: there is no fallback to another implementation.

``transform_batch(images_u8, out_size, flips, num_threads)`` turns uint8
[N, H, W, 3] images into float32 [N, 3, out, out] in [-1, 1]: each image
flipped where ``flips`` says, resized with PIL's antialiased bilinear filter
(kept in float, where PIL rounds its horizontal pass to uint8), in
``num_threads`` threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "transform.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library lives at the current hash of the source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtransform-{digest}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native batch transform is built from "
                           f"{SOURCE} at first use and needs a C++ compiler") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.cagc_transform_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            lib.cagc_transform_batch.restype = None
            _lib = lib
        return _lib


def transform_batch(images_u8: np.ndarray, out_size: int, flips: np.ndarray,
                    num_threads: int = 8) -> np.ndarray:
    """[N, H, W, 3] uint8 -> [N, 3, out_size, out_size] float32 in [-1, 1],
    image i flipped left-right where ``flips[i]`` is nonzero."""
    lib = library()
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    flips = np.ascontiguousarray(flips, dtype=np.uint8)
    if images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"transform_batch takes uint8 [N, H, W, 3], got {images_u8.shape}")
    n, h, w, _ = images_u8.shape
    if flips.shape != (n,):
        raise ValueError(f"flips has shape {flips.shape}, want ({n},)")
    if out_size < 1:
        raise ValueError(f"out_size must be positive, got {out_size}")
    out = np.empty((n, 3, out_size, out_size), dtype=np.float32)
    if n == 0:
        return out
    lib.cagc_transform_batch(
        images_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, out_size,
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(num_threads))
    return out
