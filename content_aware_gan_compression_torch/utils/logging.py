"""Sample-grid images, written as PNG with the standard library alone."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> grey, RGB, RGBA


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a uint8 [H, W, C] array (C = 1, 3 or 4) as an 8-bit PNG."""
    h, w, c = arr.shape
    if arr.dtype != np.uint8 or c not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes uint8 [H,W,1|3|4], got {arr.dtype} {arr.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def save_image_grid(images_nchw, path: str, nrow: int | None = None,
                    value_range=(-1.0, 1.0), padding: int = 2) -> None:
    """Save a normalized sample grid PNG, the same pixels as the JAX
    package's ``save_image_grid`` (the reference uses torchvision's
    utils.save_image, train.py:428-434). Takes a CPU tensor or an array."""
    imgs = np.asarray(images_nchw)
    lo, hi = value_range
    imgs = np.clip((imgs - lo) / (hi - lo), 0.0, 1.0)
    n, c, h, w = imgs.shape
    nrow = nrow or max(1, int(n ** 0.5))
    ncol = (n + nrow - 1) // nrow
    grid = np.zeros((c, padding + ncol * (h + padding),
                     padding + nrow * (w + padding)), np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[:, padding + r * (h + padding): padding + r * (h + padding) + h,
             padding + col * (w + padding): padding + col * (w + padding) + w] = imgs[i]
    arr = (grid.transpose(1, 2, 0) * 255 + 0.5).clip(0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, arr)
