"""Experiment logging (the JAX package's utils/logging.py): the reference's
per-iteration text line (train.py:416-422, read by Util/analysis_util.py's
regexes) beside a ``metrics.jsonl`` stream with the same fields, and sample
grids written as PNG with the standard library alone (``write_png``; its
kind of PNG is read back by ``read_png``)."""

from __future__ import annotations

import datetime
import json
import os
import struct
import zlib

import numpy as np

_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> grey, RGB, RGBA


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """PNG filter ``ftype`` (0 none, 1 sub, 2 up, 3 average, 4 Paeth) of
    uint8 rows [H, stride] whose pixels are ``bpp`` bytes."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)  # left
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)  # up
    b[1:] = x[:-1]
    c = np.zeros_like(x)  # up-left
    c[1:, bpp:] = x[:-1, :-bpp]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG filter type {ftype} is not one of 0-4")
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, arr: np.ndarray, filter_type: int = 0) -> None:
    """Write a uint8 [H, W, C] array (C = 1, 3 or 4) as an 8-bit PNG, every
    row with the PNG filter ``filter_type`` (0 none, the default; 1 sub, 2
    up, 3 average, 4 Paeth)."""
    h, w, c = arr.shape
    if arr.dtype != np.uint8 or c not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes uint8 [H,W,1|3|4], got {arr.dtype} {arr.shape}")
    filtered = _filter_rows(arr.reshape(h, w * c), filter_type, c)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), filtered], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (none, sub, up, average, Paeth) of ``raw``,
    ``h`` rows of a filter byte and ``stride`` bytes."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced grey, RGB or RGBA PNG (the kinds
    ``write_png`` makes) as uint8 [H, W, C] with the standard library and
    numpy. Anything else raises: decode it with Pillow instead."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _PNG_COLOR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB/RGBA PNGs are read "
                         f"without Pillow (bit depth {depth}, color type {color}, interlace "
                         f"{interlace}); install Pillow to read it")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)


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


def readable_now() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d_%H:%M:%S")


class ExperimentLogger:
    """Writes ``Exp_<ts>/<ts>_training_log.out`` (reference format) and
    ``metrics.jsonl`` side by side, with ``sample/`` and ``ckpt/`` beside
    them."""

    def __init__(self, root: str = ".", name: str | None = None):
        ts = readable_now()
        self.exp_dir = os.path.join(root, name or f"Exp_{ts}")
        self.sample_dir = os.path.join(self.exp_dir, "sample")
        self.ckpt_dir = os.path.join(self.exp_dir, "ckpt")
        os.makedirs(self.sample_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._txt = open(os.path.join(self.exp_dir, f"{ts}_training_log.out"), "a")
        self._jsonl = open(os.path.join(self.exp_dir, "metrics.jsonl"), "a")

    def write(self, text: str):
        self._txt.write(text)
        self._txt.flush()

    def log_iteration(self, iter_idx: int, train_time: float, m: dict):
        """One reference-format line and one JSON record. ``m`` keys: d, g,
        kd_l1_loss, kd_lpips_loss, r1, path, mean_path_avg."""
        self.write(
            f"Iter #: {iter_idx} Train Time: {round(train_time, 2)}"
            f" D_Loss: {round(m.get('d', 0.0), 3)}"
            f" G_Loss: {round(m.get('g', 0.0), 3)}"
            f" KD_L1_Loss: {round(m.get('kd_l1_loss', 0.0), 3)}"
            f" KD_LPIPS_Loss: {round(m.get('kd_lpips_loss', 0.0), 3)}"
            f" D_Reg: {round(m.get('r1', 0.0), 3)}"
            f" G_Reg: {round(m.get('path', 0.0), 3)}"
            f" G_Mean_Path: {round(m.get('mean_path_avg', 0.0), 4)}\n")
        rec = {"iter": iter_idx, "train_time": train_time}
        rec.update({k: float(v) for k, v in m.items()})
        self.log_event(rec)

    def log_fid(self, fid: float, iter_idx: int | None = None):
        """The reference's text line, and a JSON record that also names the
        iteration whose ``g_ema`` was scored (an overlapped eval ends many
        iterations after its snapshot)."""
        self.write(f"\nEvaluated FID: {fid}\n\n")
        rec = {"fid": float(fid)}
        if iter_idx is not None:
            rec["iter"] = int(iter_idx)
        self.log_event(rec)

    def log_event(self, record: dict):
        """One structured JSONL record with no text twin."""
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self):
        self._txt.close()
        self._jsonl.close()
