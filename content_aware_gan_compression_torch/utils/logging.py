"""Experiment logging (the JAX package's utils/logging.py): the reference's
per-iteration text line (train.py:416-422, read by Util/analysis_util.py's
regexes) beside a ``metrics.jsonl`` stream with the same fields, and sample
grids written as PNG with the standard library alone."""

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
