"""Training-log analysis and channel visualization (reference
Util/analysis_util.py; the JAX package's utils/analysis.py). Reads the
reference-format text log the trainers write and its ``metrics.jsonl`` twin."""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _find_log(exp_dir: str) -> str:
    for f in os.listdir(exp_dir):
        if f.endswith(".out"):
            return os.path.join(exp_dir, f)
    raise FileNotFoundError(f"no .out log in {exp_dir}")


def extract_training_log(exp_dir: str):
    """(FLOPs%, FID) lists from a text log (reference analysis_util.py:90-118)."""
    flops_list, fid_list = [], []
    with open(_find_log(exp_dir)) as f:
        for line in f:
            if "FLOPs %:" in line:
                flops_list.append(float(line.split("FLOPs %:")[1]))
            elif "Evaluated FID:" in line:
                fid_list.append(float(line.split("Evaluated FID:")[1]))
    return flops_list, fid_list


def extract_training_kd_loss(exp_dir: str):
    """(KD-L1, KD-LPIPS) series (reference analysis_util.py:119-149)."""
    l1s, lpipss = [], []
    with open(_find_log(exp_dir)) as f:
        for line in f:
            if "Iter #" in line:
                i0 = line.find("KD_L1_Loss:")
                i1 = line.find("KD_LPIPS_Loss:")
                i2 = line.find("D_Reg:")
                l1s.append(float(line[i0 + len("KD_L1_Loss:"):i1]))
                lpipss.append(float(line[i1 + len("KD_LPIPS_Loss:"):i2]))
    return l1s, lpipss


def extract_metrics_jsonl(exp_dir: str, key: str):
    """The series of ``key`` in ``metrics.jsonl``."""
    out = []
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out.append(rec[key])
    return out


@torch.no_grad()
def channel_activation_image(g, z, layer_id, *, noise=None, generator=None, n_col=8):
    """A [H_grid, W_grid] grid of one layer's per-channel activations of the
    first sample, each channel min-max normalized (the analogue of reference
    analysis_util.py:8-89). ``layer_id`` indexes ``g.feature_maps``; its
    noise is ``noise`` or drawn from ``generator``."""
    fmap = g.feature_maps(z, noise=noise, generator=generator)[layer_id][0]
    fmap = fmap.permute(2, 0, 1).float().cpu().numpy()  # [C, H, W]
    c, h, w = fmap.shape
    n_row = (c + n_col - 1) // n_col
    grid = np.zeros((n_row * h, n_col * w), np.float32)
    for i in range(c):
        ch = fmap[i]
        lo, hi = ch.min(), ch.max()
        r, col = divmod(i, n_col)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = (ch - lo) / (hi - lo + 1e-8)
    return grid
