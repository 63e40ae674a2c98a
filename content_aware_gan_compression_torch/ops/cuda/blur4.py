"""The 4x4 FIR blur: the CUDA kernel ``csrc/blur4.cu`` and its plain version.

``blur4(x, kernel, pad, gain)`` computes ``upfirdn2d(x, kernel * gain, up=1,
down=1, pad=pad)`` for a 4x4 kernel and pads >= 0 on an NHWC tensor. On a CUDA
tensor it launches the kernel (or raises); on a CPU tensor it runs
``blur4_plain``, the same 16 multiply-adds written in PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build


def correlation_taps(kernel, gain: float = 1.0) -> list[float]:
    """The 16 taps of ``kernel * gain`` flipped on both axes, row-major: the
    correlation form both versions apply. ``kernel`` is a 4x4 host array."""
    k = torch.as_tensor(kernel, dtype=torch.float64, device="cpu")
    if k.shape != (4, 4):
        raise ValueError(f"blur4 needs a 4x4 kernel, got {tuple(k.shape)}")
    return (k * gain).flip(0, 1).reshape(-1).float().tolist()


def blur4_plain(x: torch.Tensor, taps: list[float], pad: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch: zero-pad, then sum the 16 shifted, tap-weighted views."""
    p0, p1 = pad
    xp = F.pad(x, (0, 0, p0, p1, p0, p1))
    ho, wo = xp.shape[1] - 3, xp.shape[2] - 3
    out = None
    for di in range(4):
        for dj in range(4):
            part = taps[di * 4 + dj] * xp[:, di:di + ho, dj:dj + wo, :]
            out = part if out is None else out + part
    return out


@functools.cache
def _entry():
    lib = build.library("blur4")
    fn = lib.blur4_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)] \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def blur4(x: torch.Tensor, kernel, pad: tuple[int, int], gain: float = 1.0) -> torch.Tensor:
    """4x4 FIR blur of NHWC ``x`` with pads ``(p0, p1)`` >= 0 on both axes.

    Output ``[B, H+p0+p1-3, W+p0+p1-3, C]``. Forward only: a CUDA input that
    needs a gradient raises rather than return one that autograd cannot
    follow.
    """
    p0, p1 = int(pad[0]), int(pad[1])
    if min(p0, p1) < 0:
        raise ValueError(f"blur4 takes pads >= 0, got {pad}")
    taps = correlation_taps(kernel, gain)
    if x.device.type == "cpu":
        return blur4_plain(x, taps, (p0, p1))
    if x.device.type != "cuda":
        raise ValueError(f"blur4 runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"blur4 kernel takes float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("blur4 kernel takes a contiguous NHWC [B,H,W,C] tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "blur4 kernel is forward-only; run under torch.no_grad() or "
            "torch.inference_mode()")
    b, h, w, c = x.shape
    ho, wo = h + p0 + p1 - 3, w + p0 + p1 - 3
    if ho <= 0 or wo <= 0:
        raise ValueError(f"blur4 output would be empty for input {tuple(x.shape)}, pad {pad}")
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    lib, fn = _entry()
    err = fn(x.data_ptr(), out.data_ptr(), (ctypes.c_float * 16)(*taps),
             b, h, w, c, p0, p1, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "blur4", err)
    blur4.launches += 1
    return out


blur4.launches = 0  # kernel launches since the last reset; the CPU path adds none
