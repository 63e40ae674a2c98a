"""The 4x4 FIR blur: the CUDA kernel ``csrc/blur4.cu``, its plain version, and
``Blur4Fn``, which makes it differentiable to any order.

``blur4(x, kernel, pad, gain)`` computes ``upfirdn2d(x, kernel * gain, up=1,
down=1, pad=pad)`` for a 4x4 kernel and pads >= 0 on an NHWC tensor. On a CUDA
tensor it launches the kernel (or raises); on a CPU tensor it runs
``blur4_plain``, the same 16 multiply-adds written in PyTorch. Its backward is
the same blur with the kernel flipped on both axes and pads ``(3-p0, 3-p1)``,
as the JAX package's ``_blur4_bwd``: it goes through ``Blur4Fn`` again, so R1's
and the path-length regularizer's grad of grad stay on the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .masked_scale import contiguous_grad


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


def _run(x: torch.Tensor, taps: list[float], pad: tuple[int, int], backward: bool):
    """One blur: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return blur4_plain(x, taps, pad)
    if x.device.type != "cuda":
        raise ValueError(f"blur4 runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"blur4 kernel takes float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("blur4 kernel takes a contiguous NHWC [B,H,W,C] tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    p0, p1 = pad
    b, h, w, c = x.shape
    out = torch.empty((b, h + p0 + p1 - 3, w + p0 + p1 - 3, c), dtype=x.dtype, device=x.device)
    lib, fn = _entry()
    err = fn(x.data_ptr(), out.data_ptr(), (ctypes.c_float * 16)(*taps),
             b, h, w, c, p0, p1, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "blur4", err)
    if backward:
        blur4.backward_launches += 1
    else:
        blur4.launches += 1
    return out


class Blur4Fn(torch.autograd.Function):
    """``blur4`` with the JAX package's ``_blur4_core`` VJP. ``kernel`` is the
    4x4 host tensor before the gain; ``backward`` marks a blur that autograd's
    backward runs, for the launch counts."""

    @staticmethod
    def forward(ctx, x, kernel, pad, gain, backward):
        ctx.kernel, ctx.pad, ctx.gain = kernel, pad, gain
        return _run(x, correlation_taps(kernel, gain), pad, backward)

    @staticmethod
    def backward(ctx, g):
        p0, p1 = ctx.pad
        dx = Blur4Fn.apply(contiguous_grad(g, blur4), ctx.kernel.flip(0, 1),
                           (3 - p0, 3 - p1), ctx.gain, True)
        return dx, None, None, None, None


def blur4(x: torch.Tensor, kernel, pad: tuple[int, int], gain: float = 1.0) -> torch.Tensor:
    """4x4 FIR blur of NHWC ``x`` with pads ``(p0, p1)`` >= 0 on both axes;
    ``kernel`` a 4x4 host array. Output ``[B, H+p0+p1-3, W+p0+p1-3, C]``."""
    p0, p1 = int(pad[0]), int(pad[1])
    if min(p0, p1) < 0:
        raise ValueError(f"blur4 takes pads >= 0, got {pad}")
    if x.dim() == 4 and min(x.shape[1], x.shape[2]) + p0 + p1 - 3 <= 0:
        raise ValueError(f"blur4 output would be empty for input {tuple(x.shape)}, pad {pad}")
    kernel = torch.as_tensor(kernel, dtype=torch.float32, device="cpu")
    return Blur4Fn.apply(x, kernel, (p0, p1), float(gain), False)


blur4.launches = 0  # forward kernel launches since the last reset; the CPU path adds none
blur4.backward_launches = 0  # launches made by autograd's backward, of any order
blur4.grad_copies = 0  # gradients made contiguous before a backward launch
