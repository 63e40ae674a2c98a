"""The StyledConv epilogue's backward: the CUDA kernel ``csrc/masked_scale.cu``,
its plain version, and ``MaskedScaleFn``, which makes it differentiable.

``masked_scale(g, out)`` computes ``g * (out >= 0 ? 1 : 0.2) * sqrt(2)``: the
gradient of ``lrelu(pre, 0.2) * sqrt(2)`` taken from the saved output. On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
``masked_scale_plain``. ``MaskedScaleFn`` mirrors the JAX package's
``_masked_scale`` custom VJP: it is linear in ``g`` with a piecewise-constant
mask, so its own backward applies it again to the incoming gradient and sends
none to ``out``. That keeps gradients of any order on the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build


def masked_scale_plain(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch, in the order the kernel computes."""
    return torch.where(out >= 0, g, g * 0.2) * math.sqrt(2.0)


def contiguous_grad(t: torch.Tensor, owner) -> torch.Tensor:
    """``t.contiguous()`` for a kernel's input on the card, adding one to
    ``owner.grad_copies`` when that copies: gradients arrive as permuted views
    of convolution results. The plain versions take any strides."""
    if t.device.type != "cuda" or t.is_contiguous():
        return t
    owner.grad_copies += 1
    return t.contiguous()


@functools.cache
def _entry():
    lib = build.library("masked_scale")
    fn = lib.masked_scale_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def masked_scale(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``g * (out >= 0 ? 1 : 0.2) * sqrt(2)`` for ``g`` and ``out`` of one
    shape. Not differentiable itself: ``MaskedScaleFn`` is."""
    if g.shape != out.shape:
        raise ValueError(f"masked_scale shapes differ: g {tuple(g.shape)}, out {tuple(out.shape)}")
    if out.device.type == "cpu":
        return masked_scale_plain(g, out)
    if out.device.type != "cuda":
        raise ValueError(f"masked_scale runs on cuda or cpu, not {out.device}")
    for name, t in (("g", g), ("out", out)):
        if t.device != out.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"masked_scale kernel takes contiguous float32 tensors on "
                            f"{out.device}; {name} is {t.dtype} on {t.device}, "
                            f"contiguous={t.is_contiguous()}")
    dx = torch.empty_like(out)
    vec4 = all(t.data_ptr() % 16 == 0 for t in (g, out, dx))
    lib, fn = _entry()
    err = fn(g.data_ptr(), out.data_ptr(), dx.data_ptr(), out.numel(), int(vec4),
             out.device.index, torch.cuda.current_stream(out.device).cuda_stream)
    build.check(lib, "masked_scale", err)
    masked_scale.launches += 1
    return dx


masked_scale.launches = 0  # kernel launches since the last reset; the CPU path adds none
masked_scale.grad_copies = 0  # gradients made contiguous before a launch


class MaskedScaleFn(torch.autograd.Function):
    """``masked_scale`` with the JAX package's ``_masked_scale`` VJP."""

    @staticmethod
    def forward(ctx, g, out):
        ctx.save_for_backward(out)
        return masked_scale(contiguous_grad(g, masked_scale), out)

    @staticmethod
    def backward(ctx, gg):
        (out,) = ctx.saved_tensors
        return MaskedScaleFn.apply(gg, out), None
