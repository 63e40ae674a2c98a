"""The StyledConv epilogue's backward: the CUDA kernel ``csrc/masked_scale.cu``,
its plain version, and ``MaskedScaleFn``, which makes it differentiable.

``masked_scale(g, out)`` computes ``g * (out >= 0 ? 1 : 0.2) * sqrt(2)``: the
gradient of ``lrelu(pre, 0.2) * sqrt(2)`` taken from the saved output. On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
``masked_scale_plain``. Both take float32 or bfloat16 (``g`` and ``out`` of
one type); in bfloat16 the products run in float32, the gain first, and
``dx`` is rounded once. ``MaskedScaleFn`` mirrors the JAX package's
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
from .lanes import LANE_BYTES, LanePlan, lane_plan


def masked_scale_plain(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch, in the order the kernel computes. A bfloat16 ``g``: in
    float32, the gain before the slope (the order autograd of the plain
    epilogue takes), rounded once at the end."""
    if g.dtype == torch.bfloat16:
        v = g.float() * math.sqrt(2.0)
        return torch.where(out >= 0, v, v * 0.2).to(torch.bfloat16)
    return torch.where(out >= 0, g, g * 0.2) * math.sqrt(2.0)


def contiguous_grad(t: torch.Tensor, owner) -> torch.Tensor:
    """``t.contiguous()`` for a kernel's input on the card, adding one to
    ``owner.grad_copies`` when that copies: gradients arrive as permuted views
    of convolution results. The plain versions take any strides."""
    if t.device.type != "cuda" or t.is_contiguous():
        return t
    owner.grad_copies += 1
    return t.contiguous()


# the C entry's arguments: g, out, dx; then lane_args
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
    ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def lane_args(plan: LanePlan, device_index: int, stream: int) -> list:
    """The plan's part of the C entry's arguments, after the three pointers."""
    return [plan.n, int(plan.vec), plan.threads, plan.vectors, plan.blocks,
            int(plan.wide_index), int(plan.streaming), device_index, stream]


@functools.cache
def _entry(dtype: torch.dtype):
    lib = build.library("masked_scale")
    fn = lib.masked_scale_forward_bf16 if dtype == torch.bfloat16 else lib.masked_scale_forward
    fn.argtypes = ARGTYPES
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
        if (t.device != out.device or t.dtype != out.dtype
                or t.dtype not in (torch.float32, torch.bfloat16) or not t.is_contiguous()):
            raise TypeError(f"masked_scale kernel takes two contiguous tensors of one type, "
                            f"float32 or bfloat16, on {out.device}; {name} is {t.dtype} on "
                            f"{t.device}, contiguous={t.is_contiguous()}")
    dx = torch.empty_like(out)
    aligned = all(t.data_ptr() % LANE_BYTES == 0 for t in (g, out, dx))
    plan = lane_plan(out.numel(), out.element_size(), aligned)
    lib, fn = _entry(out.dtype)
    err = fn(g.data_ptr(), out.data_ptr(), dx.data_ptr(),
             *lane_args(plan, out.device.index, torch.cuda.current_stream(out.device).cuda_stream))
    build.check(lib, "masked_scale", err)
    masked_scale.launches += 1
    masked_scale.bf16_launches += out.dtype == torch.bfloat16
    return dx


masked_scale.launches = 0  # kernel launches since the last reset; the CPU path adds none
masked_scale.bf16_launches = 0  # those on bfloat16 tensors
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
