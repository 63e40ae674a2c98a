"""The StyledConv epilogue: the CUDA kernel ``csrc/fused_noise_bias_lrelu.cu``,
its plain version, and ``FusedNoiseBiasLReLUFn``, which makes it
differentiable to any order.

``fused_noise_bias_lrelu(x, noise, bias, noise_weight)`` computes
``lrelu(x + noise_weight * noise + bias, 0.2) * sqrt(2)`` out of place. On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
``fused_noise_bias_lrelu_plain``. Its backward is the JAX package's
``_bwd_vjp``: ``dx`` is ``MaskedScaleFn`` of the incoming gradient and the
saved output (the ``masked_scale`` kernel on the card), and the noise, bias
and noise-weight gradients are sums of ``dx``, reduced on the device.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .masked_scale import MaskedScaleFn


def fused_noise_bias_lrelu_plain(x, noise, bias, noise_weight):
    """Plain PyTorch, in the order the kernel computes: (x + nw*noise) + bias."""
    pre = x + noise_weight * noise + bias
    return torch.where(pre >= 0, pre, pre * 0.2) * math.sqrt(2.0)


@functools.cache
def _entry():
    lib = build.library("fused_noise_bias_lrelu")
    fn = lib.fused_noise_bias_lrelu_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _run(x, noise, bias, noise_weight):
    """One epilogue: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return fused_noise_bias_lrelu_plain(x, noise, bias, noise_weight)
    if x.device.type != "cuda":
        raise ValueError(f"fused_noise_bias_lrelu runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("noise", noise), ("bias", bias),
                    ("noise_weight", noise_weight)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"fused_noise_bias_lrelu kernel takes contiguous float32 "
                            f"tensors on {x.device}; {name} is {t.dtype} on {t.device}, "
                            f"contiguous={t.is_contiguous()}")
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    vec4 = c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, bias, out))
    lib, fn = _entry()
    err = fn(x.data_ptr(), noise.data_ptr(), bias.data_ptr(), noise_weight.data_ptr(),
             out.data_ptr(), b, h, w, c, noise.shape[0], int(vec4), x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "fused_noise_bias_lrelu", err)
    fused_noise_bias_lrelu.launches += 1
    return out


class FusedNoiseBiasLReLUFn(torch.autograd.Function):
    """The epilogue with the JAX package's ``fused_noise_bias_lrelu`` VJP."""

    @staticmethod
    def forward(ctx, x, noise, bias, noise_weight):
        out = _run(x, noise, bias, noise_weight)
        ctx.save_for_backward(out, noise, noise_weight)
        return out

    @staticmethod
    def backward(ctx, g):
        out, noise, nw = ctx.saved_tensors
        dx = MaskedScaleFn.apply(g, out)
        need_noise, need_bias, need_nw = ctx.needs_input_grad[1:]
        sum_c = dx.sum(-1, keepdim=True) if need_noise or need_nw else None
        dnoise = dbias = dnw = None
        if need_noise:
            dnoise = nw * sum_c
            if noise.shape[0] != dnoise.shape[0]:  # a [1,H,W,1] buffer broadcast over B
                dnoise = dnoise.sum(0, keepdim=True)
        if need_bias:
            dbias = dx.sum((0, 1, 2))
        if need_nw:
            dnw = (sum_c * noise).sum().reshape(nw.shape)
        return dx, dnoise, dbias, dnw


def fused_noise_bias_lrelu(x: torch.Tensor, noise: torch.Tensor, bias: torch.Tensor,
                           noise_weight: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, C]; noise: [B, H, W, 1] or [1, H, W, 1]; bias: [C];
    noise_weight: a 1-element tensor, read on the device (no host sync)."""
    b, h, w, c = x.shape
    if noise.shape not in ((b, h, w, 1), (1, h, w, 1)) or bias.shape != (c,) \
            or noise_weight.numel() != 1:
        raise ValueError(
            f"fused_noise_bias_lrelu shapes: x {tuple(x.shape)}, noise "
            f"{tuple(noise.shape)}, bias {tuple(bias.shape)}, noise_weight "
            f"{tuple(noise_weight.shape)}")
    return FusedNoiseBiasLReLUFn.apply(x, noise, bias, noise_weight)


fused_noise_bias_lrelu.launches = 0  # kernel launches since the last reset; the CPU path adds none
