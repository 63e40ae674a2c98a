"""The StyledConv epilogue: the CUDA kernel ``csrc/fused_noise_bias_lrelu.cu``,
its plain version, and ``FusedNoiseBiasLReLUFn``, which makes it
differentiable to any order.

``fused_noise_bias_lrelu(x, noise, bias, noise_weight)`` computes
``lrelu(x + noise_weight * noise + bias, 0.2) * sqrt(2)`` out of place. On a
CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
``fused_noise_bias_lrelu_plain``. Both take float32 or bfloat16 (all four
tensors of one type); in bfloat16 the expression runs in float32 and the
output is rounded once. Its backward is the JAX package's ``_bwd_vjp``:
``dx`` is ``MaskedScaleFn`` of the incoming gradient and the saved output
(the ``masked_scale`` kernel on the card), and the noise, bias and
noise-weight gradients are sums of ``dx``, reduced on the device in float32
at least and rounded once to their tensors' type. In bfloat16 that is the
rounded ``dx``, as the JAX ``_bwd_vjp`` sums it; autograd of the plain
expression sums the unrounded one instead, so the two differ there by the
rounding of ``dx`` (first order) and what a second order makes of it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .lanes import LANE_BYTES, EpiloguePlan, epilogue_plan
from .masked_scale import MaskedScaleFn


def fused_noise_bias_lrelu_plain(x, noise, bias, noise_weight):
    """Plain PyTorch, in the order the kernel computes: (x + nw*noise) + bias.
    bfloat16 inputs: the same in float32, rounded once at the end."""
    if x.dtype == torch.bfloat16:
        return fused_noise_bias_lrelu_plain(
            x.float(), noise.float(), bias.float(), noise_weight.float()).to(torch.bfloat16)
    pre = x + noise_weight * noise + bias
    return torch.where(pre >= 0, pre, pre * 0.2) * math.sqrt(2.0)


# the C entry's arguments: x, noise, bias, nw, out; then epilogue_args
ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def epilogue_args(plan: EpiloguePlan, device_index: int, stream: int) -> list:
    """The plan's part of the C entry's arguments, after the five pointers."""
    return [plan.n, plan.c, plan.hw, int(plan.bcast), *plan.c_div, *plan.hw_div, int(plan.vec),
            plan.path, plan.threads, plan.vectors, plan.blocks, int(plan.wide_index),
            plan.smem_bytes, int(plan.streaming), device_index, stream]


@functools.cache
def _entry(dtype: torch.dtype):
    lib = build.library("fused_noise_bias_lrelu")
    fn = (lib.fused_noise_bias_lrelu_forward_bf16 if dtype == torch.bfloat16
          else lib.fused_noise_bias_lrelu_forward)
    fn.argtypes = ARGTYPES
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
        if (t.device != x.device or t.dtype != x.dtype
                or t.dtype not in (torch.float32, torch.bfloat16) or not t.is_contiguous()):
            raise TypeError(f"fused_noise_bias_lrelu kernel takes contiguous tensors of one "
                            f"type, float32 or bfloat16, on {x.device}; {name} is {t.dtype} "
                            f"on {t.device}, contiguous={t.is_contiguous()}")
    out = torch.empty_like(x)
    aligned = x.data_ptr() % LANE_BYTES == 0 and out.data_ptr() % LANE_BYTES == 0
    plan = epilogue_plan(tuple(x.shape), noise.shape[0], x.element_size(), aligned,
                         bias_aligned=bias.data_ptr() % LANE_BYTES == 0)
    lib, fn = _entry(x.dtype)
    err = fn(x.data_ptr(), noise.data_ptr(), bias.data_ptr(), noise_weight.data_ptr(),
             out.data_ptr(), *epilogue_args(plan, x.device.index,
                                            torch.cuda.current_stream(x.device).cuda_stream))
    build.check(lib, "fused_noise_bias_lrelu", err)
    bf16 = x.dtype == torch.bfloat16
    fused_noise_bias_lrelu.launches += 1
    fused_noise_bias_lrelu.bf16_launches += bf16
    fused_noise_bias_lrelu.vector_launches += plan.vector_body
    fused_noise_bias_lrelu.bf16_vector_launches += plan.vector_body and bf16
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
        # the sums run in float32 at least (bfloat16 is widened) and round
        # once to the type of the tensor they are the gradient of
        acc = torch.promote_types(dx.dtype, torch.float32)
        sum_c = dx.sum(-1, keepdim=True, dtype=acc) if need_noise or need_nw else None
        dnoise = dbias = dnw = None
        if need_noise:
            dnoise = nw.to(acc) * sum_c
            if noise.shape[0] != dnoise.shape[0]:  # a [1,H,W,1] buffer broadcast over B
                dnoise = dnoise.sum(0, keepdim=True)
            dnoise = dnoise.to(noise.dtype)
        if need_bias:
            dbias = dx.sum((0, 1, 2), dtype=acc).to(dx.dtype)
        if need_nw:
            dnw = (sum_c * noise.to(acc)).sum().reshape(nw.shape).to(nw.dtype)
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
fused_noise_bias_lrelu.bf16_launches = 0  # those on bfloat16 tensors
fused_noise_bias_lrelu.vector_launches = 0  # launches with a 16-byte body (x, out aligned)
fused_noise_bias_lrelu.bf16_vector_launches = 0  # those on bfloat16 tensors
