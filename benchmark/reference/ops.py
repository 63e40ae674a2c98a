"""Plain PyTorch arithmetic shared by the reference models: the FIR
resampling of StyleGAN2 (upfirdn2d), the scaled LeakyReLU, bilinear resizes,
and the precision every convolution and matrix product of the reference
computes in.

The reference computes in float32 with TF32 off (``strict_float32``). Its
control runs the same code with every convolution and matrix product
computed in a lower precision (``precision("bfloat16")`` or
``precision("float8")``): its operands are rounded (float8: e4m3, with a
scale per tensor), the gradients that reach them too (float8: e5m2), the
sums run in float32, as a tensor core sums them, and the output is rounded
to bfloat16.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
_PRECISION = contextvars.ContextVar("reference_precision", default="float32")


@contextlib.contextmanager
def strict_float32():
    """float32 matrix products and convolutions without TF32, restored on
    exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def precision(kind: str):
    """Compute every convolution and matrix product in ``kind`` inside the
    block: "float32" (no rounding), "bfloat16" or "float8" (``KINDS``)."""
    if kind not in ("float32", "bfloat16", "float8"):
        raise ValueError(f"unknown precision {kind!r}")
    token = _PRECISION.set(kind)
    try:
        yield
    finally:
        _PRECISION.reset(token)


FORMATS = {"bfloat16": torch.bfloat16, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
FORMAT_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
# the formats of a kind's (operands, their gradients, the products' outputs):
# float8 takes e4m3 forward and e5m2 for gradients, as fp8 training does, and
# its products write bfloat16
KINDS = {"bfloat16": ("bfloat16", "bfloat16", "bfloat16"),
         "float8": ("e4m3", "e5m2", "bfloat16")}


def _round(t: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "bfloat16":
        return t.to(torch.bfloat16).to(t.dtype)
    scale = t.detach().abs().amax().clamp(min=1e-30) / FORMAT_MAX[fmt]
    return (t / scale).to(FORMATS[fmt]).to(t.dtype) * scale


class _Rounded(torch.autograd.Function):
    """Rounds a tensor to ``fwd`` and its gradient to ``bwd``, to any
    order."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.fwd, ctx.bwd = fwd, bwd
        return _round(t, fwd)

    @staticmethod
    def backward(ctx, g):
        return _Rounded.apply(g, ctx.bwd, ctx.fwd), None, None


def rounded(t: torch.Tensor, part: int = 0) -> torch.Tensor:
    """``t`` as an operand (``part`` 0) or an output (2) of a product in
    the current precision."""
    kind = _PRECISION.get()
    if kind == "float32":
        return t
    fmt = KINDS[kind][part]
    return _Rounded.apply(t, fmt, KINDS[kind][1] if part == 0 else fmt)


def conv2d(x, w, bias=None, **kw):
    return rounded(F.conv2d(rounded(x), rounded(w), bias, **kw), 2)


def conv_transpose2d(x, w, **kw):
    return rounded(F.conv_transpose2d(rounded(x), rounded(w), **kw), 2)


def linear(x, w, bias=None):
    return rounded(F.linear(rounded(x), rounded(w), bias), 2)


def lrelu(x, bias=None):
    """LeakyReLU(0.2) of ``x + bias`` (bias over dim 1), times sqrt(2)."""
    if bias is not None:
        x = x + bias.reshape(1, -1, *([1] * (x.dim() - 2)))
    return F.leaky_relu(x, 0.2) * SQRT2


def make_kernel(k=(1, 3, 3, 1)) -> torch.Tensor:
    k = torch.tensor(k, dtype=torch.float32)
    k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """NCHW: zero-insert upsample by ``up`` (zeros after each sample), pad
    ``pad`` on both axes, convolve with ``kernel``, keep every ``down``-th
    sample (StyleGAN2's upfirdn2d)."""
    b, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(b, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = kernel.to(x).flip(0, 1)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(x, k, stride=down, groups=c)


def blur(x, pad, gain=1.0):
    return upfirdn2d(x, make_kernel() * gain, pad=pad)


def upsample_skip(x):
    """ToRGB's 2x FIR upsample of the skip (kernel x 4, pads (2, 1))."""
    return upfirdn2d(x, make_kernel() * 4, up=2, pad=(2, 1))


def resize(x, size, align_corners=False):
    """Bilinear NCHW resize without antialias."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners,
                         antialias=False)
