"""upfirdn2d — upsample, FIR filter, downsample (reference op/upfirdn2d.py).

Semantics, as in the JAX package's ``ops/upfirdn2d.py``:

    1. zero-insert upsample by ``up`` (zeros placed AFTER each sample, so the
       upsampled extent is ``H*up``),
    2. pad by ``(pad0, pad1)`` per axis (negative pads crop),
    3. 2-D correlate with the spatially flipped kernel (== convolve),
    4. keep every ``down``-th sample.

``out_h = (in_h * up + pad0 + pad1 - kernel_h) // down + 1``.

The general path is plain PyTorch: zero-insert, ``F.pad`` (which crops on a
negative pad), then one depthwise ``F.conv2d``. ``blur`` sends the 4x4 case
to the hand-written blur4 kernel. The public layout is NHWC, as in the JAX
package, with ``data_format="NCHW"`` for the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda import blur4


def make_kernel(k) -> torch.Tensor:
    """Normalized 2-D FIR kernel (float32, CPU) from a 1-D or 2-D tap list:
    a 1-D list becomes its outer product; the kernel sums to 1."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.dim() == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def _upfirdn2d_nchw(x, kernel, up, down, pad):
    up_x, up_y = up
    down_x, down_y = down
    pad_x0, pad_x1, pad_y0, pad_y1 = pad
    b, c, h, w = x.shape
    kh, kw = kernel.shape
    if up_x > 1 or up_y > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, (0, up_x - 1, 0, 0, 0, up_y - 1))
        x = x.reshape(b, c, h * up_y, w * up_x)
    x = F.pad(x, (pad_x0, pad_x1, pad_y0, pad_y1))
    weight = kernel.to(device=x.device, dtype=x.dtype).flip(0, 1)
    weight = weight.reshape(1, 1, kh, kw).repeat(c, 1, 1, 1)
    return F.conv2d(x, weight, stride=(down_y, down_x), groups=c)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up=1, down=1, pad=(0, 0),
              data_format: str = "NHWC") -> torch.Tensor:
    """Upsample-FIR-downsample.

    Args:
      x: [B, H, W, C] (NHWC, default) or [B, C, H, W] (NCHW).
      kernel: [kh, kw] FIR taps.
      up / down: int or (x, y) factors.
      pad: (pad0, pad1) on both axes, or (pad_x0, pad_x1, pad_y0, pad_y1).
    """
    up = (up, up) if isinstance(up, int) else tuple(up)
    down = (down, down) if isinstance(down, int) else tuple(down)
    if len(pad) == 2:
        pad = (pad[0], pad[1], pad[0], pad[1])
    if data_format == "NCHW":
        return _upfirdn2d_nchw(x, kernel, up, down, pad)
    if data_format != "NHWC":
        raise ValueError(f"unknown data_format {data_format!r}")
    return _upfirdn2d_nchw(x.permute(0, 3, 1, 2), kernel, up, down, pad).permute(0, 2, 3, 1)


def upsample_2d(x, kernel, factor: int = 2, data_format: str = "NHWC"):
    """FIR upsample (reference model.py:38-56): kernel scaled by factor^2,
    pad0 = (k - factor + 1)//2 + factor - 1, pad1 = (k - factor)//2."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel * (factor ** 2), up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2), data_format=data_format)


def downsample_2d(x, kernel, factor: int = 2, data_format: str = "NHWC"):
    """FIR downsample (reference model.py:59-77)."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor,
                     pad=((p + 1) // 2, p // 2), data_format=data_format)


def blur(x, kernel, pad: tuple[int, int], upsample_factor: int = 1,
         data_format: str = "NHWC"):
    """FIR blur with explicit pads (reference model.py:80-96); after a
    transposed conv the kernel is scaled by upsample_factor^2.

    A 4x4 kernel with pads >= 0 on a float32 or bfloat16 NHWC tensor goes to
    ``blur4`` (``Blur4Fn``): the CUDA kernel on the card, its plain version on
    the CPU, with a backward that is the same blur, to any order. Anything
    else takes the general ``upfirdn2d``. ``kernel`` is a host (CPU) tensor, so the
    kernel's taps reach it without a device round trip."""
    gain = float(upsample_factor ** 2) if upsample_factor > 1 else 1.0
    if (data_format == "NHWC" and tuple(kernel.shape) == (4, 4)
            and min(pad) >= 0 and x.dtype in (torch.float32, torch.bfloat16)):
        return blur4(x, kernel, tuple(pad), gain)
    if gain != 1.0:
        kernel = kernel * gain
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad, data_format=data_format)
