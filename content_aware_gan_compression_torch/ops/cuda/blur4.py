"""The 4x4 FIR blur: the CUDA kernel ``csrc/blur4.cu``, its plain version, and
``Blur4Fn``, which makes it differentiable to any order.

``blur4(x, kernel, pad, gain)`` computes ``upfirdn2d(x, kernel * gain, up=1,
down=1, pad=pad)`` for a 4x4 kernel and pads >= 0 on an NHWC tensor. On a CUDA
tensor it launches the kernel (or raises) as ``launch_plan`` cuts it; on a
CPU tensor it runs ``blur4_plain``, the same 16 multiply-adds written in
PyTorch. Both take float32 or bfloat16; a bfloat16 blur sums in float32 and
rounds each output once. Its backward is the same blur with the kernel flipped on both axes
and pads ``(3-p0, 3-p1)``, as the JAX package's ``_blur4_bwd``: it goes
through ``Blur4Fn`` again, so R1's and the path-length regularizer's grad of
grad stay on the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import build
from .masked_scale import contiguous_grad

SMS = 132  # streaming multiprocessors of an H100 SXM
BLOCK_THREADS = 256  # threads a block aims at
STRIP_ROWS = 32  # output rows a thread walks down, at most: 3/32 halo re-reads
MAX_BLOCK_THREADS = 512  # the kernel's __launch_bounds__ (the card allows 1024)
MAX_SMEM_BYTES = 232_448  # 227 KB: the dynamic shared memory a block can opt into
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65_535
MAX_IMAGE_ELEMENTS = 2 ** 31 - 1  # the kernel's 32-bit offsets inside one image


def correlation_taps(kernel, gain: float = 1.0) -> list[float]:
    """The 16 taps of ``kernel * gain`` flipped on both axes, row-major: the
    correlation form both versions apply. ``kernel`` is a 4x4 host array."""
    k = torch.as_tensor(kernel, dtype=torch.float64, device="cpu")
    if k.shape != (4, 4):
        raise ValueError(f"blur4 needs a 4x4 kernel, got {tuple(k.shape)}")
    return (k * gain).flip(0, 1).reshape(-1).float().tolist()


def blur4_plain(x: torch.Tensor, taps: list[float], pad: tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch: zero-pad, then sum the 16 shifted, tap-weighted views.
    A bfloat16 input is summed in float32 and rounded once, as the kernel
    does."""
    if x.dtype == torch.bfloat16:
        return blur4_plain(x.float(), taps, pad).to(torch.bfloat16)
    p0, p1 = pad
    xp = F.pad(x, (0, 0, p0, p1, p0, p1))
    ho, wo = xp.shape[1] - 3, xp.shape[2] - 3
    out = None
    for di in range(4):
        for dj in range(4):
            part = taps[di * 4 + dj] * xp[:, di:di + ho, dj:dj + wo, :]
            out = part if out is None else out + part
    return out


# the lane widths the kernel has for each element size: 16 bytes, a
# bfloat16 pair (4 bytes) and one element
LANES = {4: (4, 1), 2: (8, 2, 1)}


def lane_width(c: int, *pointers: int, itemsize: int = 4) -> int:
    """Channels per thread for ``itemsize``-byte elements: the widest lane of
    ``LANES[itemsize]`` that divides ``c`` and whose bytes divide every
    pointer. float32: 4 (``float4``) or 1; bfloat16: 8 (16 bytes), 2 (an
    ``__nv_bfloat162``) or 1."""
    for vec in LANES[itemsize]:
        if c % vec == 0 and all(p % (vec * itemsize) == 0 for p in pointers):
            return vec
    raise AssertionError("unreachable: 1 lane always fits")


@dataclasses.dataclass(frozen=True)
class Blur4Plan:
    """How one launch of ``csrc/blur4.cu`` cuts its output: blocks of
    ``(cv_tile, tw)`` threads, each thread ``vec`` channels of one output
    column, walking down a strip of ``th`` output rows. Grid x is the column
    tiles times the ``n_ctiles`` channel tiles (channel tile fastest), y the
    strips, z the images."""

    shape: tuple[int, int, int, int]  # input [B, H, W, C]
    pad: tuple[int, int]
    vec: int
    cv_tile: int
    tw: int
    th: int
    n_ctiles: int
    grid: tuple[int, int, int]
    smem_bytes: int  # dynamic shared memory: 0, the neighbouring columns come from L1
    itemsize: int = 4  # bytes per element: 4 float32, 2 bfloat16

    @property
    def out_shape(self) -> tuple[int, int, int, int]:
        b, h, w, c = self.shape
        grow = sum(self.pad) - 3
        return b, h + grow, w + grow, c

    @property
    def block(self) -> tuple[int, int, int]:
        return self.cv_tile, self.tw, 1

    def tile(self, bx: int, by: int) -> tuple[range, range, range]:
        """Output rows, columns and channels of the blocks at (bx, by, any
        z), as the kernel computes them."""
        _, ho, wo, c = self.out_shape
        ctile, wtile = bx % self.n_ctiles, bx // self.n_ctiles
        c0, ow0, oh0 = ctile * self.cv_tile * self.vec, wtile * self.tw, by * self.th
        return (range(oh0, min(oh0 + self.th, ho)), range(ow0, min(ow0 + self.tw, wo)),
                range(c0, min(c0 + self.cv_tile * self.vec, c)))

    def window(self, bx: int, by: int) -> tuple[range, range]:
        """Input rows and columns the block reads, halo included; those
        outside the input read 0."""
        rows, cols, _ = self.tile(bx, by)
        p0 = self.pad[0]
        return (range(rows.start - p0, rows.stop - p0 + 3),
                range(cols.start - p0, cols.stop - p0 + 3))


@functools.lru_cache(maxsize=256)
def launch_plan(shape, pad, vec: int, sms: int = SMS, block_threads: int = BLOCK_THREADS,
                strip_rows: int = STRIP_ROWS, itemsize: int = 4) -> Blur4Plan:
    """The launch of ``csrc/blur4.cu`` for an NHWC input of ``shape`` with
    ``itemsize``-byte elements, pads ``pad`` and ``vec`` channels per thread
    (one of ``LANES[itemsize]``). A block takes one channel tile
    (at most ``block_threads`` vectors) and as many columns as fill
    ``block_threads``; strips are ``strip_rows`` high, halved while the grid
    has fewer than 2 blocks per SM of ``sms``. ``bench_blur4 --sweep`` varies
    ``block_threads`` and ``strip_rows``; the defaults measured best. Raises
    where the card or the kernel's 32-bit offsets cannot take the shape."""
    b, h, w, c = (int(n) for n in shape)
    p0, p1 = (int(p) for p in pad)
    ho, wo = h + p0 + p1 - 3, w + p0 + p1 - 3
    if itemsize not in LANES or vec not in LANES[itemsize] or c % vec:
        raise ValueError(f"blur4 takes lanes of {LANES.get(itemsize)} elements dividing C for "
                         f"{itemsize}-byte elements; got {vec} for C={c}")
    if min(p0, p1) < 0 or min(b, c, ho, wo) < 1:
        raise ValueError(f"blur4 has no output for input {tuple(shape)}, pad {tuple(pad)}")
    if max(h * w * c, ho * wo * c) > MAX_IMAGE_ELEMENTS:
        raise ValueError(f"blur4 takes images under 2^31 elements; {tuple(shape)} "
                         f"pad {tuple(pad)} has {max(h * w * c, ho * wo * c)}")
    cv = c // vec
    n_ctiles = -(-cv // block_threads)
    cv_tile = -(-cv // n_ctiles)
    tw = min(wo, max(1, block_threads // cv_tile))
    gx = -(-wo // tw) * n_ctiles
    th = strip_rows
    while th > 1 and gx * -(-ho // th) * b < 2 * sms:
        th //= 2
    plan = Blur4Plan((b, h, w, c), (p0, p1), vec, cv_tile, tw, th, n_ctiles,
                     (gx, -(-ho // th), b), 0, itemsize)
    if cv_tile * tw > MAX_BLOCK_THREADS:
        raise ValueError(f"blur4 block of {cv_tile * tw} threads > {MAX_BLOCK_THREADS}")
    if plan.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"blur4 needs {plan.smem_bytes} B of shared memory > {MAX_SMEM_BYTES}")
    if plan.grid[0] > MAX_GRID_X or max(plan.grid[1:]) > MAX_GRID_YZ:
        raise ValueError(f"blur4 grid {plan.grid} is over the card's limits "
                         f"({MAX_GRID_X}, {MAX_GRID_YZ}, {MAX_GRID_YZ})")
    return plan


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry(dtype: torch.dtype):
    lib = build.library("blur4")
    fn = lib.blur4_forward_bf16 if dtype == torch.bfloat16 else lib.blur4_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)] \
        + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _run(x: torch.Tensor, taps: list[float], pad: tuple[int, int], backward: bool):
    """One blur: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return blur4_plain(x, taps, pad)
    if x.device.type != "cuda":
        raise ValueError(f"blur4 runs on cuda or cpu, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"blur4 kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("blur4 kernel takes a contiguous NHWC [B,H,W,C] tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    p0, p1 = pad
    b, h, w, c = x.shape
    out = torch.empty((b, h + p0 + p1 - 3, w + p0 + p1 - 3, c), dtype=x.dtype, device=x.device)
    itemsize = x.element_size()
    vec = lane_width(c, x.data_ptr(), out.data_ptr(), itemsize=itemsize)
    plan = launch_plan(tuple(x.shape), (p0, p1), vec, _sm_count(x.device.index),
                       itemsize=itemsize)
    lib, fn = _entry(x.dtype)
    err = fn(x.data_ptr(), out.data_ptr(), (ctypes.c_float * 16)(*taps),
             b, h, w, c, p0, p1, plan.vec, plan.cv_tile, plan.tw, plan.th, plan.n_ctiles,
             plan.grid[0], plan.grid[1], plan.smem_bytes, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, "blur4", err)
    bf16 = x.dtype == torch.bfloat16
    wide = vec * itemsize == 16
    blur4.vector_launches += wide
    blur4.bf16_vector_launches += wide and bf16
    if backward:
        blur4.backward_launches += 1
        blur4.bf16_backward_launches += bf16
    else:
        blur4.launches += 1
        blur4.bf16_launches += bf16
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
blur4.vector_launches = 0  # launches, forward or backward, with 16-byte lanes
# the same three counts of the launches on bfloat16 tensors (also counted above)
blur4.bf16_launches = blur4.bf16_backward_launches = blur4.bf16_vector_launches = 0
blur4.grad_copies = 0  # gradients made contiguous before a backward launch
