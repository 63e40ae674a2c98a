"""Launch plans of the two elementwise kernels, ``csrc/fused_noise_bias_lrelu.cu``
(the StyledConv epilogue) and ``csrc/masked_scale.cu`` (its backward).

Both walk their tensors as one flat array of ``n`` elements cut into lanes
of 16 bytes: ``LANES[itemsize]`` values, 4 float32 or 8 bfloat16. Lane ``l``
holds elements ``[l * L, min(l * L + L, n))``; block ``b``'s thread ``t``
takes lanes ``b * T * V + j * T + t`` for ``j < V``. A full lane of 16-byte
aligned tensors moves with one 16-byte load or store; the last partial lane,
and every lane of a misaligned view, element by element with the same index
math (``csrc/lanes.cuh``). Offsets are 32-bit while ``n < 2^31`` and 64-bit
from there. ``epilogue_plan`` adds the epilogue's per-lane division: the
lane's first element into (pixel, channel), by a multiply-high with
``magic_divider``'s numbers on the 32-bit path, and the bias table in shared
memory (``bias_slot``), and picks one of the kernel's three lane paths
(``PATHS``). ``bench_fused_act --sweep`` varies the block size, the lanes
per thread and streaming stores; ``DEFAULTS`` are its choice per kernel,
the best over both element sizes and the paths' shapes.
"""

from __future__ import annotations

import dataclasses
import functools

LANE_BYTES = 16
LANES = {4: 4, 2: 8}  # itemsize -> values per 16-byte lane
VECTOR_CHOICES = (1, 2, 4)  # lanes per thread the kernels take
# (threads per block, lanes per thread, streaming stores: st.global.cs)
DEFAULTS = {"epilogue": (256, 1, True), "masked_scale": (128, 1, True)}
# the epilogue's lane paths: C % L == 0 with a 16-byte aligned bias (one
# pixel a lane, bias as one vector), C >= L (at most two pixels a lane, bias
# from shared memory), C < L (value-by-value stepping)
PATHS = {"aligned": 0, "wide": 1, "narrow": 2}
MAX_THREADS = 512  # the kernels' __launch_bounds__
MAX_GRID_X = 2 ** 31 - 1
MAX_INDEX_32 = 2 ** 31 - 1  # the 32-bit path's largest n
MAX_SMEM_BYTES = 48 * 1024  # static limit: the kernels opt into no more


def magic_divider(d: int) -> tuple[int, int]:
    """(mul, shift) with ``n // d == (umulhi(n, mul) + n) >> shift`` for
    every ``0 <= n < 2^31`` (PyTorch's IntDivider rule)."""
    if not 1 <= d <= MAX_INDEX_32:
        raise ValueError(f"magic_divider takes 1 <= d < 2^31, got {d}")
    shift = max(0, (d - 1).bit_length())  # the least s with 2^s >= d
    mul = ((1 << 32) * ((1 << shift) - d)) // d + 1
    assert mul < 1 << 32
    return mul, shift


def magic_divide(n: int, mul: int, shift: int) -> int:
    """The kernel's 32-bit division, in integers: umulhi, add, shift."""
    return (((n * mul) >> 32) + n) >> shift


def bias_slot(j: int, lanes: int) -> int:
    """The shared-memory slot of bias table entry ``j`` (it holds
    ``bias[j % C]``): one padding slot after every ``lanes`` entries."""
    return j + j // lanes


def bias_slots(c: int, lanes: int) -> int:
    """Shared-memory floats of the bias table: entries ``0 .. C + L - 1``."""
    return bias_slot(c + lanes - 1, lanes) + 1


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """One launch of a lane kernel over ``n`` elements of ``itemsize`` bytes."""

    n: int
    itemsize: int
    vec: bool  # 16-byte loads and stores over the full lanes
    threads: int
    vectors: int
    streaming: bool  # evict-first stores

    @property
    def lanes(self) -> int:
        return LANES[self.itemsize]

    @property
    def n_lanes(self) -> int:
        return -(-self.n // self.lanes)

    @property
    def full_lanes(self) -> int:
        return self.n // self.lanes

    @property
    def tail(self) -> int:
        """Elements of the last, partial lane (0 if there is none)."""
        return self.n - self.full_lanes * self.lanes

    @property
    def vector_body(self) -> bool:
        """Whether any lane moves as one 16-byte vector."""
        return self.vec and self.full_lanes > 0

    @property
    def blocks(self) -> int:
        return -(-self.n_lanes // (self.threads * self.vectors))

    @property
    def wide_index(self) -> bool:
        return self.n > MAX_INDEX_32

    def lanes_of(self, block: int, thread: int) -> list[int]:
        """The lanes thread ``thread`` of block ``block`` takes, in order."""
        first = block * self.threads * self.vectors + thread
        return [lane for lane in (first + j * self.threads for j in range(self.vectors))
                if lane < self.n_lanes]

    def elements(self, lane: int) -> range:
        return range(lane * self.lanes, min(lane * self.lanes + self.lanes, self.n))


@dataclasses.dataclass(frozen=True)
class EpiloguePlan(LanePlan):
    """``LanePlan`` of the epilogue over x of shape [B, H, W, C] with noise
    [B or 1, H, W, 1]."""

    c: int = 1
    hw: int = 1
    bcast: bool = False  # a [1, H, W, 1] noise buffer over B > 1 images
    c_div: tuple[int, int] = (1, 0)
    hw_div: tuple[int, int] = (1, 0)
    path: int = PATHS["wide"]

    @property
    def smem_bytes(self) -> int:
        """The bias table's shared memory; none on the aligned path."""
        return 0 if self.path == PATHS["aligned"] else 4 * bias_slots(self.c, self.lanes)


def _check(n, threads, vectors):
    if not (32 <= threads <= MAX_THREADS and threads % 32 == 0):
        raise ValueError(f"threads per block must be a multiple of 32 in [32, {MAX_THREADS}], "
                         f"got {threads}")
    if vectors not in VECTOR_CHOICES:
        raise ValueError(f"lanes per thread must be one of {VECTOR_CHOICES}, got {vectors}")
    if n < 0:
        raise ValueError(f"negative element count {n}")


def _defaults(kernel, itemsize, threads, vectors, streaming):
    if itemsize not in LANES:
        raise ValueError(f"lane kernels take 4- or 2-byte elements, got {itemsize}")
    d = DEFAULTS[kernel]
    return (d[0] if threads is None else threads, d[1] if vectors is None else vectors,
            d[2] if streaming is None else bool(streaming))


@functools.lru_cache(maxsize=1024)
def lane_plan(n: int, itemsize: int, aligned: bool, threads: int | None = None,
              vectors: int | None = None, streaming: bool | None = None) -> LanePlan:
    """masked_scale's launch over ``n`` elements; ``aligned``: every pointer
    is 16-byte aligned; threads, lanes per thread and streaming stores
    default to ``DEFAULTS``. Raises where the kernel or the card cannot take
    it."""
    threads, vectors, streaming = _defaults("masked_scale", itemsize, threads, vectors,
                                            streaming)
    _check(n, threads, vectors)
    plan = LanePlan(n, itemsize, aligned, threads, vectors, streaming)
    if plan.blocks > MAX_GRID_X:
        raise ValueError(f"{plan.blocks} blocks > the card's {MAX_GRID_X}")
    return plan


@functools.lru_cache(maxsize=1024)
def epilogue_plan(shape, noise_batch: int, itemsize: int, aligned: bool,
                  threads: int | None = None, vectors: int | None = None,
                  streaming: bool | None = None, *, bias_aligned: bool = True) -> EpiloguePlan:
    """The epilogue's launch over x of ``shape`` [B, H, W, C] with a noise
    batch of ``noise_batch`` (B or 1); ``aligned``: x and out are 16-byte
    aligned; ``bias_aligned``: bias is (it needs not be: the aligned path
    takes it only then). Raises where the kernel or the card cannot take
    it."""
    threads, vectors, streaming = _defaults("epilogue", itemsize, threads, vectors, streaming)
    b, h, w, c = (int(s) for s in shape)
    n = b * h * w * c
    _check(n, threads, vectors)
    if min(b, h, w, c) < 1 or noise_batch not in (1, b):
        raise ValueError(f"epilogue of x {tuple(shape)} with noise batch {noise_batch}")
    hw, lanes = h * w, LANES[itemsize]
    path = (PATHS["aligned"] if c % lanes == 0 and bias_aligned
            else PATHS["wide"] if c >= lanes else PATHS["narrow"])
    plan = EpiloguePlan(n, itemsize, aligned, threads, vectors, streaming, c, hw,
                        noise_batch != b, magic_divider(min(c, MAX_INDEX_32)),
                        magic_divider(min(hw, MAX_INDEX_32)), path)
    if plan.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"epilogue bias of C={c} needs {plan.smem_bytes} B of shared memory "
                         f"> {MAX_SMEM_BYTES}")
    if plan.blocks > MAX_GRID_X:
        raise ValueError(f"{plan.blocks} blocks > the card's {MAX_GRID_X}")
    return plan
