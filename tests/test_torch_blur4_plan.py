"""blur4's launch plan (``ops/cuda/blur4.py:launch_plan``) on the CPU: the
tiles it cuts, the lane width, the card's limits, and a PyTorch emulation of
the tiled kernel ``csrc/blur4.cu`` (zero-filled halo, a ring of four row
accumulators) over every tile, held against ``blur4_plain``. The kernel
itself runs only on the card (``tests/test_torch_cuda_kernels.py``)."""

import numpy as np
import pytest
import torch

from content_aware_gan_compression_torch.models import (
    DiscriminatorConfig, GeneratorConfig, default_net_shape)
from content_aware_gan_compression_torch.ops.cuda import blur4_plain, lane_width, launch_plan
from content_aware_gan_compression_torch.ops.cuda.blur4 import (
    LANES, MAX_BLOCK_THREADS, MAX_GRID_YZ, MAX_SMEM_BYTES, STRIP_ROWS)
from torch_train_util import torch_threads  # noqa: F401


def _path_cases():
    """(input shape, pad) of every blur on the 256px paths, forward and
    backward: the full-width generator's 6 up-blurs and the 11x student's,
    at batch 16 and the path-length batch 8, and the discriminator's 12."""
    full = default_net_shape(256)
    student = tuple(c - int(c * 0.7) for c in full)
    cases = []
    for batch in (16, 8):
        for ns in (full, student):
            cases += [((batch, 2 ** r + 1, 2 ** r + 1, ns[2 * (r - 2)]), (1, 1))
                      for r in range(3, 9)]
    ch = DiscriminatorConfig(size=256).channels()
    cases += [((16, 256 >> i, 256 >> i, ch[256 >> i]), pad)
              for i in range(6) for pad in ((2, 2), (1, 1))]
    backward = []
    for (b, h, w, c), (p0, p1) in cases:  # the gradient has the output's shape
        grow = p0 + p1 - 3
        backward.append(((b, h + grow, w + grow, c), (3 - p0, 3 - p1)))
    return cases + backward


PATH_CASES = _path_cases()
RAGGED_CASES = [((3, 13, 9, c), pad) for c in (1, 3, 5, 130) for pad in ((2, 1), (0, 3))] + [
    ((2, 17, 11, 12), (3, 0)), ((1, 7, 10, 130), (3, 3)), ((2, 10, 15, 512), (1, 1))]


def test_path_cases_are_the_paths_blurs():
    """The generator's up-blurs carry the widths the issue names, and the
    discriminator blurs 12 times."""
    full_c = {s[3] for s, _ in PATH_CASES[:6]}
    student_c = [s[3] for s, _ in PATH_CASES[6:12]]
    assert full_c == {512, 256, 128}
    assert GeneratorConfig(size=256).net_shape == default_net_shape(256)
    assert student_c == [154, 154, 154, 154, 77, 39]
    assert len(PATH_CASES) == 2 * (24 + 12)


def _coverage(plan):
    """How often each output element is written, and whether every block's
    window is exactly the input rows and columns its outputs read."""
    _, ho, wo, c = plan.out_shape
    hits = torch.zeros(ho, wo, c, dtype=torch.int32)
    windows_right = True
    p0 = plan.pad[0]
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            rows, cols, chans = plan.tile(bx, by)
            hits[rows.start:rows.stop, cols.start:cols.stop, chans.start:chans.stop] += 1
            need_rows = sorted({o + d - p0 for o in rows for d in range(4)})
            need_cols = sorted({o + d - p0 for o in cols for d in range(4)})
            windows_right &= plan.window(bx, by) == (
                range(need_rows[0], need_rows[-1] + 1), range(need_cols[0], need_cols[-1] + 1))
    return hits, windows_right


@pytest.mark.parametrize("shape,pad", PATH_CASES + RAGGED_CASES)
def test_plan_tiles_cover_every_output_once(shape, pad):
    """Grid z is the image; over (x, y) every output element of one image
    lies in exactly one tile, and each tile reads the window that pads
    (p0, p1) require, halo included."""
    for vec in (1, 4) if shape[3] % 4 == 0 else (1,):
        plan = launch_plan(shape, pad, vec)
        assert plan.grid[2] == shape[0]
        assert plan.out_shape == (shape[0], shape[1] + sum(pad) - 3, shape[2] + sum(pad) - 3,
                                  shape[3])
        hits, windows_right = _coverage(plan)
        assert bool((hits == 1).all()), f"vec {vec}: counts {hits.unique().tolist()}"
        assert windows_right


@pytest.mark.parametrize("shape,pad", PATH_CASES)
def test_plan_respects_the_card_and_fills_it(shape, pad):
    for vec in (1, 4) if shape[3] % 4 == 0 else (1,):
        plan = launch_plan(shape, pad, vec)
        assert plan.cv_tile * plan.tw <= MAX_BLOCK_THREADS <= 1024
        assert plan.smem_bytes <= MAX_SMEM_BYTES
        assert max(plan.grid[1:]) <= MAX_GRID_YZ
        # at least 2 blocks per SM, or strips already 1 row high
        assert plan.th == 1 or np.prod(plan.grid) >= 2 * 132


def test_plan_keeps_full_strips_on_the_largest_maps():
    for shape, pad in [((16, 257, 257, 128), (1, 1)), ((16, 256, 256, 128), (2, 2)),
                       ((16, 257, 257, 39), (1, 1))]:
        plan = launch_plan(shape, pad, 4 if shape[3] % 4 == 0 else 1)
        assert plan.th == STRIP_ROWS == 32 and plan.cv_tile * plan.tw <= 256


@pytest.mark.parametrize("shape,pad,vec,why", [
    ((70_000, 9, 9, 8), (1, 1), 4, "grid"),  # grid z over 65535
    ((1, 2 ** 14, 2 ** 14, 8), (1, 1), 1, "under 2"),  # one image of 2^31 elements
    ((2, 9, 9, 6), (1, 1), 4, "lanes"),  # float4 lanes need C % 4 == 0
    ((2, 9, 9, 8), (1, 1), 3, "lanes"),
    ((2, 2, 9, 8), (0, 0), 1, "no output"),
])
def test_plan_raises_outside_the_limits(shape, pad, vec, why):
    with pytest.raises(ValueError, match=why):
        launch_plan(shape, pad, vec)


@pytest.mark.parametrize("c,pointers,want", [
    (128, (0, 16 * 999), 4), (4, (256, 512), 4), (512, (2 ** 40, 2 ** 40 + 16), 4),
    (130, (0, 0), 1), (39, (0, 0), 1), (3, (0, 0), 1),
    (128, (4, 0), 1), (128, (0, 8), 1), (128, (16, 4 * 5), 1),
])
def test_lane_width_is_4_exactly_for_aligned_multiples_of_4(c, pointers, want):
    assert lane_width(c, *pointers) == want


def _emulate(x, taps, plan, blocks=None):
    """The kernel's algorithm in PyTorch, block by block (all images of a
    grid column at once): stage the block's input window with its halo
    zero-filled, walk down its rows, feed each row to the four output rows
    that use it through a ring of accumulators, store the row that is done.
    ``blocks`` limits it to those (bx, by); all of them if None. Returns the
    output and how often each element was stored."""
    b, h, w, c = x.shape
    _, ho, wo, _ = plan.out_shape
    t = torch.tensor(taps, dtype=x.dtype).reshape(4, 4)
    out = torch.full((b, ho, wo, c), float("nan"), dtype=x.dtype)
    stores = torch.zeros(ho, wo, c, dtype=torch.int32)
    if blocks is None:
        blocks = [(bx, by) for bx in range(plan.grid[0]) for by in range(plan.grid[1])]
    for bx, by in blocks:
        rows, cols, chans = plan.tile(bx, by)
        in_rows, in_cols = plan.window(bx, by)
        win = torch.zeros(b, len(in_rows), len(in_cols), len(chans), dtype=x.dtype)
        r0, r1 = max(in_rows.start, 0), min(in_rows.stop, h)
        c0, c1 = max(in_cols.start, 0), min(in_cols.stop, w)
        win[:, r0 - in_rows.start:r1 - in_rows.start, c0 - in_cols.start:c1 - in_cols.start] \
            = x[:, r0:r1, c0:c1, chans.start:chans.stop]
        ring = [torch.zeros(b, len(cols), len(chans), dtype=x.dtype) for _ in range(4)]
        for i in range(len(in_rows)):
            for k in range(4):  # ring[k] is output row oh0 + i - 3 + k: tap row 3 - k
                for dj in range(4):
                    ring[k] = ring[k] + t[3 - k, dj] * win[:, i, dj:dj + len(cols)]
            if i >= 3:
                oh = rows.start + i - 3
                out[:, oh, cols.start:cols.stop, chans.start:chans.stop] = ring[0]
                stores[oh, cols.start:cols.stop, chans.start:chans.stop] += 1
            ring = ring[1:] + [torch.zeros_like(ring[0])]
    return out, stores


@pytest.mark.parametrize("shape,pad,sms", [
    ((2, 9, 7, 5), (2, 1), 132), ((2, 70, 9, 3), (1, 1), 1), ((1, 37, 11, 12), (0, 3), 1),
    ((2, 21, 13, 8), (3, 0), 1), ((1, 19, 6, 130), (3, 3), 1), ((3, 8, 8, 4), (2, 2), 132),
    ((1, 35, 12, 600), (1, 2), 1),
])
def test_tiled_algorithm_equals_blur4_plain(shape, pad, sms):
    """Every tile of the plan, emulated, gives blur4_plain to 1e-6 * max|x|.
    ``sms`` 1 keeps the strips STRIP_ROWS high at these small sizes, so the
    ring runs through full strips and strip boundaries."""
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32))
    taps = (torch.arange(16, dtype=torch.float64) / 120).tolist()  # not separable
    want = blur4_plain(x, taps, pad)
    for vec in (1, 4) if shape[3] % 4 == 0 else (1,):
        plan = launch_plan(shape, pad, vec, sms)
        assert sms == 132 or plan.th == STRIP_ROWS
        got, stores = _emulate(x, taps, plan)
        assert bool((stores == 1).all())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * x.abs().max().item())


# -- bfloat16 -------------------------------------------------------------------

def _bf16_lanes(c):
    """The lanes a bfloat16 blur of C channels takes on aligned tensors."""
    return lane_width(c, 0, 0, itemsize=2)


@pytest.mark.parametrize("c,pointers,want", [
    (128, (0, 16 * 999), 8), (8, (256, 512), 8), (512, (2 ** 40, 2 ** 40 + 16), 8),
    (154, (0, 0), 2), (130, (0, 0), 2), (12, (0, 0), 2), (128, (8, 0), 2), (128, (4, 0), 2),
    (77, (0, 0), 1), (39, (0, 0), 1), (3, (0, 0), 1), (128, (2, 0), 1), (154, (0, 6), 1),
])
def test_bf16_lane_width(c, pointers, want):
    """bfloat16: 8 values (16 bytes) when C % 8 == 0 and every pointer is
    16-byte aligned, a pair (4 bytes) when C is even and they are 4-byte
    aligned, else one value."""
    assert lane_width(c, *pointers, itemsize=2) == want


def test_bf16_lanes_of_the_paths_widths():
    """The 11x student's up-blurs take pairs at C = 154 and single values at
    C = 77 and 39; the full-width generator's and D's widths take 16 bytes."""
    assert [_bf16_lanes(s[3]) for s, _ in PATH_CASES[6:12]] == [2, 2, 2, 2, 1, 1]
    assert {_bf16_lanes(s[3]) for s, _ in PATH_CASES[:6] + PATH_CASES[24:36]} == {8}


@pytest.mark.parametrize("shape,pad", PATH_CASES + RAGGED_CASES)
def test_bf16_plan_tiles_cover_every_output_once_and_fit_the_card(shape, pad):
    for vec in {_bf16_lanes(shape[3]), 1}:
        plan = launch_plan(shape, pad, vec, itemsize=2)
        assert plan.itemsize == 2 and plan.vec == vec
        hits, windows_right = _coverage(plan)
        assert bool((hits == 1).all()) and windows_right
        assert plan.cv_tile * plan.tw <= MAX_BLOCK_THREADS and max(plan.grid[1:]) <= MAX_GRID_YZ


@pytest.mark.parametrize("shape,vec,itemsize", [
    ((2, 9, 9, 12), 4, 2), ((2, 9, 9, 12), 8, 2), ((2, 9, 9, 16), 2, 4), ((2, 9, 9, 16), 8, 4),
])
def test_plan_refuses_lanes_of_the_other_type(shape, vec, itemsize):
    """float32 takes 4 or 1 lanes, bfloat16 8, 2 or 1, each dividing C."""
    with pytest.raises(ValueError, match="lanes"):
        launch_plan(shape, (1, 1), vec, itemsize=itemsize)


@pytest.mark.parametrize("shape,pad,sms", [
    ((2, 9, 7, 16), (2, 1), 132), ((1, 37, 11, 10), (0, 3), 1), ((1, 19, 6, 130), (3, 3), 1),
    ((1, 35, 12, 600), (1, 2), 1),
])
def test_tiled_algorithm_equals_blur4_plain_in_bf16(shape, pad, sms):
    """Every tile of a bfloat16 plan, emulated in float32 (a multiply, then
    an add, per tap, in the kernel's order) and rounded once, gives
    blur4_plain's bfloat16 result bit for bit."""
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32))
    x = x.to(torch.bfloat16)
    taps = (torch.arange(16, dtype=torch.float64) / 120).float().tolist()
    want = blur4_plain(x, taps, pad)
    for vec in {_bf16_lanes(shape[3]), 1}:
        plan = launch_plan(shape, pad, vec, sms, itemsize=2)
        got, stores = _emulate(x.float(), taps, plan)
        assert bool((stores == 1).all())
        torch.testing.assert_close(got.to(torch.bfloat16), want, rtol=0, atol=0)


# -- the 1024px path ------------------------------------------------------------

def _path_cases_1024():
    """(input shape, pad) of every blur on the 1024px paths, forward and
    backward: the full-width generator's 8 up-blurs at batch 16, the path
    batch 8 and FID's batch 64, the 11x student's at 16 and 8 (widths down
    to 20 and 10), and the discriminator's 16 at batch 16."""
    full = default_net_shape(1024)
    student = tuple(c - int(c * 0.7) for c in full)
    cases = []
    for batch, nets in ((16, (full, student)), (8, (full, student)), (64, (full,))):
        for ns in nets:
            cases += [((batch, 2 ** r + 1, 2 ** r + 1, ns[2 * (r - 2)]), (1, 1))
                      for r in range(3, 11)]
    ch = DiscriminatorConfig(size=1024).channels()
    cases += [((16, 1024 >> i, 1024 >> i, ch[1024 >> i]), pad)
              for i in range(8) for pad in ((2, 2), (1, 1))]
    backward = []
    for (b, h, w, c), (p0, p1) in cases:
        grow = p0 + p1 - 3
        backward.append(((b, h + grow, w + grow, c), (3 - p0, 3 - p1)))
    return cases + backward


PATH_CASES_1024 = _path_cases_1024()


def test_1024_path_cases_are_the_paths_blurs():
    """The student's up-blurs reach C = 20 and 10 at 512 and 1024; float32
    lanes: float4 at 20 and the full widths, scalar at 154, 77, 39 and 10;
    bfloat16: 16 bytes at the full widths, pairs at 154 and 20 and 10."""
    student_c = [s[3] for s, _ in PATH_CASES_1024[8:16]]
    assert student_c == [154, 154, 154, 154, 77, 39, 20, 10]
    assert [lane_width(c, 0, 0) for c in student_c] == [1, 1, 1, 1, 1, 1, 4, 1]
    assert [_bf16_lanes(c) for c in student_c] == [2, 2, 2, 2, 1, 1, 2, 2]
    full = [s for s, _ in PATH_CASES_1024[:8] + PATH_CASES_1024[40:56]]
    assert {s[3] for s in full} == {512, 256, 128, 64, 32}
    assert {lane_width(s[3], 0, 0) for s in full} == {4}
    assert {_bf16_lanes(s[3]) for s in full} == {8}
    assert len(PATH_CASES_1024) == 2 * (5 * 8 + 16)


def _covers_once(plan):
    """Every output element of an image in exactly one tile: the tiles are
    column tiles x channel tiles (x) by strips (y), so the check runs over x
    and y apart, and each block's window is the rows and columns its
    outputs read."""
    _, ho, wo, c = plan.out_shape
    cols = np.zeros((wo, c), np.int32)
    for bx in range(plan.grid[0]):
        _, cs, chans = plan.tile(bx, 0)
        cols[cs.start:cs.stop, chans.start:chans.stop] += 1
    rows = np.zeros(ho, np.int32)
    for by in range(plan.grid[1]):
        rs, cs, _ = plan.tile(0, by)
        rows[rs.start:rs.stop] += 1
        if plan.window(0, by) != (range(rs.start - plan.pad[0], rs.stop - plan.pad[0] + 3),
                                  range(cs.start - plan.pad[0], cs.stop - plan.pad[0] + 3)):
            return False
    return bool((cols == 1).all() and (rows == 1).all())


@pytest.mark.parametrize("shape,pad", PATH_CASES_1024)
def test_1024_plans_cover_every_output_and_fit_the_card(shape, pad):
    """In both types, at the lanes the aligned tensors take and at one
    lane: the grid's z is the batch, the tiles cover every output once,
    and the block, strips and grid stay in the card's limits and fill its
    132 SMs twice or run 1-row strips."""
    for itemsize, wide in ((4, lane_width(shape[3], 0, 0)), (2, _bf16_lanes(shape[3]))):
        for vec in {wide, 1}:
            plan = launch_plan(shape, pad, vec, itemsize=itemsize)
            assert plan.grid[2] == shape[0] and plan.vec == vec
            assert _covers_once(plan)
            assert plan.cv_tile * plan.tw <= MAX_BLOCK_THREADS and plan.smem_bytes == 0
            assert max(plan.grid[1:]) <= MAX_GRID_YZ
            assert plan.th == 1 or np.prod(plan.grid) >= 2 * 132


def test_1024_plan_of_the_student_at_c10():
    """[16, 1025, 1025, 10], pad (1, 1), scalar lanes: blocks of 10 x 25
    threads, 41 column tiles, 32 strips of 32 rows, 16 images."""
    plan = launch_plan((16, 1025, 1025, 10), (1, 1), 1)
    assert (plan.cv_tile, plan.tw, plan.th, plan.grid) == (10, 25, 32, (41, 32, 16))


@pytest.mark.parametrize("c", [20, 10])
def test_tiled_algorithm_on_the_1024_student_blurs(c):
    """The student's up-blur at 1024 at batch 1, float32 and bfloat16, at
    every lane width it can take: blocks at the corners and the middle of
    the plan, emulated, give blur4_plain's output there (float32 to 1e-6 *
    max|x|, bfloat16 bit for bit)."""
    shape, pad = (1, 1025, 1025, c), (1, 1)
    x = torch.from_numpy(np.random.RandomState(c).randn(*shape).astype(np.float32))
    taps = (torch.arange(16, dtype=torch.float64) / 120).float().tolist()
    for dtype, itemsize in ((torch.float32, 4), (torch.bfloat16, 2)):
        xd = x.to(dtype)
        want = blur4_plain(xd, taps, pad)
        for vec in [v for v in LANES[itemsize] if c % v == 0]:
            plan = launch_plan(shape, pad, vec, itemsize=itemsize)
            gx, gy, _ = plan.grid
            blocks = [(0, 0), (gx - 1, 0), (gx // 2, gy // 2), (0, gy - 1), (gx - 1, gy - 1)]
            got, stores = _emulate(xd.float(), taps, plan, blocks)
            for bx, by in blocks:
                rows, cols, chans = plan.tile(bx, by)
                tile = (slice(None), slice(rows.start, rows.stop), slice(cols.start, cols.stop),
                        slice(chans.start, chans.stop))
                assert bool((stores[tile[1:]] == 1).all())
                if dtype == torch.float32:
                    torch.testing.assert_close(got[tile], want[tile], rtol=0,
                                               atol=1e-6 * x.abs().max().item())
                else:
                    torch.testing.assert_close(got[tile].to(dtype), want[tile], rtol=0, atol=0)
