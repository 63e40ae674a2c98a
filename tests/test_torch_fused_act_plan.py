"""The epilogue's and masked_scale's lane plans (``ops/cuda/lanes.py``) on the
CPU: the path shapes ``bench_fused_act`` times against the generator's own
epilogues, the lanes' cover of every element, the switch to 64-bit offsets,
the multiply-high division, the bias table's banks, and a PyTorch emulation
of the kernel ``csrc/fused_noise_bias_lrelu.cu`` (per-lane division, channel
and noise stepping, the shared-memory bias table) driven by the plan, held
against ``fused_noise_bias_lrelu_plain`` bit for bit and against the JAX
package's epilogue. The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``)."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from content_aware_gan_compression_tpu.ops.pallas import (
    fused_noise_bias_lrelu as jax_fused_noise_bias_lrelu)
from content_aware_gan_compression_torch import bench_fused_act
from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
from content_aware_gan_compression_torch.ops.cuda import (
    build, epilogue_plan, fused_noise_bias_lrelu_plain, lane_plan)
from content_aware_gan_compression_torch.ops.cuda.lanes import (
    LANES, MAX_GRID_X, PATHS, bias_slot, bias_slots, magic_divide, magic_divider)
from torch_train_util import torch_threads  # noqa: F401

PATH_SHAPES = bench_fused_act.path_shapes()
WIDTHS = (1, 3, 10, 20, 39, 77, 128, 154)


@pytest.mark.parametrize("size,widths", [(s, w) for s in (256, 1024)
                                         for w in ("full", "student")])
def test_path_shapes_are_the_generators_epilogues(size, widths, monkeypatch):
    """A shapes-only forward (``meta`` tensors, the plain routes recording
    each epilogue) of the generator at each listed batch launches exactly
    the listed shapes, in order, with per-sample noise."""
    blur4_mod = importlib.import_module("content_aware_gan_compression_torch.ops.cuda.blur4")
    fnbl_mod = importlib.import_module(
        "content_aware_gan_compression_torch.ops.cuda.fused_noise_bias_lrelu")
    seen = []

    def record(x, noise, bias, nw):
        seen.append((tuple(x.shape), noise.shape[0]))
        return fused_noise_bias_lrelu_plain(x, noise, bias, nw)
    monkeypatch.setattr(blur4_mod, "_run",
                        lambda x, taps, pad, backward: blur4_mod.blur4_plain(x, taps, pad))
    monkeypatch.setattr(fnbl_mod, "_run", record)
    entries = [e for e in PATH_SHAPES if (e["size"], e["widths"]) == (size, widths)]
    assert [e["batch"] for e in entries] == [16, 8, 64, 10, 1]
    net_shape = GeneratorConfig(size=size).net_shape
    if widths == "student":
        net_shape = tuple(c - int(c * 0.7) for c in net_shape)
    g = Generator(GeneratorConfig(size=size, net_shape=net_shape), device="meta")
    for entry in entries:
        seen.clear()
        b = entry["batch"]
        with torch.no_grad():
            g([torch.empty(b, 512, device="meta")], noise=g.make_noise(b))
        assert seen == [(s, b) for s in entry["shapes"]]
    if (size, widths) == (256, "student"):  # the pruned widths, none a multiple of 8
        assert [s[3] for s in entries[0]["shapes"]][-5:] == [154, 77, 77, 39, 39]
    if (size, widths) == (1024, "student"):
        assert [s[3] for s in entries[0]["shapes"]][-4:] == [20, 20, 10, 10]


def _hits(plan):
    """How often each element is taken, over every (block, thread)."""
    hits = np.zeros(plan.n, np.int64)
    for block in range(plan.blocks):
        for thread in range(plan.threads):
            for lane in plan.lanes_of(block, thread):
                hits[plan.elements(lane).start:plan.elements(lane).stop] += 1
    return hits


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n,threads,vectors", [
    (0, 256, 2), (1, 32, 1), (7, 64, 4), (8, 32, 2), (9, 128, 1), (1000, 32, 4),
    (4099, 256, 2), (3 * 5 * 7 * 39, 512, 4), (16 * 4 * 4 * 154, 128, 2)])
def test_plan_covers_every_element_once(n, threads, vectors, itemsize):
    """Body plus tail: every element in exactly one lane of one thread; the
    16-byte body runs only for aligned pointers, over the full lanes."""
    lanes = LANES[itemsize]
    for aligned in (True, False):
        plan = lane_plan(n, itemsize, aligned, threads, vectors)
        assert np.all(_hits(plan) == 1)
        assert plan.full_lanes * lanes + plan.tail == n and 0 <= plan.tail < lanes
        assert plan.vector_body == (aligned and n >= lanes)
        assert not plan.wide_index
        # a lane's first byte sits on a 16-byte boundary of an aligned tensor
        assert all(lane * lanes * itemsize % 16 == 0 for lane in range(plan.full_lanes))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_offsets_turn_64_bit_at_2_31(itemsize):
    """Planning only: 32-bit offsets up to 2^31 - 1 elements, 64-bit from
    2^31, the grid inside the card's limit."""
    for n, wide in ((2 ** 31 - 1, False), (2 ** 31, True), (3 * 2 ** 31, True)):
        plan = lane_plan(n, itemsize, True)
        assert plan.wide_index == wide and plan.blocks <= MAX_GRID_X
    assert epilogue_plan((64, 1024, 1024, 32), 64, itemsize, True).wide_index  # FID's 2^31
    assert not epilogue_plan((16, 1024, 1024, 32), 16, itemsize, True).wide_index
    assert not epilogue_plan((16, 1024, 1024, 10), 1, itemsize, True).wide_index


def test_magic_division_is_exact_below_2_31():
    """umulhi(n, mul) + n, shifted, is n // d for every n < 2^31: at the
    paths' C and H*W and at the divisors' edges, on edge and random n."""
    rng = np.random.RandomState(0)
    numerators = np.concatenate([np.arange(4096), 2 ** 31 - 1 - np.arange(4096),
                                 rng.randint(0, 2 ** 31, 20000)]).astype(np.uint64)
    divisors = list(WIDTHS) + [32, 64, 256, 512] + [4 ** k for k in range(2, 11)] + [
        2, 5, 7, 2 ** 16 + 1, 2 ** 30 + 3, 2 ** 31 - 1, 1000003]
    for d in divisors:
        mul, shift = magic_divider(d)
        got = (((numerators * np.uint64(mul)) >> np.uint64(32)) + numerators) >> np.uint64(shift)
        np.testing.assert_array_equal(got, numerators // np.uint64(d), err_msg=f"d={d}")
        assert magic_divide(2 ** 31 - 1, mul, shift) == (2 ** 31 - 1) // d


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", [154, 77, 39, 20, 10, 128, 32, 512])
def test_bias_table_spreads_a_warps_reads_over_the_banks(c, itemsize):
    """A warp's 32 lanes start L channels apart; with the padding slot after
    every L entries, each of their L reads from the table touches at most 2
    words in one bank (up to 8 without it)."""
    lanes = LANES[itemsize]
    worst = 0
    for warp in range(64):
        for k in range(lanes):
            banks = {}
            for t in range(32):
                s = bias_slot((warp * 32 + t) * lanes % c + k, lanes)
                banks.setdefault(s % 32, set()).add(s)
            worst = max(worst, max(len(words) for words in banks.values()))
    assert worst <= 2
    assert bias_slots(c, lanes) * 4 == epilogue_plan((1, 4, 4, c), 1, itemsize, True,
                                                     bias_aligned=False).smem_bytes


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", WIDTHS + (8, 16, 32, 64, 256, 512))
def test_plan_picks_the_lane_path_by_width(c, itemsize):
    """Aligned (bias as one vector, no shared memory) where the lane divides
    C and bias is 16-byte aligned; wide where C >= the lane; narrow below."""
    lanes = LANES[itemsize]
    for bias_aligned in (True, False):
        plan = epilogue_plan((2, 4, 4, c), 2, itemsize, True, bias_aligned=bias_aligned)
        want = ("aligned" if c % lanes == 0 and bias_aligned else "wide" if c >= lanes
                else "narrow")
        assert plan.path == PATHS[want]
        assert (plan.smem_bytes == 0) == (want == "aligned")


def _emulate(x, noise, bias, nw, plan):
    """The kernel's arithmetic on the plan's lanes: the per-lane division;
    on the aligned path one pixel and bias read directly, on the wide path
    the two-pixel rule, on the narrow one value-by-value stepping, the two
    with the bias table and its padding slots; float32, rounded once to x's
    type."""
    lanes, n, c, hw = plan.lanes, plan.n, plan.c, plan.hw
    xf, nf = x.float().reshape(-1), noise.float().reshape(-1)
    w = nw.float().reshape(())
    table = torch.full((bias_slots(c, lanes),), float("nan"))
    for j in range(c + lanes):
        table[bias_slot(j, lanes)] = bias.float()[j % c]
    e = torch.arange(plan.n_lanes, dtype=torch.int64) * lanes
    pix = magic_divide(e, *plan.c_div)
    c0 = e - pix * c
    q = pix - magic_divide(pix, *plan.hw_div) * hw if plan.bcast else pix
    out = torch.full((n,), float("nan"))
    if plan.path == PATHS["aligned"]:
        table = bias.float()  # a lane's channels c0 .. c0 + L - 1 never wrap
        noise_k = [w * nf[q]] * lanes
    elif plan.path == PATHS["wide"]:
        wrap = c - c0
        q1 = q + 1
        if plan.bcast:
            q1 = torch.where(q1 == hw, 0, q1)
        second = (wrap < lanes) & (e + wrap < n)
        n0 = nf[q]
        n1 = torch.where(second, nf[torch.where(second, q1, q)], n0)
        noise_k = [torch.where(k < wrap, w * n0, w * n1) for k in range(lanes)]
    else:
        noise_k, cc, qk = [], c0.clone(), q.clone()
        for k in range(lanes):
            noise_k.append(w * nf[torch.where(e + k < n, qk, 0)])
            cc += 1
            qk = torch.where(cc == c, qk + 1, qk)
            cc = torch.where(cc == c, 0, cc)
            if plan.bcast:
                qk = torch.where(qk == hw, 0, qk)
    for k in range(lanes):
        idx = e + k
        live = idx < n
        j = c0 + k
        b = table[j] if plan.path == PATHS["aligned"] else table[j + j // lanes]
        pre = (xf[idx[live]] + noise_k[k][live]) + b[live]
        out[idx[live]] = torch.where(pre >= 0, pre, pre * 0.2) * math.sqrt(2.0)
    return out.reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noise_batch", ["B", 1])
@pytest.mark.parametrize("c", WIDTHS + (8, 16))
def test_emulated_lanes_equal_the_plain_epilogue(c, noise_batch, dtype):
    """Bit for bit, with a partial last lane (n = 45 * C) and H*W = 15, so
    a broadcast noise buffer wraps inside lanes."""
    rng = np.random.RandomState(c)
    shape = (3, 3, 5, c)
    nb = shape[0] if noise_batch == "B" else 1
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    noise = torch.from_numpy(rng.randn(nb, 3, 5, 1).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(0.5 * rng.randn(c).astype(np.float32)).to(dtype)
    nw = torch.tensor([0.7]).to(dtype)
    itemsize = x.element_size()
    want = fused_noise_bias_lrelu_plain(x, noise, bias, nw)
    # the same lanes, loaded whole or element by element; each path the
    # width and the bias's alignment allow
    for aligned, bias_aligned in ((True, True), (False, True), (True, False)):
        plan = epilogue_plan(shape, nb, itemsize, aligned, threads=32, vectors=4,
                             bias_aligned=bias_aligned)
        assert plan.bcast == (nb == 1)
        assert torch.equal(_emulate(x, noise, bias, nw, plan), want)


@pytest.mark.parametrize("c", [154, 77, 39, 20, 10])
def test_emulated_lanes_at_the_students_widths_match_jax(c):
    """The JAX package's epilogue (its Pallas kernel in interpret mode) on
    the same inputs, float32, to 1e-6 of the largest value."""
    rng = np.random.RandomState(100 + c)
    shape = (2, 4, 4, c)
    x = rng.randn(*shape).astype(np.float32)
    noise = rng.randn(2, 4, 4, 1).astype(np.float32)
    bias = (0.5 * rng.randn(c)).astype(np.float32)
    nw = np.asarray([0.7], np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_noise_bias_lrelu(
            jnp.asarray(x), jnp.asarray(noise), jnp.asarray(bias), jnp.asarray(nw[0])))
    got = _emulate(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(bias),
                   torch.from_numpy(nw), epilogue_plan(shape, 2, 4, True)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kwargs,why", [
    (dict(threads=48), "multiple of 32"), (dict(threads=1024), "multiple of 32"),
    (dict(vectors=3), "lanes per thread"), (dict(threads=0), "multiple of 32")])
def test_plans_refuse_what_the_kernels_do_not_take(kwargs, why):
    with pytest.raises(ValueError, match=why):
        lane_plan(1000, 4, True, **kwargs)
    with pytest.raises(ValueError, match=why):
        epilogue_plan((2, 4, 4, 10), 2, 2, True, **kwargs)


def test_epilogue_plan_refuses_bad_noise_and_a_bias_past_shared_memory():
    with pytest.raises(ValueError, match="noise batch"):
        epilogue_plan((4, 4, 4, 10), 2, 4, True)
    with pytest.raises(ValueError, match="shared memory"):
        epilogue_plan((1, 2, 2, 12001), 1, 4, True)
    # the aligned path stages no bias table
    assert epilogue_plan((1, 2, 2, 12000), 1, 4, True).smem_bytes == 0


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    """A source includes csrc/lanes.cuh: editing the header renames the
    library, so a stale build is never loaded."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "masked_scale.cu").write_text('#include "lanes.cuh"\n')
    (src / "lanes.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    first = build.library_path("masked_scale")
    assert build.library_path("masked_scale") == first
    (src / "lanes.cuh").write_text("// v2\n")
    assert build.library_path("masked_scale") != first
