"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no CPU mode, so every test here needs a card and
skips without one. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have). This file imports no JAX."""

import contextlib
import importlib

import pytest
import torch

from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
from content_aware_gan_compression_torch.ops import make_kernel
from content_aware_gan_compression_torch.ops.cuda import (
    blur4, blur4_plain, correlation_taps, counts, fused_noise_bias_lrelu,
    fused_noise_bias_lrelu_plain, masked_scale, masked_scale_plain, reset_counts,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# the 11x student's up-blurs at batch 16: net_shape (154,)*10 + (77,77,39,39)
STUDENT_BLURS = [(16, 2 ** r + 1, 2 ** r + 1, c)
                 for r, c in zip(range(3, 9), (154, 154, 154, 154, 77, 39))]


@pytest.mark.parametrize("shape,pad,gain", [
    ((2, 9, 9, 512), (1, 1), 4.0), ((2, 17, 17, 256), (1, 1), 4.0),
    ((3, 13, 9, 3), (2, 1), 1.0), ((2, 17, 11, 12), (2, 2), 4.0),
    ((2, 10, 15, 130), (1, 1), 1.0), ((1, 7, 7, 130), (2, 1), 4.0),
    *[(s, (1, 1), 4.0) for s in STUDENT_BLURS],
    ((2, 19, 13, 8), (0, 3), 1.0), ((2, 13, 19, 8), (3, 0), 1.0), ((2, 9, 12, 20), (3, 3), 1.0),
    *[((3, 21, 11, c), (2, 1), 1.0) for c in range(1, 6)],
])
def test_blur4_kernel_matches_plain(dev, shape, pad, gain):
    """Tolerance 1e-5 * max|x|: 16 fp32 multiply-adds summed in another
    order (the kernel's FMAs against the plain version's shifted adds)."""
    x = torch.randn(shape, generator=torch.Generator(dev).manual_seed(0), device=dev)
    k = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120  # flip != itself
    got = blur4(x, k, pad, gain)
    want = blur4_plain(x, correlation_taps(k, gain), pad)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * x.abs().max().item())


def _view(shape, offset, dev, seed):
    """A contiguous tensor of ``shape`` that starts ``offset`` floats into
    its storage: with offset 1 it is not 16-byte aligned."""
    n = torch.Size(shape).numel()
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randn(n + offset, generator=gen, device=dev)[offset:].view(shape)


@pytest.mark.parametrize("shape,pad", [((2, 17, 11, 128), (1, 1)), ((16, 33, 33, 154), (2, 2))])
def test_blur4_kernel_on_a_misaligned_view(dev, shape, pad):
    """A view 4 bytes into its storage takes the scalar lanes."""
    x = _view(shape, 1, dev, 5)
    k = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120
    reset_counts()
    got = blur4(x, k, pad, 1.0)
    assert counts()["blur4"] == 1 and counts()["blur4_vector"] == 0
    want = blur4_plain(x, correlation_taps(k, 1.0), pad)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * x.abs().max().item())


@pytest.mark.parametrize("c,offset,vector", [
    (128, 0, 1), (4, 0, 1), (130, 0, 0), (39, 0, 0), (3, 0, 0), (128, 1, 0), (128, 4, 1),
])
def test_blur4_vector_launches_move_only_for_float4_lanes(dev, c, offset, vector):
    """float4 lanes exactly when C % 4 == 0 and the input is 16-byte
    aligned (the output is a fresh allocation). The backward's gradient is
    a fresh tensor too, so it takes float4 lanes whenever C % 4 == 0."""
    x = _view((2, 9, 10, c), offset, dev, 6).requires_grad_(True)
    k = make_kernel([1, 3, 3, 1])
    reset_counts()
    y = blur4(x, k, (1, 1), 4.0)
    assert counts()["blur4_vector"] == vector
    y.backward(torch.ones_like(y))
    assert counts()["blur4_backward"] == 1
    assert counts()["blur4_vector"] == vector + (c % 4 == 0)


@pytest.mark.parametrize("shape,noise_batch", [
    ((16, 4, 4, 512), 16), ((2, 64, 64, 512), 2), ((2, 5, 7, 3), 2), ((2, 6, 6, 130), 1),
])
def test_fused_kernel_matches_plain(dev, shape, noise_batch):
    """The kernel rounds each step as the plain expression does, so they
    agree to 1e-6 relative."""
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=dev)
    noise = torch.randn((noise_batch, *shape[1:3], 1), generator=gen, device=dev)
    bias = torch.randn(shape[3], generator=gen, device=dev)
    nw = torch.tensor([0.7], device=dev)
    got = fused_noise_bias_lrelu(x, noise, bias, nw)
    want = fused_noise_bias_lrelu_plain(x, noise, bias, nw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


def test_kernels_refuse_what_they_do_not_take(dev):
    k = make_kernel([1, 3, 3, 1])
    x = torch.randn(2, 9, 9, 8, device=dev)
    with pytest.raises(ValueError):
        blur4(x.transpose(1, 2), k, (1, 1))  # not contiguous NHWC
    with pytest.raises(TypeError):
        blur4(x.half(), k, (1, 1))
    x = torch.randn(2, 4, 4, 8, device=dev)
    noise, bias, nw = (torch.zeros(2, 4, 4, 1, device=dev), torch.zeros(8, device=dev),
                       torch.zeros(1, device=dev))
    with pytest.raises(ValueError):
        fused_noise_bias_lrelu(x, noise[..., :3, :], bias, nw)
    with pytest.raises(TypeError):
        fused_noise_bias_lrelu(x, noise, bias.double(), nw)
    with pytest.raises(ValueError):
        masked_scale(x, x[:1])
    with pytest.raises(TypeError):
        masked_scale(x.transpose(1, 2), x.transpose(1, 2).contiguous())


@pytest.mark.parametrize("shape,offset", [
    ((16, 8, 8, 154), 0), ((8, 64, 64, 77), 0), ((4, 32, 32, 39), 0), ((3, 5, 7, 3), 0),
    ((2, 6, 6, 130), 1),  # 4-byte offset: the scalar path for every element
])
def test_masked_scale_kernel_matches_plain(dev, shape, offset):
    """Bit for bit: the kernel rounds as the plain expression does. Exact
    zeros in ``out`` take the mask 1, as in JAX."""
    gen = torch.Generator(dev).manual_seed(2)
    n = torch.Size(shape).numel()
    g = torch.randn(n + offset, generator=gen, device=dev)[offset:].view(shape)
    out = torch.randn(n + offset, generator=gen, device=dev)[offset:].view(shape)
    out.view(-1)[:5] = 0.0
    torch.testing.assert_close(masked_scale(g, out), masked_scale_plain(g, out), rtol=0, atol=0)


def _plain_twin(fn_kernel, fn_plain, *args):
    """First and second derivatives of sum(f^3) through the Function on the
    card and through the plain version under autograd, on the same inputs.
    The cube and the squares run in float32 at least, so that in bfloat16
    the two sides round only inside the functions held against each other."""
    results = []
    for fn in (fn_kernel, fn_plain):
        if fn is None:  # one side only
            continue
        xs = [a.detach().clone().requires_grad_(a.requires_grad) for a in args]
        y = fn(*xs)
        wrt = [x for x in xs if x.requires_grad]
        g = torch.autograd.grad(_f32_up(y).pow(3).sum(), wrt, create_graph=True)
        gg = torch.autograd.grad(sum(_f32_up(t).pow(2).sum() for t in g), wrt)
        results.append((g, gg))
    return results


def _f32_up(t):
    return t.to(torch.promote_types(t.dtype, torch.float32))


@pytest.mark.parametrize("shape,pad,gain", [
    ((4, 9, 9, 154), (1, 1), 4.0),  # the student's up-blur
    ((4, 64, 64, 64), (2, 2), 1.0), ((4, 64, 64, 64), (1, 1), 1.0),  # D's down-blurs
    ((2, 11, 7, 3), (2, 1), 4.0),
    (STUDENT_BLURS[-1], (1, 1), 4.0), (STUDENT_BLURS[-2], (1, 1), 4.0),
    ((2, 19, 13, 8), (0, 3), 1.0), ((2, 13, 19, 5), (3, 0), 1.0),
])
def test_blur4_backward_matches_plain_to_second_order(dev, shape, pad, gain):
    """Blur4Fn's backward and double backward launch blur4 again; tolerance
    1e-5 of the largest gradient (16-tap sums reordered, twice)."""
    x = torch.randn(shape, generator=torch.Generator(dev).manual_seed(3), device=dev,
                    requires_grad=True)
    k = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120
    reset_counts()
    (g, gg), (pg, pgg) = _plain_twin(lambda x: blur4(x, k, pad, gain),
                                     lambda x: blur4_plain(x, correlation_taps(k, gain), pad), x)
    assert counts()["blur4"] == 1 and counts()["blur4_backward"] >= 2
    for a, b in ((g[0], pg[0]), (gg[0], pgg[0])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("shape,noise_batch", [((16, 8, 8, 154), 16), ((8, 32, 32, 39), 1)])
def test_epilogue_backward_matches_plain_to_second_order(dev, shape, noise_batch):
    """FusedNoiseBiasLReLUFn's backward runs masked_scale, its double
    backward masked_scale again; dx, dbias, dnw and their second order
    against autograd of the plain expression (1e-5 of the largest value:
    the reductions sum in another order)."""
    gen = torch.Generator(dev).manual_seed(4)
    x = torch.randn(shape, generator=gen, device=dev, requires_grad=True)
    noise = torch.randn((noise_batch, *shape[1:3], 1), generator=gen, device=dev)
    bias = torch.randn(shape[3], generator=gen, device=dev, requires_grad=True)
    nw = torch.tensor([0.7], device=dev, requires_grad=True)
    reset_counts()
    (g, gg), (pg, pgg) = _plain_twin(fused_noise_bias_lrelu, fused_noise_bias_lrelu_plain,
                                     x, noise, bias, nw)
    assert counts()["fused_noise_bias_lrelu"] == 1 and counts()["masked_scale"] >= 2
    for a, b in (*zip(g, pg), *zip(gg, pgg)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


def test_generator_on_card_launches_the_kernels_and_matches_the_cpu(dev):
    """A small generator: one blur4 launch per up-conv and one epilogue
    launch per StyledConv, and the image within 1e-4 of the CPU plain path
    with TF32 off."""
    cfg = GeneratorConfig(size=32, style_dim=16, n_mlp=2, net_shape=(32, 24, 24, 16, 16, 12, 12, 8))
    g_cpu = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = Generator(cfg, device=dev)
    g.load_state_dict(g_cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(2, cfg.style_dim, generator=gen)
    noise = g_cpu.make_noise(2, gen)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            blur4.launches = fused_noise_bias_lrelu.launches = 0
            got = g([z.to(dev)], noise=[n.to(dev) for n in noise]).cpu()
            launches = (blur4.launches, fused_noise_bias_lrelu.launches)
            want = g_cpu([z], noise=noise)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert launches == (cfg.log_size - 2, cfg.num_layers)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# -- bfloat16 -------------------------------------------------------------------

BF16_EPS = 2.0 ** -7  # the spacing of bfloat16 values in [1, 2)


@pytest.mark.parametrize("shape,pad,gain", [
    ((2, 9, 9, 512), (1, 1), 4.0), ((2, 17, 17, 256), (1, 1), 4.0),
    ((2, 32, 32, 128), (2, 2), 1.0), ((3, 13, 9, 3), (2, 1), 1.0),
    ((2, 10, 15, 130), (1, 1), 1.0), ((2, 17, 11, 12), (2, 2), 4.0),
    *[(s, (1, 1), 4.0) for s in STUDENT_BLURS],
    ((2, 19, 13, 8), (0, 3), 1.0), ((2, 13, 19, 8), (3, 0), 1.0),
    *[((3, 21, 11, c), (2, 1), 1.0) for c in range(1, 6)],
])
def test_blur4_bf16_kernel_equals_plain(dev, shape, pad, gain):
    """Both sum in float32 in one order, a multiply then an add per tap, and
    round once: bit for bit."""
    x = torch.randn(shape, generator=torch.Generator(dev).manual_seed(0), device=dev)
    x = x.to(torch.bfloat16)
    k = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120
    reset_counts()
    got = blur4(x, k, pad, gain)
    assert counts()["blur4_bf16"] == counts()["blur4"] == 1
    torch.testing.assert_close(got, blur4_plain(x, correlation_taps(k, gain), pad), rtol=0,
                               atol=0)


@pytest.mark.parametrize("c,offset,lanes", [
    (128, 0, 8), (512, 0, 8), (154, 0, 2), (130, 0, 2), (77, 0, 1), (39, 0, 1),
    (128, 1, 1), (128, 2, 2), (128, 8, 8), (12, 4, 2),
])
def test_blur4_bf16_lanes(dev, c, offset, lanes):
    """16-byte lanes (8 values) when C % 8 == 0 and the input is 16-byte
    aligned, pairs when C is even and it is 4-byte aligned, else single
    values; each bit for bit the plain version. ``offset`` is in
    elements."""
    from content_aware_gan_compression_torch.ops.cuda import lane_width

    x = _view((2, 9, 10, c), offset, dev, 6).to(torch.bfloat16)
    x = torch.cat([x.new_zeros(offset), x.reshape(-1)])[offset:].view(x.shape)
    assert lane_width(c, x.data_ptr(), itemsize=2) == lanes
    k = make_kernel([1, 3, 3, 1])
    reset_counts()
    got = blur4(x, k, (1, 1), 4.0)
    assert counts()["blur4_vector_bf16"] == counts()["blur4_vector"] == (lanes == 8)
    torch.testing.assert_close(got, blur4_plain(x, correlation_taps(k, 4.0), (1, 1)), rtol=0,
                               atol=0)


@pytest.mark.parametrize("shape,noise_batch", [
    ((16, 4, 4, 512), 16), ((2, 64, 64, 512), 2), ((16, 8, 8, 154), 16), ((2, 5, 7, 3), 2),
    ((2, 6, 6, 130), 1),
])
def test_fused_bf16_kernel_equals_plain(dev, shape, noise_batch):
    """float32 arithmetic in the plain version's order, one rounding at the
    end: bit for bit."""
    gen = torch.Generator(dev).manual_seed(1)
    bf = torch.bfloat16
    x = torch.randn(shape, generator=gen, device=dev).to(bf)
    noise = torch.randn((noise_batch, *shape[1:3], 1), generator=gen, device=dev).to(bf)
    bias = torch.randn(shape[3], generator=gen, device=dev).to(bf)
    nw = torch.tensor([0.7], device=dev).to(bf)
    reset_counts()
    got = fused_noise_bias_lrelu(x, noise, bias, nw)
    assert counts()["fused_noise_bias_lrelu_bf16"] == 1 and got.dtype == bf
    torch.testing.assert_close(got, fused_noise_bias_lrelu_plain(x, noise, bias, nw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,offset", [
    ((16, 8, 8, 154), 0), ((8, 64, 64, 77), 0), ((4, 32, 32, 39), 0), ((3, 5, 7, 3), 0),
    ((2, 6, 6, 130), 1),
])
def test_masked_scale_bf16_kernel_equals_plain(dev, shape, offset):
    gen = torch.Generator(dev).manual_seed(2)
    n = torch.Size(shape).numel()
    g = torch.randn(n + offset, generator=gen, device=dev).to(torch.bfloat16)[offset:]
    out = torch.randn(n + offset, generator=gen, device=dev).to(torch.bfloat16)[offset:]
    g, out = g.view(shape), out.view(shape)
    out.view(-1)[:5] = 0.0
    reset_counts()
    got = masked_scale(g, out)
    assert counts()["masked_scale_bf16"] == 1
    torch.testing.assert_close(got, masked_scale_plain(g, out), rtol=0, atol=0)


@pytest.mark.parametrize("shape,pad,gain", [
    ((4, 9, 9, 154), (1, 1), 4.0), ((4, 64, 64, 64), (2, 2), 1.0),
    ((2, 11, 7, 3), (2, 1), 4.0), (STUDENT_BLURS[-1], (1, 1), 4.0),
])
def test_blur4_bf16_backward_to_second_order(dev, shape, pad, gain):
    """bfloat16 first and second derivatives within 2^-7 of the plain
    version's largest value."""
    x = torch.randn(shape, generator=torch.Generator(dev).manual_seed(3), device=dev)
    x = x.to(torch.bfloat16).requires_grad_(True)
    k = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120
    reset_counts()
    (g, gg), (pg, pgg) = _plain_twin(lambda x: blur4(x, k, pad, gain),
                                     lambda x: blur4_plain(x, correlation_taps(k, gain), pad), x)
    assert counts()["blur4_backward_bf16"] == counts()["blur4_backward"] >= 2
    for a, b in ((g[0], pg[0]), (gg[0], pgg[0])):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=BF16_EPS * b.float().abs().max().item())


@contextlib.contextmanager
def plain_routes():
    """The three wrappers take their plain versions on the card too, inside
    the same autograd Functions: the kernels' arithmetic swapped for the
    plain one, the backward's structure kept."""
    b4 = importlib.import_module("content_aware_gan_compression_torch.ops.cuda.blur4")
    fn = importlib.import_module(
        "content_aware_gan_compression_torch.ops.cuda.fused_noise_bias_lrelu")
    ms = importlib.import_module("content_aware_gan_compression_torch.ops.cuda.masked_scale")

    def plain_ms(g, out):
        return masked_scale_plain(g, out)
    plain_ms.grad_copies = 0
    saved = b4._run, fn._run, ms.masked_scale
    b4._run = lambda x, taps, pad, backward: blur4_plain(x, taps, pad)
    fn._run, ms.masked_scale = fused_noise_bias_lrelu_plain, plain_ms
    try:
        yield
    finally:
        b4._run, fn._run, ms.masked_scale = saved


def _function_twin(fn, *args):
    """_plain_twin's derivatives of ``fn`` with the kernels and of ``fn``
    under ``plain_routes``, each run once."""
    with plain_routes():
        plain = _plain_twin(fn, fn, *args)[0]
    return _plain_twin(fn, None, *args)[0], plain


@pytest.mark.parametrize("shape,noise_batch", [((16, 8, 8, 154), 16), ((8, 32, 32, 39), 1)])
def test_epilogue_bf16_backward_to_second_order(dev, shape, noise_batch):
    """In bfloat16 the backward sums the rounded dx for the noise, bias and
    noise-weight gradients, as the JAX package's _bwd_vjp does, where
    autograd of the plain expression sums the unrounded one; a second order
    makes that up to 1.3% of its largest value at these shapes. So the
    kernels are held, to 2^-7 of the largest value, against the same
    Function with the plain versions in their place."""
    gen = torch.Generator(dev).manual_seed(4)
    bf = torch.bfloat16
    x = torch.randn(shape, generator=gen, device=dev).to(bf).requires_grad_(True)
    noise = torch.randn((noise_batch, *shape[1:3], 1), generator=gen, device=dev).to(bf)
    noise.requires_grad_(True)
    bias = torch.randn(shape[3], generator=gen, device=dev).to(bf).requires_grad_(True)
    nw = torch.tensor([0.7], device=dev).to(bf).requires_grad_(True)
    reset_counts()
    (g, gg), (pg, pgg) = _function_twin(fused_noise_bias_lrelu, x, noise, bias, nw)
    assert counts()["fused_noise_bias_lrelu_bf16"] == 1 and counts()["masked_scale_bf16"] >= 2
    for a, b in (*zip(g, pg), *zip(gg, pgg)):
        assert a.dtype == bf
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=BF16_EPS * b.float().abs().max().item())


def test_bf16_generator_launches_only_bf16_kernels(dev):
    """The generator in bfloat16 on the card: every blur4 and epilogue launch
    is a bfloat16 one, and its image is near the float32 image."""
    cfg = GeneratorConfig(size=32, style_dim=16, n_mlp=2, net_shape=(32, 24, 24, 16, 16, 12, 12, 8))
    g = Generator(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(dev).manual_seed(1)
    z = torch.randn(2, cfg.style_dim, generator=gen, device=dev)
    noise = g.make_noise(2, gen)
    with torch.inference_mode():
        want = g([z], noise=noise)
        reset_counts()
        got = g([z], noise=noise, dtype=torch.bfloat16)
        c = counts()
    assert c["blur4"] == c["blur4_bf16"] == cfg.log_size - 2
    assert c["fused_noise_bias_lrelu"] == c["fused_noise_bias_lrelu_bf16"] == cfg.num_layers
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, rtol=0, atol=0.1 * want.abs().max().item())



# every width the lanes treat differently: C below, at and above the
# 16-byte lane (4 float32, 8 bfloat16 values), multiples of it, and the
# student's
EVERY_WIDTH = list(range(1, 10)) + [16, 32, 154, 77, 39, 20, 10]


def _epilogue_inputs(shape, noise_batch, dtype, gen, offset=0, bias_offset=0):
    dev = gen.device
    n = torch.Size(shape).numel()
    x = torch.randn(n + offset, generator=gen, device=dev).to(dtype)[offset:].view(shape)
    noise = torch.randn((noise_batch, *shape[1:3], 1), generator=gen, device=dev).to(dtype)
    bias = torch.randn(shape[3] + bias_offset, generator=gen, device=dev).to(dtype)[bias_offset:]
    return x, noise, bias, torch.tensor([0.7], device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", EVERY_WIDTH)
def test_fused_kernel_at_every_width(dev, c, dtype):
    """Bit for bit at C = 1-9, multiples of the lane and the student's
    widths, per-sample and broadcast noise, a partial last lane (3 * 5 * 7 *
    C elements), a misaligned x (element by element), a misaligned bias (off
    the aligned path) and a shape past 32 lanes a warp; the aligned launches
    take the 16-byte body."""
    gen = torch.Generator(dev).manual_seed(c)
    for shape, noise_batch, offset, bias_offset in [
            ((3, 5, 7, c), 3, 0, 0), ((3, 5, 7, c), 1, 0, 0), ((3, 5, 7, c), 3, 1, 0),
            ((3, 5, 7, c), 3, 0, 1), ((16, 16, 16, c), 1, 0, 0), ((16, 32, 32, c), 16, 0, 0)]:
        x, noise, bias, nw = _epilogue_inputs(shape, noise_batch, dtype, gen, offset,
                                              bias_offset)
        reset_counts()
        got = fused_noise_bias_lrelu(x, noise, bias, nw)
        assert counts()["fused_noise_bias_lrelu_vector"] == (offset == 0)
        torch.testing.assert_close(got, fused_noise_bias_lrelu_plain(x, noise, bias, nw),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", EVERY_WIDTH)
def test_masked_scale_kernel_at_every_width(dev, c, dtype):
    gen = torch.Generator(dev).manual_seed(c)
    for shape, offset in [((3, 5, 7, c), 0), ((3, 5, 7, c), 1), ((16, 32, 32, c), 0)]:
        n = torch.Size(shape).numel()
        g = torch.randn(n + offset, generator=gen, device=dev).to(dtype)[offset:].view(shape)
        out = torch.randn(n + offset, generator=gen, device=dev).to(dtype)[offset:].view(shape)
        out.view(-1)[:5] = 0.0
        torch.testing.assert_close(masked_scale(g, out), masked_scale_plain(g, out),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_plan_of_the_sweep_equals_plain(dev, dtype):
    """Each block size, lanes per thread and store kind that
    ``bench_fused_act --sweep`` tries, on both kernels, through their C
    entries: the aligned (C % lanes == 0), the wide (C >= lanes) and the
    narrow lane paths, broadcast noise."""
    from content_aware_gan_compression_torch.bench_fused_act import SWEEP
    from content_aware_gan_compression_torch.ops.cuda import epilogue_plan, lane_plan
    fnbl = importlib.import_module(
        "content_aware_gan_compression_torch.ops.cuda.fused_noise_bias_lrelu")
    ms = importlib.import_module("content_aware_gan_compression_torch.ops.cuda.masked_scale")
    gen = torch.Generator(dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for shape in [(5, 13, 11, 16), (5, 13, 11, 39), (5, 13, 11, 3)]:
        x, noise, bias, nw = _epilogue_inputs(shape, 1, dtype, gen)
        want = fused_noise_bias_lrelu_plain(x, noise, bias, nw)
        o = torch.randn(shape, generator=gen, device=dev).to(dtype)
        want_ms = masked_scale_plain(x, o)
        for threads, vectors, streaming in SWEEP:
            out = torch.full_like(x, float("nan"))
            plan = epilogue_plan(shape, 1, x.element_size(), True, threads, vectors, streaming)
            lib, fn = fnbl._entry(dtype)
            assert fn(x.data_ptr(), noise.data_ptr(), bias.data_ptr(), nw.data_ptr(),
                      out.data_ptr(), *fnbl.epilogue_args(plan, dev.index or 0, stream)) == 0
            dx = torch.full_like(x, float("nan"))
            plan = lane_plan(x.numel(), x.element_size(), True, threads, vectors, streaming)
            lib, fn = ms._entry(dtype)
            assert fn(x.data_ptr(), o.data_ptr(), dx.data_ptr(),
                      *ms.lane_args(plan, dev.index or 0, stream)) == 0
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, rtol=0, atol=0)
            torch.testing.assert_close(dx, want_ms, rtol=0, atol=0)
