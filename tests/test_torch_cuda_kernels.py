"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no CPU mode, so every test here needs a card and
skips without one. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have). This file imports no JAX."""

import pytest
import torch

from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
from content_aware_gan_compression_torch.ops import make_kernel
from content_aware_gan_compression_torch.ops.cuda import (
    blur4, blur4_plain, correlation_taps, fused_noise_bias_lrelu,
    fused_noise_bias_lrelu_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,pad,gain", [
    ((2, 9, 9, 512), (1, 1), 4.0), ((2, 17, 17, 256), (1, 1), 4.0),
    ((3, 13, 9, 3), (2, 1), 1.0), ((2, 17, 11, 12), (2, 2), 4.0),
    ((2, 10, 15, 130), (1, 1), 1.0), ((1, 7, 7, 130), (2, 1), 4.0),
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
    with pytest.raises(NotImplementedError):
        blur4(x.requires_grad_(), k, (1, 1))  # forward only
    x = torch.randn(2, 4, 4, 8, device=dev)
    noise, bias, nw = (torch.zeros(2, 4, 4, 1, device=dev), torch.zeros(8, device=dev),
                       torch.zeros(1, device=dev))
    with pytest.raises(ValueError):
        fused_noise_bias_lrelu(x, noise[..., :3, :], bias, nw)
    with pytest.raises(NotImplementedError):
        fused_noise_bias_lrelu(x, noise, bias.requires_grad_(), nw)


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
