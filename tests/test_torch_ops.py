"""The PyTorch port's ops against the JAX package's, on the CPU: the same
numpy inputs go to both. The port's kernel wrappers take their plain
versions here (CPU tensors); JAX's Pallas kernels run in interpret mode, as
tests/test_pallas_ops.py runs them."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from content_aware_gan_compression_tpu import ops as jops
from content_aware_gan_compression_tpu.ops.pallas import blur4_pallas
from content_aware_gan_compression_tpu.ops.pallas import (
    fused_noise_bias_lrelu as jax_fused_noise_bias_lrelu)
from content_aware_gan_compression_torch import ops
from content_aware_gan_compression_torch.ops import cuda as kernels
from content_aware_gan_compression_torch.ops.cuda import build


@pytest.mark.parametrize(
    "up,down,pad,k1d",
    [
        (1, 1, (2, 1), [1, 3, 3, 1]),
        (2, 1, (2, 1), [1, 3, 3, 1]),
        (1, 2, (2, 2), [1, 3, 3, 1]),
        (1, 2, (1, 1), [1, 3, 3, 1]),
        (2, 1, (1, 1), [1, 3, 3, 1]),
        (1, 1, (1, 1), [1, 2, 1]),
        (4, 2, (3, 2), [1, 3, 3, 1]),
        (1, 1, (-1, 2), [1, 3, 3, 1]),
        (2, 1, (-1, -1), [1, 3, 3, 1]),
    ],
)
def test_upfirdn2d_matches_jax(up, down, pad, k1d):
    x = np.random.RandomState(0).randn(2, 12, 10, 3).astype(np.float32)
    k = ops.make_kernel(k1d)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jops.make_kernel(k1d)))
    want = np.asarray(jops.upfirdn2d(jnp.asarray(x), jnp.asarray(k.numpy()),
                                     up=up, down=down, pad=pad))
    got = ops.upfirdn2d(torch.from_numpy(x), k, up=up, down=down, pad=pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["upsample_2d", "downsample_2d"])
@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_up_and_downsample_match_jax(fn, data_format):
    x = np.random.RandomState(1).randn(2, 8, 8, 4).astype(np.float32)
    if data_format == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    k = ops.make_kernel([1, 3, 3, 1])
    want = np.asarray(getattr(jops, fn)(jnp.asarray(x), jnp.asarray(k.numpy()),
                                        data_format=data_format))
    got = getattr(ops, fn)(torch.from_numpy(x), k, data_format=data_format).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad", [(2, 1), (1, 1), (2, 2)])
@pytest.mark.parametrize("gain", [1.0, 4.0])
def test_blur_plain_path_matches_blur4_pallas(pad, gain):
    """The port's blur (blur4's plain version on a CPU tensor) against JAX's
    blur4_pallas in interpret mode."""
    x = np.random.RandomState(2).randn(2, 12, 11, 8).astype(np.float32)
    k = ops.make_kernel([1, 3, 3, 1])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(blur4_pallas(jnp.asarray(x), k.numpy(), pad, gain, True))
    factor = 2 if gain == 4.0 else 1
    got = ops.blur(torch.from_numpy(x), k, pad=pad, upsample_factor=factor).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert kernels.blur4.launches == 0  # the CPU path launches nothing


def test_blur4_plain_takes_asymmetric_kernels_like_upfirdn2d():
    """blur4 flips its taps as a convolution does (checked with a kernel
    whose flip differs from itself), and non-4x4 / NCHW / negative-pad blurs
    take the general upfirdn2d."""
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 9, 7, 5).astype(np.float32))
    k = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120
    want = ops.upfirdn2d(x, k * 4, pad=(2, 1))
    torch.testing.assert_close(kernels.blur4(x, k, (2, 1), 4.0), want, rtol=1e-5, atol=1e-5)
    k3 = ops.make_kernel([1, 2, 1])
    torch.testing.assert_close(ops.blur(x, k3, pad=(1, 1)), ops.upfirdn2d(x, k3, pad=(1, 1)))
    xn = x.permute(0, 3, 1, 2)
    torch.testing.assert_close(ops.blur(xn, k, pad=(2, 1), data_format="NCHW"),
                               ops.upfirdn2d(xn, k, pad=(2, 1), data_format="NCHW"))
    with pytest.raises(ValueError):
        kernels.blur4(x, k, (-1, 2))


def test_fused_noise_bias_lrelu_plain_path_matches_pallas():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    noise = rng.randn(2, 8, 8, 1).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    nw = np.asarray([0.3], np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_noise_bias_lrelu(
            jnp.asarray(x), jnp.asarray(noise), jnp.asarray(bias), jnp.asarray(nw[0])))
    got = ops.fused_noise_bias_lrelu(torch.from_numpy(x), torch.from_numpy(noise),
                                     torch.from_numpy(bias), torch.from_numpy(nw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # noise with batch 1 (the persistent buffers) broadcasts over the batch
    got1 = ops.fused_noise_bias_lrelu(torch.from_numpy(x), torch.from_numpy(noise[:1]),
                                      torch.from_numpy(bias), torch.from_numpy(nw))
    want1 = jops.fused_leaky_relu(jnp.asarray(x) + nw[0] * jnp.asarray(noise[:1]),
                                  jnp.asarray(bias))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=1e-5, atol=1e-5)
    assert kernels.fused_noise_bias_lrelu.launches == 0


@pytest.mark.parametrize("with_bias,channel_axis", [(False, -1), (True, -1), (True, 1)])
def test_fused_and_scaled_leaky_relu_match_jax(with_bias, channel_axis):
    rng = np.random.RandomState(5)
    x = rng.randn(3, 6, 5, 4).astype(np.float32)
    bias = rng.randn(x.shape[channel_axis]).astype(np.float32) if with_bias else None
    want = jops.fused_leaky_relu(jnp.asarray(x), None if bias is None else jnp.asarray(bias),
                                 channel_axis=channel_axis)
    got = ops.fused_leaky_relu(torch.from_numpy(x),
                               None if bias is None else torch.from_numpy(bias),
                               channel_axis=channel_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ops.scaled_leaky_relu(torch.from_numpy(x)).numpy(),
                               np.asarray(jops.scaled_leaky_relu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_kernel_build_names_follow_the_source_hash(tmp_path, monkeypatch):
    """Each library's file name carries its source's hash, so an edited
    source is rebuilt; without nvcc, a build raises instead of falling back."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "blur4.cu").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    first = build.library_path("blur4")
    assert first.parent == tmp_path / "build" and first.suffix == ".so"
    assert build.library_path("blur4") == first
    (src / "blur4.cu").write_text("// v2\n")
    assert build.library_path("blur4") != first
    if build.shutil.which("nvcc") is None and not build.os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build(("blur4",))
