"""The port's plain kernels in bfloat16 against the JAX package's bfloat16
ops, on the CPU: the 4x4 blur (``blur``, blur4's plain version), the
StyledConv epilogue (JAX's bfloat16 expression, ``_styled_conv``'s
non-Pallas branch) and its gradients, and ``fused_leaky_relu``.

The port rounds once: each output is the float32 result of the bfloat16
inputs, rounded to bfloat16 (the CUDA kernels do the same, bit for bit).
JAX rounds after each bfloat16 operation. So both are held against the
same inputs in float64: the port's largest error is at most JAX's plus half
a bfloat16 ulp of the largest float64 value (2^-8 of it, for ties), and at
most 2^-7 of that value. (JAX's own error can be far larger where its
rounded pre-activation changes sign, which moves the mask: the gradient
there is off by the slope.)"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.ops import blur as jax_blur
from content_aware_gan_compression_tpu.ops import fused_leaky_relu as jax_fused_leaky_relu
from content_aware_gan_compression_tpu.ops import make_kernel as jax_make_kernel
from content_aware_gan_compression_torch.ops import blur, fused_leaky_relu, make_kernel
from content_aware_gan_compression_torch.ops.cuda import (
    blur4_plain, correlation_taps, fused_noise_bias_lrelu, fused_noise_bias_lrelu_plain,
    masked_scale_plain)
from torch_train_util import torch_threads  # noqa: F401

BF = torch.bfloat16
EPS = 2.0 ** -7  # bfloat16's spacing in [1, 2)


def _bf16(a):
    """A float32 numpy array rounded to bfloat16, as (torch, jax) inputs."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(BF)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.detach().float().numpy()


def _hold(port, jx, want64):
    """The rule of the module docstring, for one output."""
    want = want64.double().numpy()
    scale = np.abs(want).max()
    port_err = np.abs(_np(port) - want).max()
    jax_err = np.abs(_np(jx) - want).max()
    assert port_err <= jax_err + EPS / 2 * scale, (port_err, jax_err, scale)
    assert port_err <= EPS * scale, (port_err, scale)


@pytest.mark.parametrize("shape,pad,factor", [
    ((2, 9, 9, 12), (1, 1), 2),  # an up-blur; C <= 64 takes JAX's separable FIR
    ((2, 17, 17, 39), (1, 1), 2),
    ((2, 16, 16, 80), (2, 2), 1),  # D's conv blur; C > 64 takes JAX's depthwise conv
    ((2, 16, 16, 80), (1, 1), 1),
])
def test_blur_bf16_matches_jax(shape, pad, factor):
    x, xj = _bf16(np.random.RandomState(0).randn(*shape))
    k = [1, 3, 3, 1]
    got = blur(x, make_kernel(k), pad, upsample_factor=factor)
    want = jax.jit(lambda a: jax_blur(a, jax_make_kernel(k), pad, upsample_factor=factor))(xj)
    assert got.dtype == BF and want.dtype == jnp.bfloat16 and got.shape == want.shape
    gain = float(factor ** 2) if factor > 1 else 1.0
    _hold(got, want, blur4_plain(x.double(), correlation_taps(make_kernel(k), gain), pad))


def _epilogue_inputs(shape, noise_batch, seed):
    rng = np.random.RandomState(seed)
    x = _bf16(rng.randn(*shape))
    noise = _bf16(rng.randn(noise_batch, *shape[1:3], 1))
    bias = _bf16(0.5 * rng.randn(shape[3]))
    nw = _bf16([0.7])
    return x, noise, bias, nw


def _jax_epilogue(x, noise, bias, nw):
    """``_styled_conv``'s bfloat16 epilogue (JAX takes the plain expression
    outside float32)."""
    return jax_fused_leaky_relu(x + nw[0] * noise, bias)


@pytest.mark.parametrize("shape,noise_batch", [((2, 8, 8, 39), 2), ((2, 8, 8, 64), 1)])
def test_epilogue_bf16_matches_jax(shape, noise_batch):
    (x, xj), (n, nj), (b, bj), (w, wj) = _epilogue_inputs(shape, noise_batch, 1)
    got = fused_noise_bias_lrelu(x, n, b, w)
    assert got.dtype == BF
    want = jax.jit(_jax_epilogue)(xj, nj, bj, wj)
    _hold(got, want, fused_noise_bias_lrelu_plain(x.double(), n.double(), b.double(), w.double()))


@pytest.mark.parametrize("shape,noise_batch", [((2, 8, 8, 39), 2), ((2, 8, 8, 64), 1)])
def test_epilogue_bf16_gradients_match_jax(shape, noise_batch):
    """The gradients of sum(out * c) in x, the noise, the bias and the noise
    weight: the port's Function (masked_scale's plain version, the sums of
    dx in float32 rounded once) against autograd of JAX's bfloat16
    expression, under the same rule."""
    (x, xj), (n, nj), (b, bj), (w, wj) = _epilogue_inputs(shape, noise_batch, 2)
    c, cj = _bf16(np.random.RandomState(3).randn(*shape))

    def grads(args, dtype):
        args = [a.detach().to(dtype).requires_grad_(True) for a in args]
        out = fused_noise_bias_lrelu(*args)
        return torch.autograd.grad((out * c.to(dtype)).double().sum(), args)

    got = grads((x, n, b, w), BF)
    want64 = grads((x, n, b, w), torch.float64)
    want = jax.jit(jax.grad(lambda *a: jnp.sum((_jax_epilogue(*a) * cj).astype(jnp.float32)),
                            argnums=(0, 1, 2, 3)))(xj, nj, bj, wj)
    for g_port, g_jax, g64 in zip(got, want, want64):
        assert g_port.dtype == BF
        _hold(g_port, g_jax, g64)


def test_masked_scale_bf16_rounds_once():
    """masked_scale's plain version in bfloat16: the float32 result rounded
    once, within a bfloat16 rounding of the float64 value."""
    rng = np.random.RandomState(4)
    g, _ = _bf16(rng.randn(4, 6, 6, 39))
    out, _ = _bf16(rng.randn(4, 6, 6, 39))
    out.view(-1)[:3] = 0.0  # the mask is 1 at exactly 0
    got = masked_scale_plain(g, out)
    want = torch.where(out >= 0, g.double(), 0.2 * g.double()) * math.sqrt(2.0)
    assert got.dtype == BF
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=EPS / 2, atol=0)


def test_fused_leaky_relu_keeps_bf16():
    """The bias is cast to the input's type, as in the JAX package, so a
    bfloat16 input stays bfloat16 and rounds as JAX's does."""
    rng = np.random.RandomState(5)
    x, xj = _bf16(rng.randn(3, 7, 7, 10))
    bias = torch.from_numpy(rng.randn(10).astype(np.float32))
    got = fused_leaky_relu(x, bias)
    want = jax.jit(jax_fused_leaky_relu)(xj, jnp.asarray(bias.numpy()).astype(jnp.bfloat16))
    assert got.dtype == BF
    _hold(got, want, fused_leaky_relu(x.double(), bias.double()))
