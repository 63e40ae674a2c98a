"""The port's differentiable kernels (Blur4Fn, FusedNoiseBiasLReLUFn,
MaskedScaleFn) against the JAX package's Pallas custom VJPs, to second order,
on the CPU. The same numpy inputs go to both; JAX's Pallas kernels run in
interpret mode, as tests/test_pallas_ops.py runs them, and the port's
Functions take their plain versions, the same backward formulas that run the
kernels on the card.

Tolerances: first order 1e-5 absolute on values of order 1-10 (fp32 sums of
at most 16 taps or C terms, taken in another order); second order 1e-4
relative, as tests/test_pallas_ops.py holds the Pallas path to lax."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.autograd import gradcheck, gradgradcheck

from content_aware_gan_compression_tpu.ops.pallas import blur4_pallas
from content_aware_gan_compression_tpu.ops.pallas import (
    fused_noise_bias_lrelu as jax_fused_noise_bias_lrelu)
from content_aware_gan_compression_tpu.ops.pallas.fused_act_pallas import _masked_scale
from content_aware_gan_compression_torch import ops
from content_aware_gan_compression_torch.ops import cuda as kernels
from torch_train_util import torch_threads  # noqa: F401

K4 = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("pad", [(2, 1), (1, 1), (2, 2)])
@pytest.mark.parametrize("gain", [1.0, 4.0])
def test_blur4_first_and_second_order_match_pallas(pad, gain):
    """d/dx of sum(blur^3), and d/dx of the squared norm of that gradient:
    the second order runs the backward's own backward (blur4 again)."""
    x = np.random.RandomState(0).randn(2, 9, 8, 5).astype(np.float32)

    def inner_j(x):
        return jnp.sum(blur4_pallas(x, K4, pad, gain, True) ** 3)

    with pltpu.force_tpu_interpret_mode():
        want_g = np.asarray(jax.grad(inner_j)(jnp.asarray(x)))
        want_gg = np.asarray(jax.grad(lambda x: jnp.sum(jax.grad(inner_j)(x) ** 2))(
            jnp.asarray(x)))
    xt = _t(x, True)
    (g,) = torch.autograd.grad(kernels.blur4(xt, K4, pad, gain).pow(3).sum(), xt,
                               create_graph=True)
    (gg,) = torch.autograd.grad(g.pow(2).sum(), xt)
    np.testing.assert_allclose(g.detach().numpy(), want_g, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gg.numpy(), want_gg, rtol=1e-4,
                               atol=1e-4 * np.abs(want_gg).max())


@pytest.mark.parametrize("noise_batch", [2, 1])
def test_epilogue_gradients_match_pallas(noise_batch):
    """dx, dnoise, dbias and dnw of sum(out^2) against the Pallas custom VJP.
    With noise [1,H,W,1] (the noise buffers) dnoise sums over the batch,
    which JAX reaches by broadcasting before its kernel."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 5, 7).astype(np.float32)
    noise = rng.randn(noise_batch, 6, 5, 1).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)
    nw = np.asarray([0.3], np.float32)

    def loss_j(x, noise, bias, nw):
        noise = jnp.broadcast_to(noise, (2, 6, 5, 1))
        return jnp.sum(jax_fused_noise_bias_lrelu(x, noise, bias, nw[0]) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (x, noise, bias, nw)))
    args = [_t(a, True) for a in (x, noise, bias, nw)]
    got = torch.autograd.grad(ops.fused_noise_bias_lrelu(*args).pow(2).sum(), args)
    for name, a, b in zip(("dx", "dnoise", "dbias", "dnw"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_epilogue_grad_of_grad_matches_pallas():
    """Mirrors tests/test_pallas_ops.py's grad of grad, and takes the
    second-order gradient in the bias and the noise weight too."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    noise = rng.randn(2, 8, 8, 1).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    nw = np.asarray([0.3], np.float32)

    def outer_j(x, bias, nw):
        g = jax.grad(lambda x: jnp.sum(jax_fused_noise_bias_lrelu(
            x, jnp.asarray(noise), bias, nw[0]) ** 3))(x)
        return jnp.sum(g ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(outer_j, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(bias), jnp.asarray(nw))
    xt, bt, nt = _t(x, True), _t(bias, True), _t(nw, True)
    (g,) = torch.autograd.grad(
        ops.fused_noise_bias_lrelu(xt, _t(noise), bt, nt).pow(3).sum(), xt, create_graph=True)
    got = torch.autograd.grad(g.pow(2).sum(), (xt, bt, nt))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_masked_scale_matches_pallas_and_sends_no_gradient_to_out():
    rng = np.random.RandomState(6)
    g = rng.randn(3, 4, 5, 6).astype(np.float32)
    out = rng.randn(3, 4, 5, 6).astype(np.float32)
    out[0, 0, 0, :3] = 0.0  # the mask is 1 at exactly 0, as in JAX
    gg = rng.randn(3, 4, 5, 6).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(_masked_scale, jnp.asarray(g), jnp.asarray(out))
        want_dg, want_dout = vjp(jnp.asarray(gg))
    gt, ot = _t(g, True), _t(out, True)
    got = kernels.MaskedScaleFn.apply(gt, ot)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    dg, dout = torch.autograd.grad(got, (gt, ot), _t(gg), allow_unused=True)
    np.testing.assert_array_equal(dg.numpy(), np.asarray(want_dg))
    assert dout is None and not np.asarray(want_dout).any()
    assert kernels.masked_scale.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("fn", ["blur4", "epilogue", "masked_scale"])
def test_functions_pass_gradcheck_in_float64(fn):
    """Finite differences against each hand-written backward, first and
    second order, on the plain path in float64."""
    gen = torch.Generator().manual_seed(7)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64, requires_grad=True)

    if fn == "blur4":
        k = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120  # flip != itself
        f, args = (lambda x: kernels.blur4(x, k, (2, 1), 4.0)), (rand(2, 6, 5, 3),)
    elif fn == "epilogue":
        f, args = kernels.fused_noise_bias_lrelu, (rand(2, 4, 5, 3), rand(1, 4, 5, 1),
                                                   rand(3), rand(1))
    else:
        out = torch.randn(2, 3, 4, generator=gen, dtype=torch.float64)
        f, args = (lambda g: kernels.MaskedScaleFn.apply(g, out)), (rand(2, 3, 4),)
    assert gradcheck(f, args)
    assert gradgradcheck(f, args)


def test_blur_and_epilogue_counts_stay_zero_on_the_cpu():
    kernels.reset_counts()
    x = torch.randn(2, 9, 9, 4, requires_grad=True)
    y = ops.blur(x, ops.make_kernel([1, 3, 3, 1]), pad=(1, 1), upsample_factor=2)
    y = ops.fused_noise_bias_lrelu(y, torch.randn(2, 8, 8, 1), torch.zeros(4),
                                   torch.zeros(1, requires_grad=True))
    y.sum().backward()
    assert kernels.counts() == dict.fromkeys(kernels.counts(), 0)
