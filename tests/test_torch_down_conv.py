"""The down-sampling modulated conv (``ModulatedConv2d(downsample=True)``)
against the JAX package's ``_modulated_conv2d(down=True)`` on the CPU: the
forward to 1e-5 of the largest value; the gradients of x, the style, the
weight and the modulation against float64, the port's error at most twice
JAX's plus 1e-6 of the largest value (fp32 gradients round differently in
each package; ROADMAP Queue 3)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models.stylegan2 import _modulated_conv2d
from content_aware_gan_compression_torch.models.stylegan2 import ModulatedConv2d
from torch_train_util import torch_threads  # noqa: F401

B, H, IN, OUT, STYLE = 2, 16, 8, 12, 16


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, H, IN).astype(np.float32), rng.randn(B, STYLE).astype(np.float32),
            rng.randn(B, H // 2, H // 2, OUT).astype(np.float32))


def _port(conv, x, style, cot, dtype):
    conv = conv.to(dtype)
    x = torch.from_numpy(x).to(dtype).requires_grad_(True)
    style = torch.from_numpy(style).to(dtype).requires_grad_(True)
    out, _ = conv(x, style)
    (out * torch.from_numpy(cot).to(dtype)).sum().backward()
    grads = {"x": x.grad, "style": style.grad, "weight": conv.weight.grad,
             "mod_weight": conv.modulation.weight.grad, "mod_bias": conv.modulation.bias.grad}
    return out.detach().double().numpy(), {k: v.double().numpy() for k, v in grads.items()}


@pytest.mark.parametrize("kernel_size,demodulate", [(3, True), (1, False)])
def test_down_conv_matches_jax(kernel_size, demodulate):
    conv = ModulatedConv2d(IN, OUT, kernel_size, STYLE, demodulate=demodulate, downsample=True,
                           generator=torch.Generator().manual_seed(0))
    assert conv.blur_pad == ((2, 2) if kernel_size == 3 else (1, 1))
    p = {"weight": conv.weight.detach().numpy(),
         "modulation": {"weight": conv.modulation.weight.detach().numpy(),
                        "bias": conv.modulation.bias.detach().numpy()}}
    x, style, cot = _inputs(kernel_size)

    def loss(p, x, style):
        out = _modulated_conv2d(p, x, style, demodulate=demodulate, down=True)
        return jnp.sum(out * cot), out

    (_, want), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        p, x, style)
    jax_grads = {"x": g[1], "style": g[2], "weight": g[0]["weight"],
                 "mod_weight": g[0]["modulation"]["weight"],
                 "mod_bias": g[0]["modulation"]["bias"]}
    got, grads = _port(conv, x, style, cot, torch.float32)
    want = np.asarray(want)
    assert got.shape == want.shape == (B, H // 2, H // 2, OUT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    _, ref = _port(conv, x, style, cot, torch.float64)
    for k, r in ref.items():
        scale = np.abs(r).max()
        port_err = np.abs(grads[k] - r).max()
        jax_err = np.abs(np.asarray(jax_grads[k], np.float64).reshape(r.shape) - r).max()
        assert port_err <= 2 * jax_err + 1e-6 * scale, (k, port_err, jax_err, scale)
