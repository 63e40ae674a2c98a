"""The port's discriminator against the JAX package's discriminator_apply, on
the CPU: a JAX discriminator_init tree bridged with state_dict_from_jax and
loaded with strict=True, the same numpy images. JAX runs its default lax path,
the port its plain PyTorch path (blur4's plain version inside Blur4Fn).

Tolerances: scores 1e-5 (fp32 sums over at most 3*3*C terms, reordered);
parameter gradients and R1's grad of grad 1e-4 relative to each tensor's
largest element, as the second order sums twice as many reordered terms."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import (
    DiscriminatorConfig as JaxDiscriminatorConfig, discriminator_apply, discriminator_init)
from content_aware_gan_compression_tpu.models.stylegan2 import _minibatch_stddev
from content_aware_gan_compression_torch.models import (
    Discriminator, DiscriminatorConfig, discriminator_config_from_params)
from content_aware_gan_compression_torch.models.stylegan2 import minibatch_stddev
from content_aware_gan_compression_torch.utils import (
    build_discriminator_from_state_dict, state_dict_from_jax)
from torch_train_util import torch_threads  # noqa: F401

SIZE = 16


def _jax_tree(channel_max=16, seed=0):
    cfg = JaxDiscriminatorConfig(size=SIZE, channel_max=channel_max)
    params = jax.tree_util.tree_map(np.asarray, discriminator_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    for block in params["convs"].values():  # biases are zero at init
        for layer in block.values() if "conv1" in block else [block]:
            for leaf in layer.values():
                if "bias" in leaf:
                    leaf["bias"] = 0.2 * rng.randn(*leaf["bias"].shape).astype(np.float32)
    return cfg, params


def _grads_close(module, jax_grads, rtol=1e-4):
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_grads))
    for name, p in module.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(want[name].abs().max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0,
                                   atol=rtol * scale, err_msg=name)


@pytest.fixture(scope="module")
def pair():
    jcfg, params = _jax_tree()
    d = build_discriminator_from_state_dict(params, SIZE, device="cpu")
    return jcfg, params, d


def test_tree_loads_strict_with_the_jax_key_paths(pair):
    _, params, d = pair
    keys = set(d.state_dict())
    assert {"convs.0.0.weight", "convs.0.1.bias", "convs.1.conv1.0.weight",
            "convs.1.conv2.1.weight", "convs.1.conv2.2.bias", "convs.1.skip.1.weight",
            "final_conv.0.weight", "final_conv.1.bias", "final_linear.0.weight",
            "final_linear.1.bias"} <= keys
    assert keys == set(state_dict_from_jax(params))
    assert d.config == DiscriminatorConfig(size=SIZE, channel_max=16)
    fresh = Discriminator(DiscriminatorConfig(size=SIZE, channel_max=16), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in d.state_dict().items()}


@pytest.mark.parametrize("batch", [4, 8])
def test_scores_and_parameter_gradients_match(pair, batch):
    """Batch 8 puts two samples in each stddev group, with stride B//4."""
    jcfg, params, d = pair
    x = np.random.RandomState(batch).randn(batch, SIZE, SIZE, 3).astype(np.float32)

    def loss_j(p):
        s = discriminator_apply(p, jcfg, jnp.asarray(x), data_format="NHWC")
        return jnp.sum(jax.nn.softplus(s)), s

    (_, want), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    d.zero_grad(set_to_none=True)
    got = d(torch.from_numpy(x))
    torch.nn.functional.softplus(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _grads_close(d, grads)


@pytest.mark.parametrize("batch", [4, 8])
def test_r1_grad_of_grad_matches(pair, batch):
    """R1 = E||d sum(D(x)) / dx||^2 and its gradient in every parameter:
    differentiates blur4, the stride-2 convs and the minibatch stddev twice."""
    from content_aware_gan_compression_torch.train import r1_penalty

    jcfg, params, d = pair
    x = np.random.RandomState(10 + batch).randn(batch, SIZE, SIZE, 3).astype(np.float32)

    def r1_j(p):
        g = jax.grad(lambda im: discriminator_apply(p, jcfg, im, data_format="NHWC").sum())(
            jnp.asarray(x))
        return jnp.mean(jnp.sum(jnp.square(g.reshape(g.shape[0], -1)), axis=1))

    want, grads = jax.jit(jax.value_and_grad(r1_j))(params)
    d.zero_grad(set_to_none=True)
    r1 = r1_penalty(d, torch.from_numpy(x))
    r1.backward()
    np.testing.assert_allclose(r1.item(), float(want), rtol=1e-5)
    _grads_close(d, grads)


@pytest.mark.parametrize("batch,feat", [(8, 1), (8, 2), (2, 1)])
def test_minibatch_stddev_matches(batch, feat):
    x = np.random.RandomState(3).randn(batch, 4, 4, 6).astype(np.float32)
    want = np.asarray(_minibatch_stddev(jnp.asarray(x), 4, feat))
    got = minibatch_stddev(torch.from_numpy(x), 4, feat).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_config_from_params_and_channel_table():
    _, params = _jax_tree(channel_max=8)
    cfg = discriminator_config_from_params(state_dict_from_jax(params), SIZE)
    assert cfg.channel_max == 8
    assert DiscriminatorConfig(size=256).channels() == JaxDiscriminatorConfig(size=256).channels()
