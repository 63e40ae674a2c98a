"""The port's generator and discriminator in bfloat16 against the JAX
package's (``generator_apply`` / ``discriminator_apply`` with
``dtype=jnp.bfloat16``), on the CPU at 32px, from the same JAX trees.

bfloat16 rounds at other places in the two packages (the port's kernels
round once, JAX after every operation; convolutions differ), so the two
are not held to each other directly: both are held against the port in
float64 on the same inputs, and the port's distance (largest |a - b| over
the largest |float64|) must be at most 2x JAX's + 1e-3."""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import (
    DiscriminatorConfig as JaxDiscriminatorConfig, GeneratorConfig as JaxGeneratorConfig,
    discriminator_apply, discriminator_init, generator_apply)
from content_aware_gan_compression_torch.utils import (
    build_discriminator_from_state_dict, build_generator_from_state_dict)
from torch_eval_util import generator_tree
from torch_train_util import _jit_init
from torch_train_util import torch_threads  # noqa: F401

SIZE, STYLE, N_MLP = 32, 16, 2
G32 = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                         net_shape=(32, 24, 24, 16, 16, 12, 12, 8))
D32 = JaxDiscriminatorConfig(size=SIZE, channel_max=32)
BF = torch.bfloat16


def distance(got, want64):
    got = np.asarray(jnp.asarray(got, jnp.float32)) if isinstance(got, jax.Array) \
        else got.detach().double().numpy()
    want = want64.detach().double().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def hold(port, jx, want64):
    d_port, d_jax = distance(port, want64), distance(jx, want64)
    assert d_port <= 2 * d_jax + 1e-3, (d_port, d_jax)
    return d_port, d_jax


@pytest.fixture(scope="module")
def generators():
    tree = generator_tree(3, G32)
    g = build_generator_from_state_dict(tree, SIZE, STYLE, N_MLP, device="cpu")
    return tree, g, copy.deepcopy(g).double()


def test_generator_bf16_against_float64(generators):
    """Two mixed styles, the noise maps and the image; then the path
    lengths of PPL_regularize with JAX's own bfloat16 y."""
    tree, g, g64 = generators
    rng = np.random.RandomState(1)
    z = [rng.randn(3, STYLE).astype(np.float32) for _ in range(2)]
    noise = [rng.randn(3, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1).astype(np.float32)
             for i in range(G32.num_layers)]
    zt, nt = [torch.from_numpy(a) for a in z], [torch.from_numpy(a) for a in noise]
    idx = 3
    with torch.no_grad():
        got = g(zt, inject_index=torch.tensor(idx), noise=nt, dtype=BF)
        want64 = g64([t.double() for t in zt], inject_index=torch.tensor(idx),
                     noise=[t.double() for t in nt])
    assert got.dtype == BF
    key = jax.random.PRNGKey(4)

    @jax.jit
    def jax_run(p, zs, ns):
        img = generator_apply(p, G32, zs, inject_index=jnp.asarray(idx), noise=ns,
                              dtype=jnp.bfloat16)
        _, lengths = generator_apply(p, G32, zs, inject_index=jnp.asarray(idx), noise=ns,
                                     dtype=jnp.bfloat16, PPL_regularize=True, ppl_rng=key)
        return img, lengths

    want_img, want_len = jax_run(tree, [jnp.asarray(a) for a in z],
                                 [jnp.asarray(a) for a in noise])
    assert want_img.dtype == jnp.bfloat16
    hold(got, want_img, want64)

    # the y JAX draws: bfloat16 normals, drawn in the image's shape
    y = torch.from_numpy(np.asarray(
        jax.random.normal(key, (3, SIZE, SIZE, 3), dtype=jnp.bfloat16), np.float32))
    _, lengths = g(zt, inject_index=torch.tensor(idx), noise=nt, PPL_regularize=True,
                   ppl_noise=y, dtype=BF)
    _, lengths64 = g64([t.double() for t in zt], inject_index=torch.tensor(idx),
                       noise=[t.double() for t in nt], PPL_regularize=True,
                       ppl_noise=y.double())
    assert lengths.dtype == torch.float32 and want_len.dtype == jnp.float32
    hold(lengths, want_len, lengths64)


def test_discriminator_bf16_against_float64():
    tree = _jit_init(discriminator_init, 2, D32)
    d = build_discriminator_from_state_dict(tree, SIZE, device="cpu")
    d64 = copy.deepcopy(d).double()
    x = np.tanh(np.random.RandomState(5).randn(4, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = d(torch.from_numpy(x), BF)
        want64 = d64(torch.from_numpy(x).double())
    want = jax.jit(lambda p, im: discriminator_apply(p, D32, im, dtype=jnp.bfloat16,
                                                     data_format="NHWC"))(tree, jnp.asarray(x))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    hold(got, want, want64)
