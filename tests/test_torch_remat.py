"""``remat``, the JAX package's activation checkpointing, in the port on the
CPU: ``Generator(..., remat=True)`` checkpoints each resolution block of the
synthesis, ``Discriminator(..., remat=True)`` each ResBlock, and
``TrainConfig.remat`` turns both on at the JAX steps' call sites.

- On and off, the port gives the same D scores, R1 parameter gradients
  (grad of grad), image, modulation scalars and path-length gradients,
  within 1e-6 of each tensor's largest value.
- With remat, the port matches the JAX package's ``discriminator_apply``
  and ``generator_apply`` with ``remat=True`` at the parity tolerances of
  test_torch_discriminator.py and test_torch_generator.py (scores 1e-5,
  images 1e-4, gradients 1e-4 and, for path length, 2e-4 of each tensor's
  largest value).
- One D, R1, G, path-length and sparse G step with ``cfg.remat`` on and off
  from the same state, in float32 and bfloat16: the same parameters after
  Adam and the same ``torch.Generator`` state after the draws.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import (
    DiscriminatorConfig as JaxDiscriminatorConfig, GeneratorConfig as JaxGeneratorConfig,
    discriminator_apply, discriminator_init, generator_apply, generator_init)
from content_aware_gan_compression_torch.models import (
    Discriminator, DiscriminatorConfig, Generator, GeneratorConfig)
from content_aware_gan_compression_torch.train import TrainConfig, r1_penalty
from content_aware_gan_compression_torch.train.sparsity import SPARSITY_DEFAULTS, sparse_g_step
from content_aware_gan_compression_torch.train.steps import (
    d_reg_step, d_step, draw_d, draw_g, draw_g_reg, g_reg_step, g_step, make_optimizers)
from content_aware_gan_compression_torch.utils import state_dict_from_jax
from torch_train_util import (
    N_MLP, STUDENT_SHAPE, STYLE, TEACHER_SHAPE, _jit_init, train_kw)
from torch_train_util import torch_threads  # noqa: F401

G16 = dict(size=16, style_dim=16, n_mlp=2, net_shape=(16, 12, 12, 8, 8, 6))
D16 = dict(size=16, channel_max=16)
EXACT = 1e-6  # remat on vs off, of each tensor's largest value


def _close(got, want, tol, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the largest value > {tol}"


def _grads(module):
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in module.named_parameters()}


def _grads_match_jax(module, jax_grads, tol):
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_grads))
    for name, got in _grads(module).items():
        _close(got, want[name], tol, name)


@pytest.fixture(scope="module")
def gen_pair():
    jcfg = JaxGeneratorConfig(**G16)
    params = _jit_init(generator_init, 0, jcfg)
    rng = np.random.RandomState(0)
    for block in [params["conv1"], *params["convs"].values()]:  # zero at init
        block["noise"]["weight"] = rng.randn(1).astype(np.float32)
        block["activate"]["bias"] = 0.3 * rng.randn(
            *block["activate"]["bias"].shape).astype(np.float32)
    g = Generator(GeneratorConfig(**G16), device="cpu")
    g.load_state_dict(state_dict_from_jax(params), strict=True)
    return jcfg, params, g


@pytest.fixture(scope="module")
def disc_pair():
    jcfg = JaxDiscriminatorConfig(**D16)
    params = _jit_init(discriminator_init, 0, jcfg)
    rng = np.random.RandomState(1)
    for block in list(params["convs"].values())[1:]:  # the ResBlocks' biases, zero at init
        for layer in (block["conv1"], block["conv2"]):
            for leaf in layer.values():
                if "bias" in leaf:
                    leaf["bias"] = 0.2 * rng.randn(*leaf["bias"].shape).astype(np.float32)
    d = Discriminator(DiscriminatorConfig(**D16), device="cpu")
    d.load_state_dict(state_dict_from_jax(params), strict=True)
    return jcfg, params, d


def _g_inputs(batch, seed):
    rng = np.random.RandomState(seed)
    z = [rng.randn(batch, G16["style_dim"]).astype(np.float32) for _ in range(2)]
    noise = [rng.randn(batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1).astype(np.float32)
             for i in range(GeneratorConfig(**G16).num_layers)]
    return z, noise


def _path(g, z, noise, y, remat):
    g.zero_grad(set_to_none=True)
    _, lengths = g([torch.from_numpy(a) for a in z], inject_index=torch.tensor(3),
                   noise=[torch.from_numpy(n) for n in noise], PPL_regularize=True,
                   ppl_noise=torch.from_numpy(y), remat=remat)
    torch.square(lengths - 0.5).sum().backward()
    return lengths.detach(), _grads(g)


def _r1(d, x, remat):
    d.zero_grad(set_to_none=True)
    r1 = r1_penalty(d, torch.from_numpy(x), remat=remat)
    r1.backward()
    return r1.detach(), _grads(d)


def test_discriminator_remat_is_the_same_math_and_matches_jax(disc_pair):
    """D's scores and R1's parameter gradients, remat on against off, and
    with remat against ``discriminator_apply(..., remat=True)``."""
    jcfg, params, d = disc_pair
    x = np.random.RandomState(2).randn(8, 16, 16, 3).astype(np.float32)
    with torch.no_grad():
        off = d(torch.from_numpy(x))
    on = d(torch.from_numpy(x), remat=True)  # recorded: the blocks run checkpointed
    _close(on.detach(), off, EXACT, "scores")
    r1_off, g_off = _r1(d, x, False)
    r1_on, g_on = _r1(d, x, True)
    _close(r1_on, r1_off, EXACT, "r1")
    for k in g_off:
        _close(g_on[k], g_off[k], EXACT, k)

    def r1_j(p):
        g = jax.grad(lambda im: discriminator_apply(p, jcfg, im, data_format="NHWC",
                                                    remat=True).sum())(jnp.asarray(x))
        return jnp.mean(jnp.sum(jnp.square(g.reshape(g.shape[0], -1)), axis=1))

    scores_j = jax.jit(lambda p: discriminator_apply(p, jcfg, jnp.asarray(x), data_format="NHWC",
                                                     remat=True))(params)
    np.testing.assert_allclose(on.detach().numpy(), np.asarray(scores_j), rtol=0, atol=1e-5)
    want, grads = jax.jit(jax.value_and_grad(r1_j))(params)
    np.testing.assert_allclose(r1_on.item(), float(want), rtol=1e-5)
    _r1(d, x, True)
    _grads_match_jax(d, grads, 1e-4)


def test_generator_remat_is_the_same_math_and_matches_jax(gen_pair):
    """The image and the modulation scalars (``return_style_scalars``), and
    the path lengths' gradients (a grad of grad through the checkpointed
    blocks), remat on against off, and with remat against
    ``generator_apply(..., remat=True)``."""
    jcfg, params, g = gen_pair
    z, noise = _g_inputs(3, 4)
    tz, tn = [torch.from_numpy(a) for a in z], [torch.from_numpy(n) for n in noise]
    outs = {}
    for remat in (False, True):
        image, styles = g(tz, inject_index=torch.tensor(2), noise=tn, remat=remat,
                          return_style_scalars=True)
        outs[remat] = [image.detach(), *[s.detach() for s in styles]]
    assert len(outs[True]) == len(outs[False]) == 1 + len(G16["net_shape"])  # conv1, convs, ToRGB
    for i, (a, b) in enumerate(zip(outs[True], outs[False])):
        _close(a, b, EXACT, f"output {i}")
    img_j, styles_j = jax.jit(lambda p: generator_apply(
        p, jcfg, [jnp.asarray(a) for a in z], inject_index=jnp.asarray(2),
        noise=[jnp.asarray(n) for n in noise], return_style_scalars=True, remat=True))(params)
    np.testing.assert_allclose(outs[True][0].numpy(), np.asarray(img_j), rtol=0, atol=1e-4)
    for got, want in zip(outs[True][1:], styles_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    pz, pn = _g_inputs(2, 5)
    key = jax.random.PRNGKey(3)
    y = np.asarray(jax.random.normal(key, (2, 16, 16, 3)))
    len_off, grad_off = _path(g, pz, pn, y, False)
    len_on, grad_on = _path(g, pz, pn, y, True)
    _close(len_on, len_off, EXACT, "path lengths")
    for k in grad_off:
        _close(grad_on[k], grad_off[k], EXACT, k)

    def loss_j(p):
        _, lengths = generator_apply(p, jcfg, [jnp.asarray(a) for a in pz],
                                     inject_index=jnp.asarray(3),
                                     noise=[jnp.asarray(n) for n in pn], PPL_regularize=True,
                                     ppl_rng=key, remat=True)
        return jnp.sum(jnp.square(lengths - 0.5)), lengths

    (_, want_len), want = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    np.testing.assert_allclose(len_on.numpy(), np.asarray(want_len), rtol=1e-4)
    _path(g, pz, pn, y, True)
    _grads_match_jax(g, want, 2e-4)
    g.zero_grad(set_to_none=True)


def _nets():
    """A seeded student, teacher and D at the training tests' tiny size, with
    the epilogues' noise weights and biases drawn (zero at init)."""
    seeded = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    g = Generator(GeneratorConfig(size=16, style_dim=STYLE, n_mlp=N_MLP,
                                  net_shape=STUDENT_SHAPE), device="cpu", generator=seeded(0))
    t = Generator(GeneratorConfig(size=16, style_dim=STYLE, n_mlp=N_MLP,
                                  net_shape=TEACHER_SHAPE), device="cpu", generator=seeded(1))
    d = Discriminator(DiscriminatorConfig(size=16, channel_max=16), device="cpu",
                      generator=seeded(2))
    with torch.no_grad():
        for net, s in ((g, 3), (t, 4)):
            for name, p in net.named_parameters():
                if name.endswith(("noise.weight", "activate.bias")):
                    p.copy_(0.3 * torch.randn(p.shape, generator=seeded(s)))
    return g, t.requires_grad_(False), d


def _one_step(kind, remat, dtype):
    cfg = TrainConfig(**train_kw(remat=remat))
    g, t, d = _nets()
    g_opt, d_opt = make_optimizers(g, d, cfg)
    gen = torch.Generator().manual_seed(7)
    real = torch.from_numpy(np.random.RandomState(8).uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32))
    if kind == "d":
        metrics = d_step(g, d, d_opt, real, draw_d(gen, g, cfg), cfg, dtype)
    elif kind == "d_reg":
        metrics = d_reg_step(d, d_opt, real, cfg, dtype)
    elif kind == "g":
        metrics = g_step(g, g_opt, d, draw_g(gen, g, cfg, t), cfg, t, dtype=dtype)
    elif kind == "g_reg":
        _, metrics = g_reg_step(g, g_opt, draw_g_reg(gen, g, cfg), torch.tensor(0.3), cfg,
                                dtype)
    else:
        opts = {**SPARSITY_DEFAULTS, "sparsity_eta": 1e-2}
        metrics = sparse_g_step(g, g_opt, d, draw_g(gen, g, cfg, t), cfg, opts, t, dtype=dtype)
    weights = {f"{n}.{k}": v.detach().clone() for n, net in (("g", g), ("d", d))
               for k, v in net.state_dict().items()}
    return metrics, weights, gen.get_state()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["d", "d_reg", "g", "g_reg", "sparse_g"])
def test_steps_with_remat_take_the_same_step(kind, dtype):
    """One step with ``cfg.remat`` on and off from the same state and draws,
    in float32 and in bfloat16 (a replayed block rounds at the same cast
    points): the same losses and, after Adam, the same parameters, within
    1e-6 of each tensor's largest value; the draws leave the generator in
    the same state (remat draws nothing)."""
    m_off, w_off, s_off = _one_step(kind, False, dtype)
    m_on, w_on, s_on = _one_step(kind, True, dtype)
    assert set(m_on) == set(m_off)
    for k in m_off:
        _close(m_on[k].reshape(1), m_off[k].reshape(1), EXACT, k)
    for k in w_off:
        _close(w_on[k], w_off[k], EXACT, k)
    g, _, d = _nets()
    start = {**{f"g.{k}": v for k, v in g.state_dict().items()},
             **{f"d.{k}": v for k, v in d.state_dict().items()}}
    assert any(not torch.equal(w_off[k], v) for k, v in start.items()), "no weight moved"
    assert torch.equal(s_on, s_off)
