"""The PyTorch port's generator against the JAX generator_apply: the same
weights (a JAX generator_init tree, bridged with state_dict_from_jax), the
same z / W latents, noise maps and inject_index, on the CPU. JAX runs its
default lax path (the Pallas kernels are held equal to it by
tests/test_pallas_ops.py); the port runs its plain PyTorch path."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import (
    GeneratorConfig as JaxGeneratorConfig, generator_apply, generator_get_latent,
    generator_init,
)
from content_aware_gan_compression_torch.models import (
    Generator, GeneratorConfig, default_net_shape, net_shape_from_params,
)
from content_aware_gan_compression_torch.utils import state_dict_from_jax
from torch_train_util import torch_threads  # noqa: F401

ATOL = 1e-4
CONFIGS = {
    "uniform": dict(size=32, style_dim=16, n_mlp=2, net_shape=(16,) * 8),
    "pruned": dict(size=32, style_dim=16, n_mlp=2,
                   net_shape=(32, 24, 24, 16, 16, 12, 12, 8)),
}


def _jax_tree(name, seed=0):
    """generator_init params as numpy, with the noise weights, activation
    biases and ToRGB biases (zero at init) set to random values so the
    epilogue's every term is exercised."""
    cfg = JaxGeneratorConfig(**CONFIGS[name])
    params = jax.tree_util.tree_map(
        np.asarray, generator_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    for block in [params["conv1"], *params["convs"].values()]:
        block["noise"]["weight"] = rng.randn(1).astype(np.float32)
        block["activate"]["bias"] = 0.3 * rng.randn(
            *block["activate"]["bias"].shape).astype(np.float32)
    for trgb in [params["to_rgb1"], *params["to_rgbs"].values()]:
        trgb["bias"] = 0.1 * rng.randn(1, 3, 1, 1).astype(np.float32)
    return cfg, params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jcfg, params = _jax_tree(request.param)
    g = Generator(GeneratorConfig(**CONFIGS[request.param]), device="cpu")
    g.load_state_dict(state_dict_from_jax(params), strict=True)
    g.eval()
    return jcfg, params, g


def _noise(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1).astype(np.float32)
            for i in range(cfg.num_layers)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def test_forward_parity_fixed_z_and_noise(pair):
    jcfg, params, g = pair
    rng = np.random.RandomState(1)
    z = rng.randn(3, jcfg.style_dim).astype(np.float32)
    noise = _noise(jcfg, 3, 2)
    want = np.asarray(generator_apply(params, jcfg, [jnp.asarray(z)], noise=_j(noise)))
    with torch.no_grad():
        got = g([torch.from_numpy(z)], noise=_t(noise)).numpy()
    assert got.shape == want.shape == (3, 3, 32, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_truncation_and_tensor_inject_index_mixing(pair):
    jcfg, params, g = pair
    rng = np.random.RandomState(3)
    z1, z2 = (rng.randn(2, jcfg.style_dim).astype(np.float32) for _ in range(2))
    mean = rng.randn(1, jcfg.style_dim).astype(np.float32)
    noise = _noise(jcfg, 2, 4)
    for idx in (1, 3, jcfg.n_latent - 1):
        want = np.asarray(generator_apply(
            params, jcfg, [jnp.asarray(z1), jnp.asarray(z2)], inject_index=jnp.asarray(idx),
            truncation=0.7, truncation_latent=jnp.asarray(mean), noise=_j(noise)))
        with torch.no_grad():
            got = g([torch.from_numpy(z1), torch.from_numpy(z2)],
                    inject_index=torch.tensor(idx), truncation=0.7,
                    truncation_latent=torch.from_numpy(mean), noise=_t(noise)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_buffer_noise_latent_input_rgb_list_and_latents(pair):
    jcfg, params, g = pair
    rng = np.random.RandomState(5)
    w = rng.randn(2, jcfg.style_dim).astype(np.float32)
    want_list, want_lat = generator_apply(
        params, jcfg, latent_styles=[jnp.asarray(w)], input_is_latent=True,
        randomize_noise=False, return_rgb_list=True, return_latents=True)
    with torch.no_grad():
        got_list, got_lat = g([torch.from_numpy(w)], input_is_latent=True,
                              randomize_noise=False, return_rgb_list=True,
                              return_latents=True)
    assert len(got_list) == len(want_list) == jcfg.log_size - 1
    for a, b in zip(got_list, want_list):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), atol=1e-6, rtol=0)


def test_get_latent_parity(pair):
    jcfg, params, g = pair
    z = np.random.RandomState(6).randn(4, jcfg.style_dim).astype(np.float32)
    want = np.asarray(generator_get_latent(params, jcfg, jnp.asarray(z)))
    with torch.no_grad():
        got = g.get_latent(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_randomized_noise_and_mixing_follow_the_generator(pair):
    """Noise and the mixing point drawn from a torch.Generator: the same seed
    gives the same image, and the result equals passing those draws in."""
    _, _, g = pair
    z = torch.randn(2, g.config.style_dim, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = g([z, -z], generator=torch.Generator().manual_seed(9))
        b = g([z, -z], generator=torch.Generator().manual_seed(9))
        gen = torch.Generator().manual_seed(9)
        noise = g.make_noise(2, gen)
        idx = torch.randint(1, g.config.n_latent, (), generator=gen)
        c = g([z, -z], noise=noise, inject_index=idx)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_unported_outputs_raise(pair):
    """return_style_scalars (the sparsity slice) still raises; PPL_regularize
    is ported and returns the NHWC-y path lengths."""
    _, _, g = pair
    z = torch.zeros(1, g.config.style_dim)
    with pytest.raises(NotImplementedError):
        g([z], randomize_noise=False, return_style_scalars=True)
    image, lengths = g([z], randomize_noise=False, PPL_regularize=True,
                       generator=torch.Generator().manual_seed(0))
    assert image.shape == (1, 3, 32, 32) and lengths.shape == (1,)


def _grads_close(module, jax_grads, rtol):
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_grads))
    for name, p in module.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(want[name].abs().max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0,
                                   atol=rtol * scale, err_msg=name)


def test_parameter_gradients_match(pair):
    """Gradients of a weighted image sum in every parameter, two mixed
    styles: the backward runs Blur4Fn and the epilogue's MaskedScaleFn.
    Tolerance 1e-4 of each tensor's largest gradient (reordered fp32 sums)."""
    jcfg, params, g = pair
    rng = np.random.RandomState(7)
    z = [rng.randn(3, jcfg.style_dim).astype(np.float32) for _ in range(2)]
    noise = _noise(jcfg, 3, 8)
    w = rng.randn(3, 3, 32, 32).astype(np.float32)

    def loss_j(p):
        img = generator_apply(p, jcfg, _j(z), inject_index=jnp.asarray(2), noise=_j(noise))
        return jnp.sum(img * w)

    want = jax.jit(jax.grad(loss_j))(params)
    g.zero_grad(set_to_none=True)
    (g(_t(z), inject_index=torch.tensor(2), noise=_t(noise)) * torch.from_numpy(w)).sum().backward()
    _grads_close(g, want, 1e-4)
    g.zero_grad(set_to_none=True)


def test_path_lengths_and_their_gradients_match(pair):
    """PPL_regularize with JAX's own y: the path lengths ||J^T y|| and the
    gradient of their squared spread in every parameter, a grad of grad
    through the synthesis. Tolerance 1e-4 (lengths) and 2e-4 of each
    tensor's largest gradient: the second order doubles the reordered sums."""
    jcfg, params, g = pair
    rng = np.random.RandomState(9)
    z = [rng.randn(2, jcfg.style_dim).astype(np.float32) for _ in range(2)]
    noise = _noise(jcfg, 2, 10)
    key = jax.random.PRNGKey(3)
    y = np.asarray(jax.random.normal(key, (2, 32, 32, 3)))

    def loss_j(p):
        _, lengths = generator_apply(p, jcfg, _j(z), inject_index=jnp.asarray(3),
                                     noise=_j(noise), PPL_regularize=True, ppl_rng=key)
        return jnp.sum(jnp.square(lengths - 0.5)), lengths

    (_, want_len), want = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params)
    g.zero_grad(set_to_none=True)
    image, lengths = g(_t(z), inject_index=torch.tensor(3), noise=_t(noise),
                       PPL_regularize=True, ppl_noise=torch.from_numpy(y))
    assert image.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(lengths.detach().numpy(), np.asarray(want_len), rtol=1e-4)
    torch.square(lengths - 0.5).sum().backward()
    _grads_close(g, want, 2e-4)
    g.zero_grad(set_to_none=True)


def test_nhwc_output_format(pair):
    _, _, g = pair
    z = torch.randn(2, g.config.style_dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        nchw = g([z], randomize_noise=False)
        nhwc = g([z], randomize_noise=False, output_format="NHWC")
    torch.testing.assert_close(nhwc.permute(0, 3, 1, 2), nchw, rtol=0, atol=0)
    assert nhwc.is_contiguous()


def test_config_and_net_shape_match_jax():
    for size in (32, 256, 1024):
        assert default_net_shape(size) == JaxGeneratorConfig(size=size).net_shape
        cfg = GeneratorConfig(size=size)
        jcfg = JaxGeneratorConfig(size=size)
        assert (cfg.num_layers, cfg.n_latent, cfg.n_convs) == (
            jcfg.num_layers, jcfg.n_latent, jcfg.n_convs)
    with pytest.raises(ValueError):
        GeneratorConfig(size=32, net_shape=(8,) * 7)
    _, params = _jax_tree("pruned")
    assert net_shape_from_params(state_dict_from_jax(params)) == CONFIGS["pruned"]["net_shape"]


def test_init_matches_generator_init_layout_and_scale():
    """A fresh port Generator has the JAX tree's keys and shapes and the same
    init distributions (unit normals, lr_mlp-scaled MLP, modulation bias 1,
    zero noise weights and biases)."""
    cfg = GeneratorConfig(**CONFIGS["pruned"])
    g = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = g.state_dict()
    _, params = _jax_tree("pruned")
    want = state_dict_from_jax(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert abs(float(sd["style.1.weight"].std()) * cfg.lr_mlp - 1) < 0.2
    assert torch.all(sd["conv1.conv.modulation.bias"] == 1)
    assert torch.all(sd["convs.0.noise.weight"] == 0)
    assert torch.all(sd["to_rgbs.0.bias"] == 0)
    assert abs(float(sd["convs.0.conv.weight"].std()) - 1) < 0.1


def test_conv_outputs_stay_channels_last(monkeypatch):
    """Every convolution returns channels-last memory on the CPU, so
    ``_to_nhwc`` copies nothing and the blur and epilogue inputs are
    contiguous NHWC as they come."""
    from content_aware_gan_compression_torch.models import stylegan2

    cfg = GeneratorConfig(**CONFIGS["pruned"])
    g = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seen = []
    orig = stylegan2._to_nhwc

    def spy(x):
        seen.append(x.permute(0, 2, 3, 1).is_contiguous())
        return orig(x)

    monkeypatch.setattr(stylegan2, "_to_nhwc", spy)
    with torch.no_grad():
        g([torch.zeros(2, cfg.style_dim)], randomize_noise=False)
    assert len(seen) == cfg.n_convs + cfg.log_size - 1  # styled convs + ToRGBs
    assert all(seen)


def test_generator_without_device_raises_when_cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(GeneratorConfig(**CONFIGS["uniform"]))
