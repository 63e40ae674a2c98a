"""The port's checkpoint bridge against the JAX package's I/O: .npz round
trips in both directions (bf16 leaves included), JAX generator_init trees and
reference-style .pt state dicts loading into the port's Generator with
strict=True."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import (
    GeneratorConfig as JaxGeneratorConfig, generator_init)
from content_aware_gan_compression_tpu.utils import checkpoint as jckpt
from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
from content_aware_gan_compression_torch.utils import (
    build_generator_from_state_dict, load_checkpoint, load_generator,
    pytree_to_torch_state_dict, save_checkpoint, state_dict_from_jax,
    torch_state_dict_to_pytree,
)

SIZE, STYLE_DIM, N_MLP = 16, 8, 1
NET_SHAPE = (12, 12, 10, 8, 8, 6)


def _jax_params():
    cfg = JaxGeneratorConfig(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, net_shape=NET_SHAPE)
    return generator_init(jax.random.PRNGKey(0), cfg)


def test_jax_npz_loads_in_the_port_with_bf16_leaves(tmp_path):
    rng = np.random.RandomState(0)
    nu = jnp.asarray(rng.randn(4, 5), jnp.bfloat16)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, {"g_ema": _jax_params(),
                                 "g_optim": {"nu": {"w": nu},
                                             "count": jnp.zeros((), jnp.int32)}},
                          metadata={"iter": 3})
    trees, meta = load_checkpoint(path)
    assert meta == {"iter": 3}
    got = trees["g_optim"]["nu"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(nu).view(np.uint16))
    assert trees["g_optim"]["count"].dtype == torch.int32
    want = pytree_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, _jax_params()))
    got_sd = pytree_to_torch_state_dict(trees["g_ema"])
    assert set(got_sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(got_sd[k].numpy(), want[k])


def test_port_npz_loads_in_jax_with_bf16_leaves(tmp_path):
    cfg = GeneratorConfig(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, net_shape=NET_SHAPE)
    g = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    half = torch.randn(3, 2, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, {"g_ema": g.state_dict(), "extra": {"h": half}},
                    metadata={"size": SIZE})
    trees, meta = jckpt.load_checkpoint(path)
    assert meta == {"size": SIZE}
    assert trees["extra"]["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(trees["extra"]["h"]).view(np.uint16),
                                  half.view(torch.int16).numpy().view(np.uint16))
    jsd = jckpt.pytree_to_torch_state_dict(trees["g_ema"])
    sd = g.state_dict()
    assert set(jsd) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(jsd[k], v.numpy())
    # and back through the port's own reader
    ptrees, _ = load_checkpoint(path)
    assert ptrees["extra"]["h"].dtype == torch.bfloat16
    torch.testing.assert_close(ptrees["extra"]["h"], half, rtol=0, atol=0)


def test_state_dict_from_jax_loads_strict():
    params = _jax_params()
    sd = state_dict_from_jax(params)
    g = build_generator_from_state_dict(sd, SIZE, STYLE_DIM, N_MLP, device="cpu")
    assert g.config.net_shape == NET_SHAPE
    for k, v in g.state_dict().items():
        node = params
        for p in k.split("."):
            node = node[p]
        np.testing.assert_array_equal(v.numpy(), np.asarray(node))


def test_reference_pt_checkpoint_loads_with_fir_buffers_dropped(tmp_path):
    """A reference-layout .pt (flat state dict with FIR 'kernel' buffers)
    loads through load_generator; the buffers are regenerated, not read."""
    sd = {k: torch.tensor(np.asarray(v)) for k, v in
          jckpt.pytree_to_torch_state_dict(_jax_params()).items()}
    sd.update({k: torch.tensor(np.asarray(v)) for k, v in
               jckpt.generator_fir_buffers(JaxGeneratorConfig(
                   size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                   net_shape=NET_SHAPE)).items()})
    path = str(tmp_path / "ref.pt")
    torch.save({"g_ema": sd, "iter": 5}, path)
    g = load_generator(path, SIZE, STYLE_DIM, N_MLP, device="cpu")
    for k, v in g.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_nest_and_flatten_roundtrip():
    sd = {"a.b.c": torch.ones(2), "a.d": torch.zeros(3), "e": torch.full((1,), 7.0),
          "blur.kernel": torch.ones(4, 4)}
    tree = torch_state_dict_to_pytree(sd)
    assert "blur" not in tree
    back = pytree_to_torch_state_dict(tree)
    assert set(back) == set(sd) - {"blur.kernel"}
    assert set(state_dict_from_jax(sd)) == set(back)
    # the same nesting as the JAX package's
    want = jckpt.torch_state_dict_to_pytree({k: v.numpy() for k, v in sd.items()})
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: t.numpy(), tree))
