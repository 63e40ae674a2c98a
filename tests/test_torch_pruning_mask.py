"""The port's checkpoint surgery (pruning/mask.py, flat state-dict slicing)
against the JAX package's pytree surgery, on the CPU: the same generator
and keep-masks give the same tensors, key by key and exactly; the pruned
state dict loads into ``Generator`` through ``net_shape_from_params``; and
its images match the JAX package's pruned generator at fixed z and noise
within 1e-4 of their largest magnitude. The JAX package's pruned
checkpoint loads into the port.
"""

import numpy as np
import pytest
import jax
import torch

from content_aware_gan_compression_tpu.models import stylegan2 as js
from content_aware_gan_compression_tpu.pruning import mask_the_generator as jax_mask
from content_aware_gan_compression_tpu.utils import save_checkpoint as jax_save_checkpoint
from content_aware_gan_compression_torch.models import net_shape_from_params
from content_aware_gan_compression_torch.pruning import (
    generate_prune_mask_list, get_uniform_remove_list, mask_the_generator)
from content_aware_gan_compression_torch.utils import (
    build_generator_from_state_dict, load_generator, pytree_to_torch_state_dict)
from torch_prune_util import JCFG, NET_SHAPE, N_MLP, SIZE, STYLE, generator_pair, t
from torch_train_util import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def pruned():
    """(JAX tree, port generator, masks, JAX's pruned tree, the port's)."""
    tree, g = generator_pair(0)
    rng = np.random.RandomState(8)
    scores = [rng.permutation(c) for c in NET_SHAPE]
    masks = generate_prune_mask_list(scores, NET_SHAPE, get_uniform_remove_list(NET_SHAPE, 0.5))
    return tree, g, masks, jax_mask(tree, masks), mask_the_generator(g.state_dict(), masks)


def test_mask_matches_jax_surgery(pruned):
    tree, g, masks, want_tree, got = pruned
    want = pytree_to_torch_state_dict(want_tree)
    assert set(got) == set(want) == set(g.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    # the copied entries are the same values, the sliced ones are narrower
    assert got["style.1.weight"].shape == g.state_dict()["style.1.weight"].shape
    assert got["to_rgbs.1.conv.weight"].shape[2] == int(masks[5].sum())
    with pytest.raises(ValueError):
        mask_the_generator(g.state_dict(), masks[:-1])


def test_pruned_generator_loads_and_matches_jax(pruned, tmp_path):
    """net_shape read off the sliced tensors; images at fixed z and noise;
    JAX's pruned tree, saved by the JAX package, loads into the port."""
    _, _, masks, want_tree, got = pruned
    shape = tuple(int(m.sum()) for m in masks)
    assert net_shape_from_params(got) == shape == (8, 8, 6, 6, 4, 4)
    g_small = build_generator_from_state_dict(got, SIZE, STYLE, N_MLP, device="cpu")
    assert g_small.config.net_shape == shape
    path = str(tmp_path / "jax_pruned.npz")
    jax_save_checkpoint(path, {"g": want_tree, "g_ema": want_tree})
    g_jax = load_generator(path, SIZE, STYLE, N_MLP, device="cpu")
    for k, v in g_jax.state_dict().items():
        torch.testing.assert_close(v, g_small.state_dict()[k], rtol=0, atol=0)
    cfg = js.GeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=shape)
    z = np.random.RandomState(9).randn(3, STYLE).astype(np.float32)
    noise = js.generator_make_noise(jax.random.PRNGKey(10), JCFG, 3)
    want = np.asarray(jax.jit(lambda p, z, n: js.generator_apply(p, cfg, [z], noise=n))(
        want_tree, z, noise))
    with torch.no_grad():
        img = g_small([torch.from_numpy(z)], noise=[t(n) for n in noise]).numpy()
    assert img.shape == want.shape == (3, 3, SIZE, SIZE)
    np.testing.assert_allclose(img, want, rtol=0, atol=1e-4 * np.abs(want).max())
