"""Shared fixtures of the port's pruning tests: the tiny generator of the JAX
package's pruning tests, the JAX scorers' random draws rebuilt from their
keys (so that both packages see the same draws), and a comparison of
keep-masks that allows for near-equal scores."""

import numpy as np
import jax.numpy as jnp
from jax import random

from content_aware_gan_compression_tpu.models import GeneratorConfig as JaxGeneratorConfig
from content_aware_gan_compression_tpu.models import generator_make_noise
from content_aware_gan_compression_tpu.pruning import salt_pepper_noisy_images
from content_aware_gan_compression_torch.utils import build_generator_from_state_dict
from torch_eval_util import generator_tree
from torch_train_util import _t as t

SIZE, STYLE, N_MLP = 16, 32, 2
NET_SHAPE = (16, 16, 12, 12, 8, 8)  # tests/test_pruning.py's generator
JCFG = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=NET_SHAPE)


def generator_pair(seed=0, cfg=JCFG):
    """(the JAX tree as numpy, the port's Generator on the CPU holding it)."""
    tree = generator_tree(seed, cfg)
    return tree, build_generator_from_state_dict(tree, cfg.size, cfg.style_dim, cfg.n_mlp,
                                                 device="cpu")


def map_score_noise(key, n, batch_size, cfg=JCFG):
    """The noise JAX's get_map_based_score draws for each chunk: the key
    split once per chunk, ``generator_make_noise(sub, cfg, m)``."""
    out = []
    for _ in range(max(n // batch_size, 1)):
        key, sub = random.split(key)
        out.append([t(x) for x in generator_make_noise(sub, cfg, min(batch_size, n))])
    return out


def content_aware_draws(key, n_sample, batch_size, noise_prob, cfg=JCFG):
    """The draws of JAX's get_content_aware_pruning_score for each batch,
    as the port takes them: ``(z, noise, sp, bern)`` with sp and bern NHWC
    [B, H, W, 1]. The key splits in 4 per batch (z, noise, salt-and-pepper);
    sp and the Bernoulli mask are ``salt_pepper_noisy_images``'s with a mask
    that keeps every pixel."""
    n_batch = -(-n_sample // batch_size)
    img = jnp.zeros((batch_size, 3, cfg.size, cfg.size))
    everything = jnp.ones((batch_size, cfg.size, cfg.size), dtype=bool)
    out = []
    for _ in range(n_batch):
        key, kz, kn, ksp = random.split(key, 4)
        z = random.normal(kz, (batch_size, cfg.style_dim))
        noise = generator_make_noise(kn, cfg, batch_size)
        sp, bern = salt_pepper_noisy_images(ksp, img, everything, noise_prob)
        out.append((t(z), [t(x) for x in noise], t(np.transpose(np.asarray(sp), (0, 2, 3, 1))),
                    t(np.transpose(np.asarray(bern), (0, 2, 3, 1)) > 0.5)))
    return out


def jax_batch_draws(draws):
    """The port's draws of one batch in the JAX layout: (z, NHWC noise,
    sp [B, 1, H, W], replace [B, 1, H, W] float)."""
    z, noise, sp, bern = draws
    return (jnp.asarray(z.numpy()), [jnp.asarray(n.numpy()) for n in noise],
            jnp.asarray(sp.numpy().transpose(0, 3, 1, 2).astype(np.float32)),
            jnp.asarray(bern.numpy().transpose(0, 3, 1, 2).astype(np.float32)))


def assert_masks_match(masks_got, masks_want, scores_want, rmve_list, rtol):
    """Keep-masks equal where the scores allow it: a layer whose two scores
    on either side of the cut are closer than ``rtol`` of its largest score
    may swap them, so there only the channels clear of the cut by more than
    that are compared; every other layer must match exactly."""
    for lay, (got, want, s, rmv) in enumerate(zip(masks_got, masks_want, scores_want, rmve_list)):
        got, want, s = np.asarray(got), np.asarray(want), np.asarray(s, np.float64)
        tol = rtol * np.abs(s).max()
        if 0 < rmv < len(s):
            cut = np.sort(s)[rmv - 1:rmv + 1]
            if cut[1] - cut[0] <= tol:
                clear = np.abs(s - cut.mean()) > tol
                np.testing.assert_array_equal(got[clear], want[clear], err_msg=f"layer {lay}")
                continue
        np.testing.assert_array_equal(got, want, err_msg=f"layer {lay}")


def close_per_layer(got, want, rtol, skip_first=False):
    """Each layer's scores within ``rtol`` of that layer's largest |score|."""
    assert len(got) == len(want)
    for lay, (a, b) in enumerate(zip(got, want)):
        if skip_first and lay == 0:
            continue
        b = np.asarray(b)
        assert a.shape == b.shape, (lay, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * float(np.abs(b).max()),
                                   err_msg=f"layer {lay}")

