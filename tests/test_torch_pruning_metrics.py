"""The port's pruning metrics, the generator's helpers that feed them and the
baseline scorers (pruning/metrics.py, pruning/schedule.py,
``Generator.feature_maps`` / ``modulation_styles`` / ``effective_weight_means``)
against the JAX package's, on the CPU, on the tiny generator of
tests/test_pruning.py. Both packages get the same weights and the same draws:
the JAX scorer's noise is rebuilt from its keys and handed to the port.

Tolerances (fp32 on both sides, reductions in another order):
  * metrics on seeded arrays: 1e-5 relative;
  * feature maps, styles, effective kernels: 1e-5 of each layer's largest value;
  * baseline scores: 1e-4 of each layer's largest score; the constant input's
    ASV-family scores are exactly 0 in the port (JAX's are rounding: ASV
    below 1e-6 of the input's largest |value|, the ratios below 1e-6);
  * remove lists and masks: exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import stylegan2 as js
from content_aware_gan_compression_tpu.pruning import metrics as jm
from content_aware_gan_compression_tpu.pruning import schedule as jsch
from content_aware_gan_compression_torch.pruning import metrics as pm
from content_aware_gan_compression_torch.pruning import schedule as psch
from torch_prune_util import (
    JCFG, NET_SHAPE, STYLE, close_per_layer, generator_pair, map_score_noise, t)
from torch_train_util import torch_threads  # noqa: F401

MAP_METRICS = ("ASV", "l1-map", "l1-norm-ASV", "l2-norm-ASV")


@pytest.fixture(scope="module")
def pair():
    return generator_pair(0)


@pytest.fixture(scope="module")
def z():
    return np.random.RandomState(1).randn(7, STYLE).astype(np.float32)


@pytest.mark.parametrize("name", ["asv_score", "map_l1_norm", "map_l2_norm",
                                  "l1_normalized_asv", "l2_normalized_asv",
                                  "outgoing_l1_norm", "incoming_l1_norm"])
def test_metrics_match_jax(name):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 5, 4, 3).astype(np.float32)  # NCHW maps, or an OIHW kernel
    want = np.asarray(jax.jit(getattr(jm, name))(x))
    got = getattr(pm, name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_feature_maps_match_jax(pair, z):
    """NHWC maps, len(net_shape) of them, one W for every layer."""
    tree, g = pair
    noise = js.generator_make_noise(jax.random.PRNGKey(2), JCFG, z.shape[0])
    want = jax.jit(lambda p, z, n: js.generator_feature_maps(p, JCFG, z, noise=n))(
        tree, z, noise)
    with torch.no_grad():
        got = g.feature_maps(torch.from_numpy(z), [t(n) for n in noise])
    assert len(got) == len(NET_SHAPE)
    for lay, (a, b) in enumerate(zip(got, want)):
        b = np.transpose(np.asarray(b), (0, 2, 3, 1))
        assert a.shape == b.shape == (z.shape[0], *b.shape[1:3], NET_SHAPE[lay])
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("helper", ["modulation_styles", "effective_weight_means"])
def test_style_helpers_match_jax(pair, z, helper):
    """s = A(W) of [conv1] + convs + [to_rgbs[-1]], and the batch-mean
    (de)modulated kernels, ToRGB's without demodulation."""
    tree, g = pair
    fn = getattr(js, f"generator_{helper}")
    want = jax.jit(lambda p, z: fn(p, JCFG, z))(tree, z)
    with torch.no_grad():
        got = getattr(g, helper)(torch.from_numpy(z))
    assert len(got) == len(NET_SHAPE)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("metric", MAP_METRICS)
@pytest.mark.parametrize("n,batch_size", [(7, 3), (4, 10)], ids=["residual", "short_n"])
def test_map_based_score_matches_jax(pair, z, metric, n, batch_size):
    """The streaming moments: 7 samples at batch 3 drop the seventh; 4 at
    batch 10 are one chunk of 4. JAX's per-chunk noise goes to the port."""
    tree, g = pair
    key = jax.random.PRNGKey(3)
    want = jsch.get_map_based_score(tree, JCFG, jnp.asarray(z[:n]), key, metric, batch_size)
    got = psch.get_map_based_score(g, torch.from_numpy(z[:n]), metric, batch_size,
                                   noise=map_score_noise(key, n, batch_size))
    close_per_layer(got, want, 1e-4, skip_first=metric != "l1-map")
    if metric != "l1-map":
        # the constant input has a std of 0: exactly 0 in the port, rounding
        # in JAX (ASV in the input's units, the ratios dimensionless)
        scale = np.abs(tree["input"]["input"]).max() if metric == "ASV" else 1.0
        assert (got[0] == 0).all()
        assert np.abs(want[0]).max() <= 1e-6 * scale


def test_map_score_draws_noise_from_the_generator(pair, z):
    """Without noise the chunks draw it from the generator: the same seed
    gives the same scores, and the constant input's ASV is exactly 0."""
    _, g = pair
    runs = [psch.get_network_score_list(g, torch.from_numpy(z), "ASV", batch_size=3,
                                        generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert (runs[0][0] == 0).all() and all((s > 0).all() for s in runs[0][1:])
    with pytest.raises(ValueError):
        psch.get_map_based_score(g, torch.from_numpy(z), "ASV")


@pytest.mark.parametrize("metric", ["l1-out", "l1-in", "l1-style"])
def test_weight_and_style_scores_match_jax(pair, z, metric):
    """l1-out and l1-style against JAX; l1-in's first entry is a uniform draw
    of width net_shape[0], so only its shape and range are checked."""
    tree, g = pair
    want = jsch.get_network_score_list(tree, JCFG, jnp.asarray(z), metric,
                                       rng=jax.random.PRNGKey(4))
    got = psch.get_network_score_list(g, torch.from_numpy(z), metric,
                                      generator=torch.Generator().manual_seed(4))
    assert [s.shape[0] for s in got] == list(NET_SHAPE)
    if metric == "l1-in":
        assert (got[0] >= 0).all() and (got[0] < 1).all()
        # JAX's head draw, handed in, comes out as it went in
        head = jax.random.uniform(jax.random.PRNGKey(4), (NET_SHAPE[0],))
        with_head = psch.get_weight_based_score(g, torch.from_numpy(z), metric, head=t(head))
        np.testing.assert_array_equal(with_head[0], want[0])
        got, want = got[1:], want[1:]
    close_per_layer(got, want, 1e-4)


def test_random_scores_align_with_net_shape(pair, z):
    _, g = pair
    a, b = (psch.get_network_score_list(g, torch.from_numpy(z), "Random",
                                        generator=torch.Generator().manual_seed(6))
            for _ in range(2))
    assert [s.shape for s in a] == [(c,) for c in NET_SHAPE]
    assert all(((s >= 0) & (s < 1)).all() for s in a)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        psch.get_network_score_list(g, torch.from_numpy(z), "l3-norm")


@pytest.mark.parametrize("keep_multiple", [1, 4, 64])
def test_uniform_remove_list_matches_jax(keep_multiple):
    for shape in (NET_SHAPE, (512,) * 10 + (256, 256, 128, 128), (7, 3, 1, 100)):
        for ratio in (0.0, 0.3, 0.5, 0.7, 0.99):
            assert psch.get_uniform_remove_list(shape, ratio, keep_multiple) == \
                jsch.get_uniform_remove_list(shape, ratio, keep_multiple)
    # the 11x student of the 256px generator
    full = [512] * 10 + [256] * 2 + [128] * 2
    assert [c - r for c, r in zip(full, psch.get_uniform_remove_list(full, 0.7))] == \
        [154] * 10 + [77] * 2 + [39] * 2


def test_prune_masks_match_jax():
    """Distinct scores, and ties: both packages argsort the same numpy
    arrays, so equal scores give equal masks."""
    rng = np.random.RandomState(7)
    scores = [rng.permutation(c).astype(np.float32) for c in NET_SHAPE]
    scores[2] = np.repeat(np.arange(6, dtype=np.float32), 2)  # pairs of equal scores
    for ratio in (0.3, 0.7):
        rmv = psch.get_uniform_remove_list(NET_SHAPE, ratio)
        got = psch.generate_prune_mask_list(scores, NET_SHAPE, rmv)
        want = jsch.generate_prune_mask_list(scores, NET_SHAPE, rmv)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert [int(m.sum()) for m in got] == [c - r for c, r in zip(NET_SHAPE, rmv)]
    with pytest.raises(ValueError):
        psch.generate_prune_mask_list([np.zeros(3)], (4,), [1])
