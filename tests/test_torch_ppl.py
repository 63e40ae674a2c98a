"""The port's PPL (evaluation/ppl.py) against the JAX package's, on the CPU.

``_ppl_batch`` gets the same generator and LPIPS trees, z, lerp positions and
noise (what JAX draws from the batch's key) in both packages, at 16px and at
512px (where the images are pooled to 256 before LPIPS), at the default eps
1e-4 and at 0.1: the distances agree within 1e-4 relative (fp32 sums in
another order; about 1e-6 is seen). ``slerp`` and ``lerp`` within 1e-6. The score's percentile filter, residual slot and eps^2 division
are held to a numpy recomputation from ``return_distances``.
"""

from functools import partial

import numpy as np
import pytest
import jax
import torch

from content_aware_gan_compression_tpu.evaluation import ppl as jppl
from content_aware_gan_compression_tpu.models import GeneratorConfig as JaxGeneratorConfig
from content_aware_gan_compression_tpu.models import generator_make_noise
from content_aware_gan_compression_torch.evaluation import get_ppl_score, lerp, slerp
from content_aware_gan_compression_torch.evaluation import ppl as pppl
from content_aware_gan_compression_torch.utils import (
    build_generator_from_state_dict, build_lpips_from_state_dict)
from torch_eval_util import G_CFG, N_MLP, STYLE, generator_tree, lpips_tree
from torch_train_util import torch_threads  # noqa: F401

CFGS = {16: G_CFG,
        512: JaxGeneratorConfig(size=512, style_dim=STYLE, n_mlp=N_MLP, net_shape=(8,) * 16)}
PAIRS = 2


@pytest.fixture(scope="module")
def lpips():
    tree = lpips_tree()
    return tree, build_lpips_from_state_dict(tree, device="cpu").eval()


@pytest.fixture(scope="module")
def g16():
    tree = generator_tree(cfg=G_CFG)
    return tree, build_generator_from_state_dict(tree, 16, STYLE, N_MLP, device="cpu").eval()


@pytest.mark.parametrize("size,eps", [(16, 1e-4), (16, 0.1), (512, 1e-4)])
def test_ppl_batch_matches_jax(lpips, g16, size, eps):
    lp_tree, lp = lpips
    cfg = CFGS[size]
    if size == 16:
        g_tree, g = g16
    else:
        g_tree = generator_tree(cfg=cfg)
        g = build_generator_from_state_dict(g_tree, size, STYLE, N_MLP, device="cpu").eval()
    rng = np.random.RandomState(size)
    z = rng.randn(2 * PAIRS, STYLE).astype(np.float32)
    lerp_t = rng.uniform(size=PAIRS).astype(np.float32)
    key = jax.random.PRNGKey(3)
    step = jax.jit(partial(jppl._ppl_batch, config=cfg, eps=eps, packed=False))
    want = np.asarray(step(g_tree, lp_tree, z=z, lerp_t=lerp_t, rng=key))
    noise = [torch.from_numpy(np.array(n)) for n in generator_make_noise(key, cfg, 2 * PAIRS)]
    got = pppl._ppl_batch(g, lp, torch.from_numpy(z), torch.from_numpy(lerp_t), eps,
                          noise=noise).numpy()
    assert got.shape == want.shape == (PAIRS,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert (want > 0).all()


def test_slerp_and_lerp_match_jax():
    rng = np.random.RandomState(9)
    a, b = rng.randn(3, 8).astype(np.float32), rng.randn(3, 8).astype(np.float32)
    t = rng.uniform(size=(3, 1)).astype(np.float32)
    ta, tb, tt = map(torch.from_numpy, (a, b, t))
    np.testing.assert_allclose(slerp(ta, tb, tt).numpy(), np.asarray(jppl.slerp(a, b, t)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(lerp(ta, tb, tt).numpy(), np.asarray(jppl.lerp(a, b, t)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(slerp(ta, tb, 0.0).numpy(),
                               a / np.linalg.norm(a, axis=-1, keepdims=True), rtol=0, atol=1e-6)


def test_score_filters_percentiles_and_keeps_the_residual_slot(lpips, g16):
    """n_sample 10 at batch 4: two batches and a residual batch of which the
    first 2 distances are kept; the score is the mean between the lower 1st
    and higher 99th percentiles of those 10."""
    _, g = g16
    _, lp = lpips
    score, dist = get_ppl_score(g, lp, n_sample=10, batch_size=4, eps=0.1,
                                generator=torch.Generator().manual_seed(4),
                                return_distances=True)
    assert dist.shape == (10,) and np.isfinite(dist).all() and (dist >= 0).all()
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    assert lo == dist.min() and hi == dist.max()
    np.testing.assert_allclose(score, dist[(dist >= lo) & (dist <= hi)].mean(), rtol=1e-12)
    gen = torch.Generator().manual_seed(4)  # replay the three batches' draws
    batches = []
    for _ in range(3):
        z = torch.randn(8, STYLE, generator=gen)
        t = torch.rand(4, generator=gen)
        batches.append(pppl._ppl_batch(g, lp, z, t, 0.1, generator=gen))
    np.testing.assert_array_equal(dist, torch.cat(batches)[:10].numpy())


def test_divide_eps_sq(lpips, g16):
    """The same draws with ``divide_eps_sq``: every distance over eps^2, so
    the same ones pass the filter."""
    _, g = g16
    _, lp = lpips
    kw = dict(n_sample=8, batch_size=4, eps=1e-2, return_distances=True)
    score, dist = get_ppl_score(g, lp, generator=torch.Generator().manual_seed(6), **kw)
    score_d, dist_d = get_ppl_score(g, lp, generator=torch.Generator().manual_seed(6),
                                    divide_eps_sq=True, **kw)
    np.testing.assert_allclose(dist_d, dist / 1e-4, rtol=1e-6)
    np.testing.assert_allclose(score_d, score / 1e-4, rtol=1e-6)
