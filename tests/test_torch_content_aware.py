"""The port's content-aware scorer (pruning/content_aware.py) against the JAX
package's, on the CPU, on the tiny generator of tests/test_pruning.py with a
width-0.25 BiSeNet (seed ``PARSER_SEED``, whose parse of these images keeps
about 40% of the pixels). The JAX scorer's draws (z, noise, the +-1 values
and the Bernoulli mask) are rebuilt from its keys and handed to the port.

Tolerances:
  * the nearest resize of the content mask: exact;
  * per-layer scores: 1e-5 of each layer's largest score (fp32 on both sides
    agree to about 1e-6 here, so no float64 reference is needed);
  * keep-masks: exact where the scores' gap at the cut exceeds 1e-5.
"""

import numpy as np
import pytest
import jax
import torch
import torch.nn.functional as F

from content_aware_gan_compression_tpu.models import bisenet as jb
from content_aware_gan_compression_tpu.pruning import content_aware as jca
from content_aware_gan_compression_tpu.pruning import schedule as jsch
from content_aware_gan_compression_torch.models import make_parse_fn
from content_aware_gan_compression_torch.pruning import (
    generate_prune_mask_list, get_content_aware_pruning_score, get_uniform_remove_list)
from content_aware_gan_compression_torch.pruning import content_aware as pca
from content_aware_gan_compression_torch.utils import build_bisenet_from_state_dict
from torch_prune_util import (
    JCFG, NET_SHAPE, assert_masks_match, close_per_layer, content_aware_draws, generator_pair,
    jax_batch_draws)
from torch_train_util import PARSER_SEED, bisenet_tree
from torch_train_util import torch_threads  # noqa: F401

N_SAMPLE, BATCH, NOISE_PROB = 10, 4, 0.05  # two full batches and a residual of 2
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    """The generator pair, the parser in both packages (the JAX parse_fn is
    one object, so its jitted scoring batch compiles once) and the draws."""
    tree, g = generator_pair(0)
    parser_tree = bisenet_tree(0.25, seed=PARSER_SEED)
    net = build_bisenet_from_state_dict(parser_tree, device="cpu").eval()
    key = jax.random.PRNGKey(11)
    return {"tree": tree, "g": g, "jax_parse": jb.make_parse_fn(parser_tree),
            "parse": make_parse_fn(net, "NHWC"), "key": key,
            "draws": content_aware_draws(key, N_SAMPLE, BATCH, NOISE_PROB)}


@pytest.fixture(scope="module")
def scores(setup):
    """{with_parse: (JAX's per-batch scores, the port's)}."""
    out = {}
    for with_parse in (True, False):
        want = jca.get_content_aware_pruning_score(
            setup["tree"], JCFG, parse_fn=setup["jax_parse"] if with_parse else None,
            n_sample=N_SAMPLE, batch_size=BATCH, noise_prob=NOISE_PROB, rng=setup["key"])
        got = get_content_aware_pruning_score(
            setup["g"], parse_fn=setup["parse"] if with_parse else None, n_sample=N_SAMPLE,
            batch_size=BATCH, noise_prob=NOISE_PROB, draws=setup["draws"])
        out[with_parse] = (want, got)
    return out


@pytest.mark.parametrize("size", [256, 64, 32, 16])
def test_resize_mask_matches_jax(size):
    """nearest-exact samples JAX's half-pixel grid (512 -> 256 keeps rows
    1, 3, ...); plain nearest keeps rows 0, 2, ... and differs."""
    mask = np.random.RandomState(size).rand(2, 512, 512) < 0.5
    want = np.asarray(jax.jit(jca._resize_mask_to_image, static_argnums=1)(mask, size))
    got = pca._resize_mask_to_image(torch.from_numpy(mask), size).numpy()
    np.testing.assert_array_equal(got, want)
    plain = F.interpolate(torch.from_numpy(mask).float()[:, None], size=(size, size),
                          mode="nearest")[:, 0] > 0.5
    assert not np.array_equal(plain.numpy(), want)


def test_grad_scores_match_jax(setup):
    """One batch with explicit sp and a replace mask keeping 30% of pixels."""
    z, noise, sp, _ = setup["draws"][0]
    replace = torch.rand(BATCH, 16, 16, 1, generator=torch.Generator().manual_seed(0)) < 0.3
    zj, nj, spj, rj = jax_batch_draws((z, noise, sp, replace))
    want = jax.jit(lambda p, z, n, s, r: jca._grad_scores(p, JCFG, z, n, s, r))(
        setup["tree"], zj, nj, spj, rj)
    got = pca._grad_scores(setup["g"], z, noise, sp.float(), replace.float())
    close_per_layer([s.numpy() for s in got], want, TOL)
    assert [s.shape[0] for s in got] == list(NET_SHAPE)


@pytest.mark.parametrize("with_parse", [True, False], ids=["bisenet", "whole_image"])
def test_content_aware_score_matches_jax(scores, with_parse):
    """Per batch and per layer, over 2 full batches and the padded residual."""
    want, got = scores[with_parse]
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        close_per_layer(g, w, TOL)
        assert all(np.isfinite(s).all() and (s >= 0).all() for s in g)


def test_parse_keeps_part_of_the_image(setup, scores):
    """The parser's mask is mixed on these images, and the scores differ
    from the whole-image ones, so the parse path is really exercised."""
    z, noise, _, _ = setup["draws"][0]
    with torch.no_grad():
        img = setup["g"]([z], noise=noise, output_format="NHWC")
    parsing = pca.batch_img_parsing(img, setup["parse"], data_format="NHWC")
    share = float(pca.coi_mask_from_parsing(parsing).float().mean())
    assert 0.02 < share < 0.98
    assert not np.allclose(scores[True][1][0][-1], scores[False][1][0][-1])


def test_padded_rows_contribute_nothing(setup, scores):
    """The residual batch's surplus rows have a zero replace mask: other
    draws in those rows leave the scores as they are, and the scores equal
    those of the valid rows alone."""
    _, got = scores[False]
    z, noise, sp, bern = setup["draws"][-1]
    surplus = torch.arange(BATCH) >= 2
    rows = lambda x: surplus.reshape(-1, *[1] * (x.dim() - 1))  # noqa: E731
    other = [(torch.where(rows(z), torch.randn(z.shape), z),
              [torch.where(rows(n), torch.randn(n.shape), n) for n in noise],
              torch.where(rows(sp), -sp, sp), torch.where(rows(bern), ~bern, bern))]
    swapped = get_content_aware_pruning_score(
        setup["g"], parse_fn=None, n_sample=2, batch_size=BATCH, noise_prob=NOISE_PROB,
        draws=other)
    close_per_layer(swapped[0], got[-1], 1e-6)
    alone = pca._grad_scores(setup["g"], z[:2], [n[:2] for n in noise], sp[:2].float(),
                             bern[:2].float())
    close_per_layer([s.numpy() for s in alone], got[-1], TOL)


def test_keep_masks_match_jax(scores):
    """prune.py's sum over batches, the 0.7 remove list and the argsort."""
    for want, got in scores.values():
        total_want = [sum(b[i] for b in want) for i in range(len(NET_SHAPE))]
        total_got = [sum(b[i] for b in got) for i in range(len(NET_SHAPE))]
        rmv = get_uniform_remove_list(NET_SHAPE, 0.7)
        assert_masks_match(generate_prune_mask_list(total_got, NET_SHAPE, rmv),
                           jsch.generate_prune_mask_list(total_want, NET_SHAPE, rmv),
                           total_want, rmv, TOL)


def test_draws_come_from_the_generator(setup):
    """Without draws the scorer takes them from ``generator``, in
    ``draw_scoring_batch``'s order: a seeded generator gives the same scores
    as its draws handed in."""
    g = setup["g"]
    got = get_content_aware_pruning_score(g, parse_fn=None, n_sample=BATCH, batch_size=BATCH,
                                          noise_prob=0.3,
                                          generator=torch.Generator().manual_seed(3))
    draws = [pca.draw_scoring_batch(g, BATCH, 0.3, torch.Generator().manual_seed(3))]
    want = get_content_aware_pruning_score(g, parse_fn=None, n_sample=BATCH, batch_size=BATCH,
                                           noise_prob=0.3, draws=draws)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    z, noise, sp, bern = draws[0]
    assert set(np.unique(sp.numpy())) == {-1, 1} and 0.2 < bern.float().mean() < 0.4
    assert [tuple(n.shape) for n in noise] == [tuple(n.shape) for n in g.make_noise(BATCH)]
    assert z.shape == (BATCH, JCFG.style_dim)
