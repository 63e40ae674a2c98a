"""The port's FID (evaluation/fid.py) against the JAX package's, on the CPU.

The Frechet distance is float64 numpy in both: equal to 1e-10 relative on
the same statistics, in the singular (eps retry) case too. The feature step
(the generator with explicit noise, then Inception on raw [-1, 1] images)
is held to JAX's jitted ``_feature_step`` within 1e-4 of the largest
|feature|, the noise being what JAX draws from the step's key. The stream's
bookkeeping, the overlapped eval and the statistics pickles are checked
within the port and across the two packages.
"""

import pickle
import warnings

import numpy as np
import pytest
import jax
import torch

from content_aware_gan_compression_tpu.evaluation import fid as jfid
from content_aware_gan_compression_tpu.models import generator_make_noise
from content_aware_gan_compression_torch.evaluation import (
    OverlappedFIDEval, calc_fid, compute_real_stats_from_folder, extract_feature_from_samples,
    get_model_fid_score)
from content_aware_gan_compression_torch.evaluation import fid as pfid
from content_aware_gan_compression_torch.utils import (
    build_generator_from_state_dict, build_inception_from_state_dict)
from torch_eval_util import G_CFG, N_MLP, SIZE, STYLE, generator_tree, inception_tree
from torch_train_util import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def nets():
    g_tree, inc_tree = generator_tree(), inception_tree()
    g = build_generator_from_state_dict(g_tree, SIZE, STYLE, N_MLP, device="cpu").eval()
    return g_tree, inc_tree, g, build_inception_from_state_dict(inc_tree, device="cpu").eval()


def _spd(dim, n, seed):
    x = np.random.RandomState(seed).randn(n, dim)
    return x.mean(0), np.cov(x, rowvar=False)


def _stats(case):
    if case == "nilpotent":
        # sqrtm of a nilpotent product is not finite: the eps retry runs
        return np.zeros(2), np.array([[0.0, 1.0], [0.0, 0.0]]), np.ones(2), np.eye(2)
    n = {"full_rank": 64, "rank_deficient": 6}[case]
    (m1, c1), (m2, c2) = _spd(16, n, 1), _spd(16, n, 2)
    return m1, c1, m2, c2


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient", "nilpotent"])
def test_calc_fid_matches_jax(case):
    stats = _stats(case)
    if case == "nilpotent":
        with pytest.warns(RuntimeWarning, match="singular"):
            want = jfid.calc_fid(*stats)
        with pytest.warns(RuntimeWarning, match="singular"):
            got = calc_fid(*stats)
    else:
        want, got = jfid.calc_fid(*stats), calc_fid(*stats)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert np.isfinite(got) and got > 0


def test_calc_fid_raises_on_an_imaginary_component():
    """A product with a negative eigenvalue has a square root with an
    imaginary diagonal: both packages refuse it."""
    mean, a, b = np.zeros(2), np.diag([1.0, -1.0]), np.eye(2)
    for fn in (calc_fid, jfid.calc_fid):
        with pytest.raises(ValueError, match="Imaginary component"):
            fn(mean, a, mean, b)


def test_feature_step_matches_jax(nets):
    g_tree, inc_tree, g, inc = nets
    z = np.random.RandomState(4).randn(3, STYLE).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jfid._feature_step(g_tree, inc_tree, z, key, config=G_CFG, truncation=1.0,
                              truncation_latent=None, packed=False)
    noise = [torch.from_numpy(np.array(n)) for n in generator_make_noise(key, G_CFG, 3)]
    got = pfid._feature_step(g, inc, torch.from_numpy(z), noise=noise).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


def test_feature_stream_drops_the_surplus_rows(nets):
    """n_sample 10 at batch 4: three full batches, the last two rows
    dropped; the rows are those of the batches drawn one by one."""
    _, _, g, inc = nets
    feats = extract_feature_from_samples(g, inc, batch_size=4, n_sample=10,
                                         generator=torch.Generator().manual_seed(1))
    assert feats.shape == (10, 256) and feats.dtype == np.float64
    gen = torch.Generator().manual_seed(1)
    rows = torch.cat([pfid._draw_features(g, inc, 4, gen, 1.0, None) for _ in range(3)])
    np.testing.assert_array_equal(feats, rows[:10].numpy().astype(np.float64))


@pytest.mark.parametrize("n_sample", [10, 3])  # a residual batch; fewer samples than a batch
def test_overlapped_eval_equals_the_synchronous_score(nets, n_sample):
    _, _, g, inc = nets
    feats = extract_feature_from_samples(g, inc, batch_size=4, n_sample=8,
                                         generator=torch.Generator().manual_seed(5))
    stats = {"mean": feats.mean(0), "cov": np.cov(feats, rowvar=False) + np.eye(256) * 1e-3}
    sync = get_model_fid_score(g, inc, stats, batch_size=4, num_sample=n_sample,
                               generator=torch.Generator().manual_seed(11))
    ev = OverlappedFIDEval(g, inc, stats, batch_size=4, n_sample=n_sample,
                           generator=torch.Generator().manual_seed(11))
    scores = [ev.advance(1) for _ in range(4)]
    assert ev.done and scores[-1] is None
    assert [s is None for s in scores[:-1]] == [True] * (-(-n_sample // 4) - 1) + [False] + [
        True] * (3 - -(-n_sample // 4))
    overlapped = next(s for s in scores if s is not None)
    np.testing.assert_allclose(overlapped, sync, rtol=0, atol=0)
    assert np.isfinite(sync) and sync > 0


def test_stream_against_its_own_statistics_scores_near_zero(nets):
    """At n >= 2 * pool3_dim the covariance of the seeded Inception's features
    has full rank over the features that vary (a few of the narrow net's
    channels never pass the ReLU), no eps retry is taken, and the stream
    scores ~0 against its own statistics and > 0 against another stream's."""
    _, _, g, inc = nets
    feats = extract_feature_from_samples(g, inc, batch_size=128, n_sample=512,
                                         generator=torch.Generator().manual_seed(2))
    stats = pfid.feature_stats(feats)
    live = int((feats.std(0) > 0).sum())
    assert live >= 240 and np.linalg.matrix_rank(stats["cov"]) == live
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        same = calc_fid(stats["mean"], stats["cov"], stats["mean"], stats["cov"])
        other = get_model_fid_score(g, inc, stats, batch_size=128, num_sample=512,
                                    generator=torch.Generator().manual_seed(3))
    trace = float(np.trace(stats["cov"]))
    assert abs(same) < 1e-6 * trace
    assert other > 1e-3 * trace


def test_statistics_pickles_move_between_packages(nets, tmp_path):
    """Each package reads the pickle the other writes from an image folder,
    and the two agree on the mean and covariance."""
    from PIL import Image

    _, inc_tree, _, inc = nets
    folder = tmp_path / "real"
    folder.mkdir()
    rs = np.random.RandomState(11)
    for i in range(6):
        Image.fromarray(rs.randint(0, 256, (40, 40, 3), np.uint8)).save(folder / f"{i:05d}.png")
    jax_pkl, port_pkl = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    jfid.compute_real_stats_from_folder(str(folder), inc_tree, size=32, batch_size=4,
                                        save_path=jax_pkl)
    compute_real_stats_from_folder(str(folder), inc, size=32, batch_size=4, save_path=port_pkl)
    from_jax, from_port = pfid.load_real_stats(jax_pkl), jfid.load_real_stats(port_pkl)
    pfid._check_regime(from_jax)
    jfid._check_regime(from_port)
    assert set(from_jax) == set(from_port) == {"mean", "cov", "size", "inception_regime"}
    assert from_port["size"] == 32 and isinstance(from_port["mean"], np.ndarray)
    scale = float(np.abs(from_jax["mean"]).max())
    np.testing.assert_allclose(from_port["mean"], from_jax["mean"], rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(from_port["cov"], from_jax["cov"], rtol=0,
                               atol=1e-4 * float(np.abs(from_jax["cov"]).max()))
    with open(port_pkl, "rb") as f:
        assert pickle.load(f)["inception_regime"] == jfid.INCEPTION_REGIME


def test_check_regime_refuses_a_foreign_stamp():
    assert pfid.INCEPTION_REGIME == jfid.INCEPTION_REGIME
    for check in (pfid._check_regime, jfid._check_regime):
        check({"mean": 0})  # no stamp: built by the reference
        check({"inception_regime": pfid.INCEPTION_REGIME})
        with pytest.raises(ValueError, match="regime"):
            check({"inception_regime": "torchvision_inception[0,1]"})
