"""The port's FID InceptionV3 (models/inception.py) against the JAX package's,
on the CPU. The same ``inception_init`` tree at width 1/8, with random
batch-norm statistics (loaded into the port with strict=True), and the same
seeded numpy images go through ``inception_pool3``, jitted, and
``InceptionV3.forward``.

Tolerances: pool3 features within 1e-4 of the largest |feature| (fp32 sums in
another order, and the port folds batch norm into the convolution where JAX
scales after it); the resize and the average pool within 1e-6 absolute on
inputs of order 1.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from content_aware_gan_compression_tpu.models import inception as ji
from content_aware_gan_compression_torch.models import (
    POOL3_DIM, InceptionV3, load_fid_inception, pool3_dim)
from content_aware_gan_compression_torch.models.inception import _avgpool_excl_pad
from content_aware_gan_compression_torch.utils import build_inception_from_state_dict
from torch_eval_util import inception_tree, write_fid_inception
from torch_train_util import torch_threads  # noqa: F401

FEATURE_TOL = 1e-4


@pytest.fixture(scope="module")
def tree():
    return inception_tree()


@pytest.fixture(scope="module")
def net(tree):
    return build_inception_from_state_dict(tree, device="cpu").eval()


def _images(n, size, seed, low=-1.0):
    return np.random.RandomState(seed).uniform(low, 1.0, (n, 3, size, size)).astype(np.float32)


def _assert_features_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL * float(np.abs(want).max()))
    assert float(np.abs(want).max()) > 0


@pytest.mark.parametrize("size,normalize_input", [
    (32, False),   # the FID regime: [-1, 1] raw, upscaled to 299
    (32, True),    # the wrapper's [0, 1] -> [-1, 1] rescale
    (512, False),  # a downscale to 299, without antialias
])
def test_pool3_matches_jax(tree, net, size, normalize_input):
    x = _images(2, size, size, low=0.0 if normalize_input else -1.0)
    want = jax.jit(lambda p, x: ji.inception_pool3(p, x, normalize_input=normalize_input))(
        tree, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x), normalize_input=normalize_input).numpy()
    _assert_features_close(got, want)


@pytest.mark.parametrize("size", [32, 256, 512])
def test_resize_to_299_matches_jax(size):
    """The input resize alone: bilinear, half-pixel grid, no antialias, up
    from 32 and 256 and down from 512."""
    x = _images(1, size, 7)
    want = np.asarray(jax.image.resize(x, (1, 3, 299, 299), method="bilinear",
                                       antialias=False))
    got = F.interpolate(torch.from_numpy(x), size=(299, 299), mode="bilinear",
                        align_corners=False, antialias=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("side", [17, 8])
def test_average_pool_leaves_padding_out_of_the_count(side):
    """At the borders of Mixed_6's 17x17 and Mixed_7's 8x8 maps a window
    holds 4 or 6 elements, and the mean is over those alone."""
    x = np.random.RandomState(side).randn(2, side, side, 6).astype(np.float32)
    want = np.asarray(ji._avgpool_excl_pad(jnp.asarray(x)))
    got = _avgpool_excl_pad(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 0, 0], x[:, :2, :2].mean(axis=(1, 2)), rtol=0, atol=1e-6)


def test_pool3_dim_and_seeded_init_mirror_inception_init(tree, net):
    """The same keys and shapes as ``inception_init`` at width 1/8 and at
    full width, and the same feature width."""
    assert pool3_dim(net) == pool3_dim(tree) == ji.pool3_dim(tree) == 256
    want = {k: v.shape for k, v in build_inception_from_state_dict(tree, device="cpu")
            .state_dict().items()}
    got = InceptionV3(0.125, device="cpu", generator=torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in got.state_dict().items()} == want
    full = jax.eval_shape(lambda k: ji.inception_init(k), jax.random.PRNGKey(0))
    full_net = InceptionV3(device="cpu")
    assert pool3_dim(full_net) == ji.POOL3_DIM == POOL3_DIM
    assert {k: tuple(v.shape) for k, v in full_net.state_dict().items()} == {
        ".".join(p.key for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_leaves_with_path(full)}
    w = full_net.Mixed_5b.branch5x5_2.conv.weight
    np.testing.assert_allclose(float(w.detach().std()), (2.0 / (48 * 25)) ** 0.5, rtol=0.05)


def test_load_fid_inception_reads_the_pytorch_fid_schema(tree, tmp_path):
    """A file with ``fc.*``, ``AuxLogits.*`` and ``num_batches_tracked``
    loads in both packages, which then give the same features."""
    path = write_fid_inception(tmp_path / "pt_inception.pth", tree)
    jtree = ji.load_fid_inception(path)
    net = load_fid_inception(path, device="cpu")
    assert not any(k.startswith(("fc.", "AuxLogits.")) or "num_batches" in k
                   for k in net.state_dict())
    x = _images(2, 32, 1)
    want = jax.jit(lambda p, x: ji.inception_pool3(p, x, normalize_input=False))(jtree, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x), normalize_input=False).numpy()
    _assert_features_close(got, want)
