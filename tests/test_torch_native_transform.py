"""The port's native batch transform: against the JAX package's library,
built from the same source and flags (equal), against PIL's bilinear resize
(2.5/127.5: PIL rounds its horizontal pass to uint8), and the identity
resize and the flip (1e-6)."""

import numpy as np
import pytest

from content_aware_gan_compression_tpu.data import native_loader as jax_native_loader
from content_aware_gan_compression_torch.data import native_loader
from torch_train_util import torch_threads  # noqa: F401

THREADS = 2
SHAPES = [(64, 32), (32, 32), (48, 64), (40, 16)]


def _batch(seed, in_size, n=4):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, in_size, in_size, 3), dtype=np.uint8),
            np.array([0, 1] * (n // 2), np.uint8))


@pytest.mark.parametrize("in_size,out_size", SHAPES)
def test_equals_the_jax_packages_library(in_size, out_size):
    if jax_native_loader.get_lib() is None:
        pytest.fail("the JAX package's native library did not build")
    imgs, flips = _batch(in_size, in_size)
    got = native_loader.transform_batch(imgs, out_size, flips, num_threads=THREADS)
    want = jax_native_loader.transform_batch(imgs, out_size, flips, num_threads=THREADS)
    assert got.dtype == np.float32 and got.shape == (4, 3, out_size, out_size)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_size,out_size", SHAPES)
def test_matches_pil_bilinear(in_size, out_size):
    image = pytest.importorskip("PIL.Image")
    imgs, flips = _batch(in_size + 1, in_size)
    got = native_loader.transform_batch(imgs, out_size, flips, num_threads=THREADS)
    for i in range(len(imgs)):
        img = image.fromarray(imgs[i])
        if flips[i]:
            img = img.transpose(image.FLIP_LEFT_RIGHT)
        want = np.asarray(img.resize((out_size, out_size), image.BILINEAR),
                          np.float32).transpose(2, 0, 1) / 127.5 - 1.0
        np.testing.assert_allclose(got[i], want, rtol=0, atol=2.5 / 127.5)


def test_identity_resize_and_flip():
    imgs, _ = _batch(1, 16, n=2)
    plain = native_loader.transform_batch(imgs, 16, np.zeros(2, np.uint8), num_threads=THREADS)
    want = imgs.astype(np.float32).transpose(0, 3, 1, 2) / 127.5 - 1.0
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-6)
    flipped = native_loader.transform_batch(imgs, 16, np.ones(2, np.uint8), num_threads=THREADS)
    np.testing.assert_allclose(flipped, plain[..., ::-1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="flips"):
        native_loader.transform_batch(imgs, 16, np.ones(3, np.uint8))
