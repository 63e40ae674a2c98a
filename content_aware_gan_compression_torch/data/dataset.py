"""Training data from a pre-resized uint8 cache (the port's own copy of the
JAX package's ``data/dataset.py`` cache path; numpy only).

A cache is one ``.npy`` array uint8 [N, size, size, 3], built from an image
folder by the JAX package's ``prepare_data.py``/``build_uint8_cache``. Reads
are memmap copies, and flips happen at read time, as in the reference's train
transform (train.py:463-470). Training reads caches only: a folder without a
cache raises. ``ImageFolderDataset`` decodes image files with Pillow for the
real-image statistics (``calc_inception``, ``compute_real_stats_from_folder``);
Pillow is imported only when a folder is opened.
"""

from __future__ import annotations

import os

import numpy as np

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding an image folder needs Pillow, which is not installed; "
                          "read a uint8 .npy cache instead") from e
    return Image


class ImageFolderDataset:
    """The sorted images of a folder (reference dataset.py:8-28), each read
    as uint8 [size, size, 3]: flipped with probability 1/2 if
    ``random_flip``, then resized with Lanczos, the filter of the
    reference's dataset preparation (Miscellaneous/prepare_data.py:23), when
    not already at ``size``."""

    def __init__(self, image_folder: str, size: int, random_flip: bool = True):
        self.images_list = sorted(os.path.join(image_folder, f) for f in os.listdir(image_folder)
                                  if f.lower().endswith(IMAGE_EXTENSIONS))
        if not self.images_list:
            raise ValueError(f"no images in {image_folder}")
        _pillow()
        self.size = size
        self.random_flip = random_flip

    def __len__(self):
        return len(self.images_list)

    def load_uint8(self, index: int, rng: np.random.Generator | None) -> np.ndarray:
        image = _pillow()
        img = image.open(self.images_list[index]).convert("RGB")
        if self.random_flip and rng.random() < 0.5:
            img = img.transpose(image.FLIP_LEFT_RIGHT)
        if img.size != (self.size, self.size):
            img = img.resize((self.size, self.size), image.LANCZOS)
        return np.asarray(img, np.uint8)


class Uint8CacheDataset:
    """A uint8 [N, H, W, 3] ``.npy`` memmap with random horizontal flips."""

    def __init__(self, cache_path: str, random_flip: bool = True):
        self._arr = np.load(cache_path, mmap_mode="r")
        if self._arr.ndim != 4 or self._arr.shape[-1] != 3 or self._arr.dtype != np.uint8:
            raise ValueError(f"{cache_path}: expected uint8 [N, H, W, 3], "
                             f"got {self._arr.dtype} {self._arr.shape}")
        self.size = self._arr.shape[1]
        self.random_flip = random_flip
        self.cache_path = cache_path

    def __len__(self):
        return self._arr.shape[0]

    def load_batch_uint8(self, idxs, rng: np.random.Generator) -> np.ndarray:
        """One batch [B, H, W, 3] in one sorted read, each image flipped with
        probability 1/2."""
        batch = np.ascontiguousarray(self._arr[np.sort(np.asarray(idxs))])
        if self.random_flip:
            flips = rng.random(len(idxs)) < 0.5
            if flips.any():
                batch[flips] = batch[flips, :, ::-1]
        return batch


def cache_path_for(image_folder: str, size: int) -> str:
    """Where a folder's cache at ``size`` lives (the JAX package's name)."""
    return os.path.join(image_folder, f"uint8_cache_{size}.npy")


def open_dataset(path: str, size: int, random_flip: bool = True) -> Uint8CacheDataset:
    """A ``.npy`` cache given directly, or a folder holding the cache for
    ``size``."""
    if not path.endswith(".npy"):
        cache = cache_path_for(path, size)
        if not os.path.exists(cache):
            raise FileNotFoundError(
                f"no uint8 cache at {cache}: the port reads training images from a "
                f"cache only; build it with the JAX package's build_uint8_cache "
                f"(content_aware_gan_compression_tpu.data) or prepare_data.py")
        path = cache
    dataset = Uint8CacheDataset(path, random_flip=random_flip)
    if dataset.size != size:
        raise ValueError(f"{path} holds {dataset.size}px images, training wants {size}px")
    return dataset


def infinite_loader(dataset: Uint8CacheDataset, batch_size: int, *, seed: int = 0):
    """Endless uint8 [B, H, W, 3] batches: a fresh permutation each epoch,
    the last partial batch dropped (the reference's sample_data wrapper,
    train.py:136-139). The same seed gives the JAX package's batches."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(dataset))
        for b in range(len(order) // batch_size):
            yield dataset.load_batch_uint8(order[b * batch_size:(b + 1) * batch_size], rng)
