"""Training data: image folders, the pre-resized uint8 cache and a
prefetching loader (the port's own copy of the JAX package's
``data/dataset.py``; numpy, and Pillow where it is installed).

``FFHQDataset`` decodes an image per read (reference dataset.py:8-28) and
applies the reference's train transform (train.py:463-470): a random
horizontal flip, a resize to ``size`` (bilinear; Lanczos, the filter of the
reference's dataset preparation, for the real-image statistics), [-1, 1].
``build_uint8_cache`` pays decode and resize once into a uint8 [N, size,
size, 3] ``.npy`` memmap (``Uint8CacheDataset``), whose reads are copies.
``open_dataset`` takes a ``.npy`` cache, a folder's prebuilt cache, or the
folder itself, in that order. ``data_loader`` shuffles each epoch and makes
batches in a producer thread ahead of the consumer; the same seed gives the
JAX package's batches.

Without Pillow, PNGs decode through
``utils.logging.read_png`` (PNG is lossless: the same pixels as Pillow's),
float batches resize through the native transform, and a uint8 read that
needs a resize raises. ``data_loader`` prints which decoder and which resize
its batches take.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import native_loader

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
RESAMPLE = ("bilinear", "lanczos")


def _pil():
    """Pillow's ``Image`` module, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _need_pil(what: str):
    image = _pil()
    if image is None:
        raise ImportError(f"{what} needs Pillow, which is not installed; read a uint8 .npy "
                          f"cache instead, or build one where Pillow is (prepare_data)")
    return image


def _rgb(arr: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] with C = 1, 3 or 4 as RGB, as Pillow's
    ``convert('RGB')`` does: grey repeated, alpha dropped."""
    if arr.shape[-1] == 1:
        return np.repeat(arr, 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


class FFHQDataset:
    """The sorted images of a folder (reference dataset.py:8-28), decoded per
    read. ``resample`` is "bilinear", the reference's train transform
    (transforms.Resize, train.py:466), or "lanczos", its dataset preparation's
    filter (Miscellaneous/prepare_data.py:23), which the real-image
    statistics use."""

    def __init__(self, image_folder: str, size: int, random_flip: bool = True,
                 resample: str = "bilinear"):
        self.images_list = sorted(os.path.join(image_folder, f) for f in os.listdir(image_folder)
                                  if f.lower().endswith(IMAGE_EXTENSIONS))
        if not self.images_list:
            raise ValueError(f"no images in {image_folder}")
        if resample not in RESAMPLE:
            raise ValueError(f"resample must be one of {RESAMPLE}, got {resample!r}")
        self.image_folder = image_folder
        self.size = size
        self.random_flip = random_flip
        self.resample = resample

    def __len__(self):
        return len(self.images_list)

    @property
    def decoder(self) -> str:
        """What decodes the files: Pillow where installed, else ``read_png``."""
        return "Pillow" if _pil() is not None else "read_png (no Pillow: PNG files only)"

    def decode(self, index: int) -> np.ndarray:
        """One image as uint8 [H, W, 3], untransformed."""
        path = self.images_list[index]
        image = _pil()
        if image is not None:
            with image.open(path) as img:
                return np.asarray(img.convert("RGB"), np.uint8)
        if not path.lower().endswith(".png"):
            _need_pil(f"decoding {path} (only PNG files are read without it)")
        from ..utils.logging import read_png

        return _rgb(read_png(path))

    def load_uint8(self, index: int, rng: np.random.Generator | None) -> np.ndarray:
        """Decode, flip with probability 1/2 (if ``random_flip``) and resize
        with Pillow when not at ``size``: uint8 [size, size, 3]."""
        arr = self.decode(index)
        if self.random_flip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        if arr.shape[:2] != (self.size, self.size):
            image = _need_pil(f"resizing {self.images_list[index]} to {self.size}px as uint8")
            filt = {"bilinear": image.BILINEAR, "lanczos": image.LANCZOS}[self.resample]
            arr = np.asarray(image.fromarray(np.ascontiguousarray(arr)).resize(
                (self.size, self.size), filt), np.uint8)
        return np.ascontiguousarray(arr)

    def load(self, index: int, rng: np.random.Generator | None) -> np.ndarray:
        """The reference's train transform (flip, resize, normalize): float32
        [3, size, size] in [-1, 1]. Resized with Pillow where it is
        installed, as the JAX package does; else with the native transform,
        which has the bilinear filter only."""
        if _pil() is not None:
            arr = self.load_uint8(index, rng).astype(np.float32).transpose(2, 0, 1)
            return arr / 127.5 - 1.0
        raw = self.decode(index)
        if self.resample != "bilinear" and raw.shape[:2] != (self.size, self.size):
            _need_pil(f"a {self.resample} resize")
        flip = self.random_flip and rng.random() < 0.5
        return native_loader.transform_batch(raw[None], self.size, np.array([flip], np.uint8),
                                             num_threads=1)[0]


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


def build_uint8_cache(image_folder: str, size: int, cache_path: str | None = None, *,
                      num_workers: int = 8, info_print: bool = False) -> str:
    """Decode and resize every image of ``image_folder`` once into a uint8
    [N, size, size, 3] ``.npy`` (written to a ``.tmp`` file and renamed).
    The resize is bilinear: the cache stands for the train transform, so its
    reads are the decode-per-read path's pixels (the flip is applied at read
    time). A resize needs Pillow."""
    ds = FFHQDataset(image_folder, size, random_flip=False)
    cache_path = cache_path or cache_path_for(image_folder, size)
    tmp = cache_path + ".tmp"
    out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8,
                                    shape=(len(ds), size, size, 3))
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for i, img in enumerate(pool.map(lambda j: ds.load_uint8(j, None), range(len(ds)))):
            out[i] = img
            if info_print and (i + 1) % 1000 == 0:
                print(f"uint8 cache: {i + 1}/{len(ds)}")
    out.flush()
    del out
    os.replace(tmp, cache_path)
    return cache_path


def open_dataset(path: str, size: int, random_flip: bool = True, resample: str = "bilinear"):
    """A ``.npy`` cache given directly, a folder holding the cache for
    ``size``, or else the folder's images decoded per read (``resample``
    applies only there: a cache holds its resize). A cache must hold
    ``size``-pixel images."""
    if path.endswith(".npy") or os.path.exists(cache_path_for(path, size)):
        cache = path if path.endswith(".npy") else cache_path_for(path, size)
        dataset = Uint8CacheDataset(cache, random_flip=random_flip)
        if dataset.size != size:
            raise ValueError(f"{cache} holds {dataset.size}px images, training wants {size}px")
        return dataset
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no image folder or uint8 cache at {path}")
    return FFHQDataset(path, size, random_flip=random_flip, resample=resample)


class _Failed:
    """A producer's exception, handed to the consumer through the queue."""

    def __init__(self, error: BaseException):
        self.error = error


class DataLoader:
    """Endless batches from a producer thread: ``next`` takes one, ``close``
    stops the thread. See ``data_loader``."""

    def __init__(self, make_batch, n_items: int, batch_size: int, *, seed: int,
                 num_workers: int, prefetch: int, drop_last: bool):
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._make_batch = make_batch
        self._args = (n_items, batch_size, seed, num_workers, drop_last)
        self.thread = threading.Thread(target=self._produce, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        n_items, batch_size, seed, num_workers, drop_last = self._args
        rng = np.random.default_rng(seed)
        pool = ThreadPoolExecutor(max_workers=num_workers)
        try:
            while not self._stop.is_set():
                order = rng.permutation(n_items)
                n_full = len(order) // batch_size
                for b in range(n_full if drop_last else n_full + 1):
                    idxs = order[b * batch_size:(b + 1) * batch_size]
                    if len(idxs) == 0:
                        continue
                    if not self._put(self._make_batch(pool, rng, idxs)):
                        return
        except Exception as e:  # handed to the consumer, which raises it
            self._put(_Failed(e))
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if isinstance(item, _Failed):
            self.close()
            raise item.error
        return item

    def close(self):
        """Stop the producer and wait for it (at most 30 s: it may be
        decoding a batch)."""
        self._stop.set()
        while True:  # free a producer blocked on a full queue
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if self.thread is not threading.current_thread():
            self.thread.join(30.0)


def data_loader(dataset, batch_size: int, *, seed: int = 0, num_workers: int = 8,
                prefetch: int = 4, drop_last: bool = True, uint8_hwc: bool = False) -> DataLoader:
    """Endless [B, 3, H, W] float32 batches in [-1, 1] (default), or with
    ``uint8_hwc`` [B, H, W, 3] uint8 ones, normalized on the device (a 4x
    smaller copy). Each epoch is a fresh permutation of ``seed``'s
    generator; the last partial batch is dropped if ``drop_last``. A thread
    pool of ``num_workers`` decodes ahead, ``prefetch`` batches deep.

    The generator is drawn from as the JAX package's loader draws, so the
    same seed gives its batches: per batch, ``random(n)`` for the flips of a
    cache read and of the native float path (decode, then one
    ``transform_batch`` of the batch in ``num_workers`` threads), and
    ``integers(0, 2**31, n)`` seeds of per-image generators on the per-image
    paths (a folder read as uint8, and float batches of images of mixed
    sizes). Float batches need an image folder. The producer touches numpy
    only. Prints one line naming the dataset, its decoder and its resize."""
    if isinstance(dataset, FFHQDataset):
        per_image = "Pillow " + dataset.resample if _pil() else "native bilinear"
        where, decoder = f"folder {dataset.image_folder}", dataset.decoder
        resize = (f"Pillow {dataset.resample} (raises without Pillow)" if uint8_hwc else
                  f"native bilinear (images of mixed sizes: {per_image})")
    elif uint8_hwc:
        where, decoder, resize = f"cache {dataset.cache_path}", "none", "none"
    else:
        raise ValueError("float batches come from an image folder; read a uint8 cache with "
                         "uint8_hwc=True")
    route = "uint8 [B, H, W, 3]"
    if not uint8_hwc:
        native = native_loader.build()  # a failed build raises here, not in the thread
        route = f"float32 [B, 3, H, W] through the native transform ({native.name})"
    print(f"data_loader: {len(dataset)} images from {where}, {dataset.size}px, decoder "
          f"{decoder}, resize where not at {dataset.size}px: {resize}; {route} batches of "
          f"{batch_size}, {num_workers} workers", flush=True)

    def make_batch(pool, rng, idxs):
        if uint8_hwc:
            if hasattr(dataset, "load_batch_uint8"):
                return dataset.load_batch_uint8(idxs, rng)
            seeds = rng.integers(0, 2 ** 31, size=len(idxs))
            futs = [pool.submit(dataset.load_uint8, int(i), np.random.default_rng(int(s)))
                    for i, s in zip(idxs, seeds)]
            return np.stack([f.result() for f in futs])
        raws = [f.result() for f in [pool.submit(dataset.decode, int(i)) for i in idxs]]
        if len({r.shape for r in raws}) == 1:
            flips = (rng.random(len(raws)) < 0.5) if dataset.random_flip \
                else np.zeros(len(raws))
            return native_loader.transform_batch(np.stack(raws), dataset.size,
                                                 flips.astype(np.uint8), num_threads=num_workers)
        seeds = rng.integers(0, 2 ** 31, size=len(idxs))
        futs = [pool.submit(dataset.load, int(i), np.random.default_rng(int(s)))
                for i, s in zip(idxs, seeds)]
        return np.stack([f.result() for f in futs])

    return DataLoader(make_batch, len(dataset), batch_size, seed=seed, num_workers=num_workers,
                      prefetch=prefetch, drop_last=drop_last)


def infinite_loader(dataset, batch_size: int, **kw) -> DataLoader:
    """Endless batch stream (the reference's sample_data wrapper,
    train.py:136-139): ``data_loader``."""
    return data_loader(dataset, batch_size, **kw)
