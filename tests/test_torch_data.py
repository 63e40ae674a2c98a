"""The port's training data against the JAX package's, on the CPU: the
folder dataset's decode and reads (bilinear and Lanczos), the uint8 cache's
bytes, ``open_dataset``'s choice, the loader's batches for one seed on each
path, ``close``, the PNG reader against Pillow on each row filter, the paths
without Pillow, a failed native build, ``prepare_real``'s layouts, the
Trainer from a folder without a cache, and the sparsity trainer's folder
path. Every comparison with the JAX package is exact.
"""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from content_aware_gan_compression_tpu.data import FFHQDataset as JaxFFHQDataset
from content_aware_gan_compression_tpu.data import Uint8CacheDataset as JaxUint8CacheDataset
from content_aware_gan_compression_tpu.data import build_uint8_cache as jax_build_uint8_cache
from content_aware_gan_compression_tpu.data import data_loader as jax_data_loader
from content_aware_gan_compression_tpu.data import open_dataset as jax_open_dataset
from content_aware_gan_compression_torch.data import (
    FFHQDataset, Uint8CacheDataset, build_uint8_cache, data_loader, native_loader, open_dataset)
from content_aware_gan_compression_torch.train import TrainConfig, Trainer, prepare_real
from content_aware_gan_compression_torch.train.sparsity import SparsityTrainer
from content_aware_gan_compression_torch.utils.logging import read_png, write_png
from torch_train_util import torch_threads  # noqa: F401

Image = pytest.importorskip("PIL.Image")

WORKERS = 2  # the loaders' pool and the native transform's threads
N_IMAGES = 10  # with batches of 4: two batches an epoch, so 3 cross an epoch's end


def _images(folder, sizes, seed=0):
    """PNGs of the given sides at ``folder``, seeded; returns the folder."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i, side in enumerate(sizes):
        Image.fromarray(rng.randint(0, 256, (side, side, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"{i:03d}.png"))
    return str(folder)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """A folder of 24px images, one of mixed sides and kinds (grey, RGBA,
    JPEG, 16px), and one of 16px images with a cache beside them."""
    root = tmp_path_factory.mktemp("data")
    mixed = _images(root / "mixed", [24, 16, 20, 24], seed=1)
    rng = np.random.RandomState(2)
    Image.fromarray(rng.randint(0, 256, (24, 24), dtype=np.uint8)).save(f"{mixed}/grey.png")
    Image.fromarray(rng.randint(0, 256, (18, 18, 4), dtype=np.uint8)).save(f"{mixed}/rgba.png")
    Image.fromarray(rng.randint(0, 256, (24, 24, 3), dtype=np.uint8)).save(
        f"{mixed}/photo.jpg", quality=90)
    cached = _images(root / "cached", [16] * N_IMAGES, seed=3)
    jax_build_uint8_cache(cached, 16, num_workers=WORKERS)
    return {"uniform": _images(root / "uniform", [24] * N_IMAGES), "mixed": mixed,
            "cached": cached}


@pytest.mark.parametrize("resample", ["bilinear", "lanczos"])
def test_dataset_reads_equal_jax(folders, resample):
    mine = FFHQDataset(folders["mixed"], 16, resample=resample)
    theirs = JaxFFHQDataset(folders["mixed"], 16, resample=resample)
    assert mine.images_list == theirs.images_list
    for i in range(len(mine)):
        np.testing.assert_array_equal(mine.decode(i), theirs.decode(i))
        for read in ("load_uint8", "load"):
            got = getattr(mine, read)(i, np.random.default_rng(i))
            want = getattr(theirs, read)(i, np.random.default_rng(i))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{read} {i}")


def test_uint8_cache_is_byte_equal_to_jax(folders, tmp_path):
    mine = build_uint8_cache(folders["mixed"], 16, str(tmp_path / "mine.npy"),
                             num_workers=WORKERS)
    theirs = jax_build_uint8_cache(folders["mixed"], 16, str(tmp_path / "theirs.npy"),
                                   num_workers=WORKERS)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(mine + ".tmp")


def test_open_dataset_resolves_as_jax(folders):
    cache = os.path.join(folders["cached"], "uint8_cache_16.npy")
    for path, kind, jax_kind in (
            (cache, Uint8CacheDataset, JaxUint8CacheDataset),
            (folders["cached"], Uint8CacheDataset, JaxUint8CacheDataset),
            (folders["uniform"], FFHQDataset, JaxFFHQDataset)):
        mine, theirs = open_dataset(path, 16), jax_open_dataset(path, 16)
        assert isinstance(mine, kind) and isinstance(theirs, jax_kind), path
        assert len(mine) == len(theirs) and mine.size == theirs.size == 16
    assert open_dataset(folders["uniform"], 16, resample="lanczos").resample == "lanczos"
    with pytest.raises(FileNotFoundError, match="no image folder or uint8 cache"):
        open_dataset(folders["uniform"] + "_missing", 16)
    with pytest.raises(ValueError, match="image folder"):
        data_loader(open_dataset(cache, 16), 4)


@pytest.mark.parametrize("path", ["float_native", "float_mixed_sizes", "uint8_cache",
                                  "uint8_folder"])
def test_loader_batches_equal_jax(folders, path):
    """The first 3 batches for one seed, across an epoch's end."""
    folder, uint8 = {"float_native": (folders["uniform"], False),
                     "float_mixed_sizes": (folders["mixed"], False),
                     "uint8_cache": (folders["cached"], True),
                     "uint8_folder": (folders["uniform"], True)}[path]
    mine = data_loader(open_dataset(folder, 16), 4, seed=5, num_workers=WORKERS,
                       uint8_hwc=uint8)
    theirs = jax_data_loader(jax_open_dataset(folder, 16), 4, seed=5, num_workers=WORKERS,
                             uint8_hwc=uint8)
    try:
        for b in range(3):
            got, want = next(mine), next(theirs)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{path} batch {b}")
    finally:
        mine.close()
        theirs.close()
    assert got.shape == ((4, 16, 16, 3) if uint8 else (4, 3, 16, 16))


def test_close_stops_the_producer(folders):
    loader = data_loader(open_dataset(folders["uniform"], 16), 2, num_workers=WORKERS,
                         prefetch=1, uint8_hwc=True)
    next(loader)
    assert loader.thread.is_alive()
    loader.close()
    assert not loader.thread.is_alive()


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_read_png_equals_pillow_on_each_filter(tmp_path, filter_type):
    rng = np.random.RandomState(filter_type)
    for channels in (1, 3, 4):
        arr = rng.randint(0, 256, (13, 11, channels), dtype=np.uint8)
        path = str(tmp_path / f"f{filter_type}_{channels}.png")
        write_png(path, arr, filter_type=filter_type)
        with open(path, "rb") as f:  # IDAT follows the signature and IHDR
            data = f.read()
        (length,) = struct.unpack(">I", data[33:37])
        assert data[37:41] == b"IDAT"
        rows = np.frombuffer(zlib.decompress(data[41:41 + length]), np.uint8)
        assert set(rows.reshape(13, -1)[:, 0]) == {filter_type}
        with Image.open(path) as img:
            pil = np.asarray(img)
        np.testing.assert_array_equal(read_png(path), pil.reshape(arr.shape))
        np.testing.assert_array_equal(read_png(path), arr)
    with pytest.raises(ValueError, match="filter type"):
        write_png(str(tmp_path / "bad.png"), arr, filter_type=5)


def test_without_pillow(folders, monkeypatch):
    """PNGs decode through read_png to Pillow's pixels, float batches come
    through the native transform as they do with Pillow, and a uint8 read
    that needs a resize raises, naming Pillow."""
    with_pil = FFHQDataset(folders["uniform"], 16)
    decoded = [with_pil.decode(i) for i in range(len(with_pil))]
    loader = data_loader(with_pil, 4, seed=5, num_workers=WORKERS)
    want = [next(loader) for _ in range(3)]
    loader.close()
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a machine without Pillow
    ds = FFHQDataset(folders["uniform"], 16)
    assert "read_png" in ds.decoder
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.decode(i), decoded[i])
    loader = data_loader(ds, 4, seed=5, num_workers=WORKERS)
    try:
        for b in range(3):
            np.testing.assert_array_equal(next(loader), want[b])
    finally:
        loader.close()
    with pytest.raises(ImportError, match="Pillow"):
        ds.load_uint8(0, np.random.default_rng(0))
    loader = data_loader(ds, 4, num_workers=WORKERS, uint8_hwc=True)
    with pytest.raises(ImportError, match="Pillow"):
        next(loader)
    assert not loader.thread.is_alive()
    mixed = FFHQDataset(folders["mixed"], 16)
    with pytest.raises(ImportError, match="Pillow"):
        mixed.decode(mixed.images_list.index(os.path.join(folders["mixed"], "photo.jpg")))


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "transform.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_loader.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_prepare_real_takes_each_layout():
    rng = np.random.RandomState(0)
    nhwc = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    nchw = np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2))
    u8 = rng.randint(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    for batch, want in ((nhwc, nhwc), (nchw, nhwc), (torch.from_numpy(nchw), nhwc),
                        (u8, u8.astype(np.float32) / 127.5 - 1.0)):
        got = prepare_real(batch, "cpu")
        assert got.dtype == torch.float32 and got.shape == (2, 8, 8, 3) and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


def _tiny_config(data_folder, **kw):
    return TrainConfig(data_folder=data_folder, generated_img_size=16, latent=16, n_mlp=1,
                       batch_size=4, channel_multiplier=1, seed=3, val_sample_num=4,
                       val_sample_freq=1000, model_save_freq=1000, **kw)


def test_trainer_runs_from_a_folder_without_a_cache(tmp_path):
    folder = _images(tmp_path / "pngs", [24] * 8, seed=4)
    trainer = Trainer(_tiny_config(folder, d_reg_freq=2, g_reg_freq=2), device="cpu",
                      exp_root=str(tmp_path))
    logger = trainer.run(max_iters=2)
    logger.close()
    with open(os.path.join(logger.exp_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["iter"] for r in recs] == [0, 1]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert {"d", "g", "r1", "path"} <= set(recs[0])
    assert not os.path.exists(os.path.join(folder, "uint8_cache_16.npy"))


def test_sparsity_trainer_reads_a_folder_as_jax(folders):
    """A folder, even one holding a cache, gives JAX run_sparsity's float
    NCHW batches; a .npy cache gives the Trainer's uint8 ones."""
    trainer = SparsityTrainer(_tiny_config(folders["cached"]), device="cpu")
    mine = trainer.open_loader(trainer.cfg.seed)
    theirs = jax_data_loader(JaxFFHQDataset(folders["cached"], 16), 4, seed=trainer.cfg.seed)
    try:
        for b in range(3):
            got, want = next(mine), next(theirs)
            assert got.dtype == np.float32 and got.shape == (4, 3, 16, 16)
            np.testing.assert_array_equal(got, want, err_msg=f"batch {b}")
    finally:
        mine.close()
        theirs.close()
    trainer.cfg = _tiny_config(os.path.join(folders["cached"], "uint8_cache_16.npy"))
    cached = trainer.open_loader(0)
    try:
        assert next(cached).dtype == np.uint8
    finally:
        cached.close()
