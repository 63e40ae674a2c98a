"""The port's prepare_data CLI against the JAX package's root script (its
``main`` in this process), on 6 seeded PNGs at sizes "16,32": the uint8
caches and the JPEG folders are byte-equal."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from content_aware_gan_compression_torch import prepare_data
from torch_train_util import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_script():
    """The JAX package's root prepare_data.py as a module (its name clashes
    with the port's)."""
    spec = importlib.util.spec_from_file_location(
        "jax_root_prepare_data", os.path.join(REPO, "prepare_data.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    image = pytest.importorskip("PIL.Image")
    folder = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(0)
    for i, side in enumerate([40, 24, 40, 36, 24, 40]):
        image.fromarray(rng.randint(0, 256, (side, side, 3), dtype=np.uint8)).save(
            folder / f"img{i}.png")
    return str(folder)


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = f.read()
    return out


@pytest.mark.parametrize("fmt", ["uint8", "folders"])
def test_outputs_equal_the_root_scripts(images, tmp_path, fmt, monkeypatch):
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    args = ["--size", "16,32", "--n_worker", "2", "--format", fmt]
    prepare_data.main(["--out", mine, *args, images])
    monkeypatch.setattr(sys, "argv", ["prepare_data.py", "--out", theirs, *args, images])
    _root_script().main()
    got, want = _files(mine), _files(theirs)
    expected = ({"uint8_cache_16.npy", "uint8_cache_32.npy"} if fmt == "uint8" else
                {f"{s}/{i:05d}.jpg" for s in (16, 32) for i in range(6)})
    assert set(got) == set(want) == expected
    for name in want:
        assert got[name] == want[name], name


def test_jpeg_formats_name_pillow_without_it(images, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        prepare_data.main(["--out", str(tmp_path / "out"), "--size", "16", images])
