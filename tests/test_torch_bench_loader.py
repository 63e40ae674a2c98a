"""The port's loader bench (``tools/bench_loader.py``) on the CPU at
``--src_size 32 --size 16 --n_images 8``: every path prints its line, with
the JAX tool's keys, the PNG format and the decoder; with Pillow hidden
(the port's ``data.dataset._pil``) the paths that need it print
``unavailable`` with the reason and the native path decodes with
``read_png``; ``pil_float`` does not take the native transform, and the
native path after it does."""

import json

import pytest

from content_aware_gan_compression_torch import data
from content_aware_gan_compression_torch.data import dataset, native_loader
from content_aware_gan_compression_torch.tools import bench_loader
from torch_train_util import torch_threads  # noqa: F401

ARGV = ["--src_size", "32", "--size", "16", "--n_images", "8", "--batch_size", "4",
        "--n_batches", "2", "--num_workers", "2"]
KEYS = {"path", "img_per_sec", "src_size", "train_size", "batch_size", "format", "decoder"}


@pytest.fixture
def transforms(monkeypatch):
    """Counts the native transform's calls."""
    calls = []
    real = native_loader.transform_batch

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(native_loader, "transform_batch", counted)
    return calls


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_every_path_prints_its_line(capsys, transforms):
    results = bench_loader.main(ARGV)
    lines = _lines(capsys)
    assert [line["path"] for line in lines] == list(bench_loader.PATHS)
    assert {line["path"]: line for line in lines} == results
    for line in lines:
        assert KEYS <= set(line) and line["img_per_sec"] > 0
        assert (line["src_size"], line["train_size"], line["batch_size"]) == (32, 16, 4)
        assert line["format"] == "png" and line["decoder"] == "Pillow"
    assert results["uint8_cache"]["cache_build_s"] > 0


def test_pil_float_skips_the_native_transform_and_native_float_takes_it(capsys, transforms):
    bench_loader.main(ARGV + ["--paths", "pil_float"])
    assert transforms == [] and _lines(capsys)[0]["img_per_sec"] > 0
    bench_loader.main(ARGV + ["--paths", "pil_float,native_float"])
    assert transforms and all(shape[0] == 4 for shape in transforms)
    assert [line["path"] for line in _lines(capsys)] == ["pil_float", "native_float"]


def test_without_pillow(capsys, monkeypatch, transforms):
    monkeypatch.setattr(dataset, "_pil", lambda: None)
    results = bench_loader.main(ARGV)
    lines = {line["path"]: line for line in _lines(capsys)}
    assert lines == results and list(lines) == list(bench_loader.PATHS)
    for path in ("pil_uint8", "uint8_cache"):
        assert set(lines[path]) == {"path", "unavailable"}
        assert "needs a resize" in lines[path]["unavailable"]
    assert set(lines["pil_float"]) == {"path", "unavailable"}
    assert "Pillow" in lines["pil_float"]["unavailable"]
    native = lines["native_float"]
    assert native["img_per_sec"] > 0 and native["decoder"].startswith("read_png") and transforms
    # at the training size a uint8 read needs no resize, so it runs without Pillow
    results = bench_loader.main(["--src_size", "16"] + ARGV[2:] + ["--paths", "pil_uint8"])
    assert results["pil_uint8"]["img_per_sec"] > 0
    assert results["pil_uint8"]["decoder"].startswith("read_png")


def test_a_failed_path_exits_non_zero_after_the_others(capsys, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("a broken cache")

    monkeypatch.setattr(data, "build_uint8_cache", broken)
    with pytest.raises(SystemExit, match="uint8_cache"):
        bench_loader.main(ARGV + ["--paths", "uint8_cache,native_float"])
    assert [line["path"] for line in _lines(capsys)] == ["native_float"]
