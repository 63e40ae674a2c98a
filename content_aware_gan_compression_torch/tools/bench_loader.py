"""The training data's images/s through each loader path (the port's
counterpart of the JAX round's ``tools/bench_loader.py``; host only):

    python -m content_aware_gan_compression_torch.tools.bench_loader

Can the host feed what the steps take (iterations/s x batch of decoded,
resized images)? Writes a synthetic folder of ``--n_images`` PNGs at
``--src_size`` (``fixtures.write_noise_pngs``: seeded noise blurred by a
Gaussian of sigma 4, standing in for the JAX tool's JPEGs through
``GaussianBlur(4)``; PNG because the card's machine may have no Pillow and
``write_png`` needs none), or reads ``--folder``, then measures images/s
through each path of the port's ``data/`` module:

  pil_uint8     FFHQDataset decode -> flip -> resize per read, uint8
                (the train CLI's folder path), in the loader's thread pool
  native_float  FFHQDataset decode + the native C++ batch transform
                (``data/native_loader.py``), float32 [B, 3, H, W]
  pil_float     the same with the native transform not used
                (``data_loader(native_transform=False)``: Pillow's resize
                image by image; the switch holds for that loader only)
  uint8_cache   ``build_uint8_cache`` (into a temporary folder, not the
                image folder) + ``Uint8CacheDataset`` memmap reads

Each path takes 3 warm-up batches and then ``--n_batches`` batches of
``--batch_size`` in ``--num_workers`` threads (the JAX tool's ``measure``).
Prints one JSON line per path: ``path``, ``img_per_sec``, ``src_size``,
``train_size``, ``batch_size``, ``format`` ("png", or "folder" for
``--folder``) and ``decoder`` (``FFHQDataset.decoder``: Pillow, or
``read_png`` without it); ``uint8_cache`` adds its build's seconds. A path
that cannot run on this machine prints ``{"path": ..., "unavailable":
"<why>"}`` instead: without Pillow a uint8 image that needs a resize cannot
be read (``pil_uint8`` and ``uint8_cache`` when ``--src_size`` differs from
``--size``), and ``pil_float`` is Pillow's resize; without Pillow only PNG
files decode. No path's rate is ever printed under another's name, and a
path that fails for any other reason makes the tool exit non-zero after the
other paths. The loader's own first line goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

PATHS = ("pil_uint8", "native_float", "pil_float", "uint8_cache")


def measure(loader, batch_size: int, n_batches: int, warmup: int = 3) -> float:
    """images/s of ``n_batches`` batches after ``warmup``; closes the
    loader."""
    try:
        for _ in range(warmup):
            next(loader)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(loader)
        dt = time.perf_counter() - t0
    finally:
        loader.close()
    return batch_size * n_batches / dt


def unavailable(path, pillow, needs_resize):
    """Why ``path`` cannot run without Pillow, or None."""
    if pillow:
        return None
    if path == "pil_float":
        return ("no Pillow: pil_float resizes with Pillow image by image (without it the "
                "float path is native_float's)")
    if path in ("pil_uint8", "uint8_cache") and needs_resize:
        return ("no Pillow: a uint8 image that needs a resize cannot be read "
                "(data/dataset.py: FFHQDataset.load_uint8)")
    return None


def run_path(path, folder, args, tmp):
    """One path's line."""
    from ..data import FFHQDataset, Uint8CacheDataset, build_uint8_cache, data_loader

    ds = FFHQDataset(folder, args.size)
    extra = {}
    with contextlib.redirect_stdout(sys.stderr):  # the loader's first line
        if path == "uint8_cache":
            t0 = time.perf_counter()
            cache = build_uint8_cache(folder, args.size, os.path.join(tmp, "cache.npy"),
                                      num_workers=args.num_workers)
            extra["cache_build_s"] = time.perf_counter() - t0
            loader = data_loader(Uint8CacheDataset(cache), args.batch_size,
                                 num_workers=args.num_workers, uint8_hwc=True)
        else:
            loader = data_loader(ds, args.batch_size, num_workers=args.num_workers,
                                 uint8_hwc=path == "pil_uint8",
                                 native_transform=path != "pil_float")
    rate = measure(loader, args.batch_size, args.n_batches)
    return {"path": path, "img_per_sec": round(rate, 1), "src_size": args.src_size,
            "train_size": args.size, "batch_size": args.batch_size,
            "format": "folder" if args.folder else "png", "decoder": ds.decoder, **extra}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--folder", default=None,
                    help="an existing image folder (default: write a synthetic one)")
    ap.add_argument("--n_images", type=int, default=256)
    ap.add_argument("--src_size", type=int, default=1024,
                    help="the synthetic images' side (raw FFHQ is 1024)")
    ap.add_argument("--size", type=int, default=256, help="the training resolution")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--n_batches", type=int, default=12)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--paths", default=",".join(PATHS))
    return ap.parse_args(argv)


def main(argv=None):
    """Prints one line per path; returns {path: line}. Exits non-zero when a
    path asked for failed for another reason than a missing Pillow."""
    args = parse_args(argv)
    from ..data import FFHQDataset, dataset
    from .fixtures import write_noise_pngs

    paths = args.paths.split(",")
    bad = [p for p in paths if p not in PATHS]
    if bad:
        raise SystemExit(f"unknown paths {bad}; choose from {PATHS}")
    pillow = dataset._pil() is not None
    tmp = tempfile.mkdtemp(prefix="cagc_bench_loader_")
    try:
        folder = args.folder
        if folder is None:
            folder = os.path.join(tmp, "imgs")
            t0 = time.perf_counter()
            write_noise_pngs(folder, args.src_size, args.n_images, seed=0,
                             workers=args.num_workers)
            print(f"# wrote {args.n_images} PNGs at {args.src_size}px in "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        else:
            args.src_size = FFHQDataset(folder, args.size).image_size(0)[0]
        results, failed = {}, []
        for path in paths:
            why = unavailable(path, pillow, args.src_size != args.size)
            if why is None:
                try:
                    line = run_path(path, folder, args, tmp)
                except Exception as e:  # noqa: BLE001 - reported, then a non-zero exit
                    if not isinstance(e, ImportError) or pillow:
                        failed.append(path)
                        print(f"# {path} failed: {type(e).__name__}: {e}", file=sys.stderr)
                        continue
                    # the data module names Pillow where it needs it
                    line = {"path": path, "unavailable": f"no Pillow: {e}"}
            else:
                line = {"path": path, "unavailable": why}
            results[path] = line
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise SystemExit(f"bench_loader: {failed} failed")
    return results


if __name__ == "__main__":
    main()
