"""Multi-resolution dataset builder (the JAX package's root prepare_data.py,
itself the reference's Miscellaneous/prepare_data.py):

    python -m content_aware_gan_compression_torch.prepare_data --out data \
        --size 256 --format uint8 images/

``--format folders`` (the default) writes ``<out>/<size>/<idx:05d>.jpg`` for
each size: every image resized with Lanczos and saved as JPEG at quality 100,
as the reference does. ``--format uint8`` writes ``<out>/uint8_cache_<size>.npy``
for each size through ``build_uint8_cache`` (a bilinear resize: the train
transform's, so the cache reads as the decode-per-read folder would), the
training loader's fast path. ``--format lmdb`` writes the reference's store
('<size>-<idx:05d>' -> JPEG bytes, 'length' -> count) where ``lmdb`` imports.
The JPEG formats need Pillow; ``uint8`` needs it only to resize (PNGs
already at the size are read without it).
"""

from __future__ import annotations

import argparse
import io
import os
from concurrent.futures import ThreadPoolExecutor
from functools import partial

from .data.dataset import IMAGE_EXTENSIONS, build_uint8_cache


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("--format folders and lmdb write JPEG files, which needs Pillow, "
                          "which is not installed; --format uint8 does not") from e
    return Image


def resize_and_encode(path, sizes, quality=100):
    """``path`` resized with Lanczos to each size, as JPEG bytes."""
    image = _pillow()
    with image.open(path) as src:
        img = src.convert("RGB")
    out = []
    for size in sizes:
        buf = io.BytesIO()
        img.resize((size, size), image.LANCZOS).save(buf, format="jpeg", quality=quality)
        out.append(buf.getvalue())
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--size", type=str, default="128,256,512,1024")
    parser.add_argument("--n_worker", type=int, default=8)
    parser.add_argument("--format", type=str, default="folders",
                        choices=["folders", "lmdb", "uint8"],
                        help="'uint8' writes one decoded [N,S,S,3] .npy memmap per size, the "
                             "training loader's zero-decode path (data/dataset.py:"
                             "Uint8CacheDataset)")
    parser.add_argument("path", metavar="PATH")
    args = parser.parse_args(argv)

    sizes = [int(s.strip()) for s in args.size.split(",")]
    files = sorted(os.path.join(args.path, f) for f in os.listdir(args.path)
                   if f.lower().endswith(IMAGE_EXTENSIONS))
    print(f"{len(files)} images -> sizes {sizes}")

    if args.format == "uint8":
        os.makedirs(args.out, exist_ok=True)
        for size in sizes:
            out = os.path.join(args.out, f"uint8_cache_{size}.npy")
            build_uint8_cache(args.path, size, out, num_workers=args.n_worker, info_print=True)
            print(f"{out}: {len(files)} images @ {size}px")
        print("done")
        return

    _pillow()
    worker = partial(resize_and_encode, sizes=sizes)
    if args.format == "lmdb":
        import lmdb  # not a dependency: only this format needs it

        with lmdb.open(args.out, map_size=1024 ** 4, readahead=False) as env:
            with ThreadPoolExecutor(args.n_worker) as pool:
                for i, encoded in enumerate(pool.map(worker, files)):
                    with env.begin(write=True) as txn:
                        for size, data in zip(sizes, encoded):
                            txn.put(f"{size}-{str(i).zfill(5)}".encode(), data)
                    if i % 500 == 0:
                        print(f"{i}/{len(files)}")
            with env.begin(write=True) as txn:
                txn.put(b"length", str(len(files)).encode())
    else:
        for size in sizes:
            os.makedirs(os.path.join(args.out, str(size)), exist_ok=True)
        with ThreadPoolExecutor(args.n_worker) as pool:
            for i, encoded in enumerate(pool.map(worker, files)):
                for size, data in zip(sizes, encoded):
                    with open(os.path.join(args.out, str(size), f"{str(i).zfill(5)}.jpg"),
                              "wb") as f:
                        f.write(data)
                if i % 500 == 0:
                    print(f"{i}/{len(files)}")
    print("done")


if __name__ == "__main__":
    main()
