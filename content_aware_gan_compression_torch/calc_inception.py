"""Real-image Inception statistics (the JAX package's root calc_inception.py,
flag-compatible with the reference's Evaluation/calc_inception.py):

    python -m content_aware_gan_compression_torch.calc_inception data.npy \
        --inception_ckpt pt_inception-2015-12-05-6726825d.pth

Reads a uint8 cache (``.npy``, or a folder holding ``uint8_cache_<size>.npy``)
or an image folder (Lanczos resize to ``--size``, which needs Pillow; PNGs
already at ``--size`` are read without it), and
writes the reference's pickle ``{'mean', 'cov', 'size', 'path'}`` to
``--output`` or ``inception_<name>.pkl``. Every batch has ``--batch`` images:
the tail batch is tiled from its own rows (``np.resize``) and the surplus
features are dropped. Images enter Inception as [-1, 1], raw. Runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle


def open_images(path: str, size: int, flip: bool):
    """The cache at ``path`` if there is one, else its image folder, resized
    with Lanczos (the JAX CLI's ``open_dataset(..., resample="lanczos")``)."""
    from .data import FFHQDataset, Uint8CacheDataset, cache_path_for

    if path.endswith(".npy"):
        return Uint8CacheDataset(path, random_flip=flip)
    if os.path.exists(cache_path_for(path, size)):
        return Uint8CacheDataset(cache_path_for(path, size), random_flip=flip)
    return FFHQDataset(path, size, random_flip=flip, resample="lanczos")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--batch", default=64, type=int, help="batch size")
    parser.add_argument("--n_sample", type=int, default=50000)
    parser.add_argument("--flip", action="store_true")
    parser.add_argument("path", metavar="PATH",
                        help="uint8 cache (.npy), a folder holding one, or an image folder")
    parser.add_argument("--inception_ckpt", type=str,
                        default="./Model/metrics/pt_inception-2015-12-05-6726825d.pth")
    parser.add_argument("--output", type=str, default=None,
                        help="output pickle (default: inception_{name}.pkl here)")
    parser.add_argument("--seed", type=int, default=0, help="seed of the --flip coin tosses")
    parser.add_argument("--info_print", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from .evaluation.fid import uint8_features
    from .models import load_fid_inception
    from .utils import resolve_device

    device = resolve_device(args.device)
    if not os.path.exists(args.inception_ckpt):
        raise FileNotFoundError(
            f"FID inception weights not found at {args.inception_ckpt}; "
            "provide --inception_ckpt (pt_inception-2015-12-05 checkpoint)")
    inception = load_fid_inception(args.inception_ckpt, device=device)

    ds = open_images(args.path, args.size, args.flip)
    if ds.size != args.size:
        raise SystemExit(
            f"--size {args.size} does not match the prepared cache's baked resolution "
            f"{ds.size} ({args.path}); the pickle would claim a resolution the features were "
            f"not computed at. Pass --size {ds.size} or point PATH at the source image folder.")
    n = min(args.n_sample, len(ds))
    n_batch = max(1, -(-n // args.batch))
    rng = np.random.default_rng(args.seed)

    feats = []
    with torch.inference_mode():
        for b in range(n_batch):
            idxs = list(range(b * args.batch, min((b + 1) * args.batch, n)))
            if hasattr(ds, "load_batch_uint8"):
                batch = ds.load_batch_uint8(idxs, rng)
            else:
                batch = np.stack([ds.load_uint8(i, rng) for i in idxs])
            if len(idxs) < args.batch:  # tile the tail's own rows; dropped below
                batch = np.resize(batch, (args.batch,) + batch.shape[1:])
            feats.append(uint8_features(inception, torch.from_numpy(batch).to(device)))
            if args.info_print and (b + 1) % 50 == 0:
                print(f"inception features: batch {b + 1}/{n_batch}")
    features = torch.cat(feats).cpu().numpy()[:n].astype(np.float64)
    print(f"extracted {features.shape[0]} features")

    name = os.path.splitext(os.path.basename(os.path.normpath(args.path)))[0]
    out = args.output or f"inception_{name}.pkl"
    with open(out, "wb") as f:
        pickle.dump({"mean": np.mean(features, 0), "cov": np.cov(features, rowvar=False),
                     "size": args.size, "path": args.path}, f)
    print(f"saved statistics to {out}")
    return out


if __name__ == "__main__":
    main()
