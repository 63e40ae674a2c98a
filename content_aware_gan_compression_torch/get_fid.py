"""FID evaluation CLI (the JAX package's root get_fid.py, flag-compatible with
the reference's get_fid.py):

    python -m content_aware_gan_compression_torch.get_fid --ckpt g.npz \
        --real_stats inception_ffhq.pkl

Scores the checkpoint's ``g_ema`` (``.npz`` from either package, or a
reference ``.pt``) against real statistics: a pickle (``--real_stats``, the
reference's ``{'mean', 'cov'}`` format, e.g. from ``calc_inception``) or an
image folder (``--real_images``, needs Pillow). z and noise come from one
``torch.Generator(device)`` seeded with ``--seed``. Runs on ``cuda`` unless
``--device cpu`` is given.

Under torchrun (``torchrun --nproc_per_node=N -m
content_aware_gan_compression_torch.get_fid ...``) each process takes
``cuda:LOCAL_RANK``, every rank draws the same sample stream and runs its
rows of each batch, the features are gathered, and rank 0 prints (the JAX
CLI's mesh over all local devices). ``--batch_size`` is the global batch.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--generated_img_size", type=int, default=256)
    parser.add_argument("--ckpt", type=str, default="./Model/full_size_model/256px_full_size.pt")
    parser.add_argument("--n_sample", type=int, default=50000)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--info_print", action="store_true", default=False)
    parser.add_argument("--latent", type=int, default=512)
    parser.add_argument("--n_mlp", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--inception_ckpt", type=str,
                        default="./Model/metrics/pt_inception-2015-12-05-6726825d.pth")
    parser.add_argument("--real_stats", type=str, default=None,
                        help="{'mean','cov'} pickle (the reference's inception_ffhq_embed format)")
    parser.add_argument("--real_images", type=str, default=None,
                        help="folder of real images to build the statistics from")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from . import parallel

    with parallel.process_group(args.device) as device:
        return _score(args, device)


def _score(args, device):
    """The FID of ``args.ckpt`` on ``device``; rank 0 prints."""
    import torch

    from . import parallel
    from .evaluation import compute_real_stats_from_folder, get_model_fid_score
    from .models import load_fid_inception
    from .utils import load_generator

    g = load_generator(args.ckpt, args.generated_img_size, args.latent, args.n_mlp,
                       device=device)
    if not os.path.exists(args.inception_ckpt):
        raise FileNotFoundError(
            f"FID inception weights not found at {args.inception_ckpt}; "
            "provide --inception_ckpt (pt_inception-2015-12-05 checkpoint)")
    inception = load_fid_inception(args.inception_ckpt, device=device)

    if args.real_stats:
        real_stats = args.real_stats
    elif args.real_images:
        real_stats = compute_real_stats_from_folder(
            args.real_images, inception, size=args.generated_img_size,
            batch_size=args.batch_size, info_print=args.info_print and parallel.is_main())
    else:
        raise ValueError("need --real_stats or --real_images")

    parallel.main_print(f"Number of samples: {args.n_sample}")
    start_time = time.time()
    fid = get_model_fid_score(g, inception, real_stats, batch_size=args.batch_size,
                              num_sample=args.n_sample,
                              generator=torch.Generator(device).manual_seed(args.seed),
                              info_print=args.info_print and parallel.is_main())
    parallel.main_print(f"Total time is: {round(time.time() - start_time, 4)}")
    parallel.main_print(f"FID Scores: {fid}\n")
    return fid


if __name__ == "__main__":
    main()
