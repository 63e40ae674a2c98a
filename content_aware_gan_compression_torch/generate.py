"""Sample-grid generation CLI (reference Miscellaneous/generate.py).

Writes ``pics`` grids of ``sample`` truncated samples each from a
checkpoint's ``g_ema`` (``.npz`` from either package, or a reference ``.pt``):

    python -m content_aware_gan_compression_torch.generate --ckpt g.npz

Runs on ``cuda`` unless ``--device cpu`` is given. z, the mean latent's z and
the noise come from one ``torch.Generator(device)`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import os

import torch


def sample_images(g, n: int, truncation: float, mean_latent, generator):
    """``n`` images [n, 3, H, W] from fresh z and noise drawn from ``generator``."""
    z = torch.randn(n, g.config.style_dim, generator=generator, device=g.device)
    return g([z], truncation=truncation, truncation_latent=mean_latent, generator=generator)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--sample", type=int, default=16, help="samples per grid")
    parser.add_argument("--pics", type=int, default=1, help="number of grids")
    parser.add_argument("--truncation", type=float, default=0.5)
    parser.add_argument("--truncation_mean", type=int, default=4096)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--latent", type=int, default=512)
    parser.add_argument("--n_mlp", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", type=str, default="sample")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from .utils import load_generator, resolve_device, save_image_grid

    device = resolve_device(args.device)
    g = load_generator(args.ckpt, args.size, args.latent, args.n_mlp, device=device)
    generator = torch.Generator(device).manual_seed(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    with torch.inference_mode():
        mean_latent = None
        if args.truncation < 1:
            mean_latent = g.mean_latent(args.truncation_mean, generator)
        for i in range(args.pics):
            images = sample_images(g, args.sample, args.truncation, mean_latent, generator)
            path = os.path.join(args.out_dir, f"{str(i).zfill(6)}.png")
            save_image_grid(images.cpu(), path, nrow=int(args.sample ** 0.5))
            print(f"saved {path}")


if __name__ == "__main__":
    main()
