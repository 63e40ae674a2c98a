"""PPL evaluation CLI (the JAX package's root get_ppl.py, flag-compatible
with the reference's get_ppl.py):

    python -m content_aware_gan_compression_torch.get_ppl --ckpt g.npz \
        --lpips_vgg_ckpt vgg16.pth --lpips_lins_ckpt vgg.pth

Scores the checkpoint's ``g_ema`` with LPIPS-VGG16 built from torchvision's
VGG16 weights and the reference's LPIPS heads (``lin{k}.model.1.weight``).
The distances are not divided by eps^2 unless ``--divide_eps_sq`` is given
(the reference's library path does not; its standalone ppl.py does). z, the
lerp positions and the noise come from one ``torch.Generator(device)``
seeded with ``--seed``. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--generated_img_size", type=int, default=256)
    parser.add_argument("--ckpt", type=str, default="./Model/full_size_model/256px_full_size.pt")
    parser.add_argument("--n_sample", type=int, default=5000)
    parser.add_argument("--batch_size", type=int, default=50)
    parser.add_argument("--eps", type=float, default=1e-4)
    parser.add_argument("--info_print", action="store_true", default=False)
    parser.add_argument("--latent", type=int, default=512)
    parser.add_argument("--n_mlp", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lpips_vgg_ckpt", type=str,
                        default="./Model/metrics/vgg16_torchvision.pth")
    parser.add_argument("--lpips_lins_ckpt", type=str, default="./lpips/weights/v0.1/vgg.pth")
    parser.add_argument("--divide_eps_sq", action="store_true", default=False,
                        help="divide by eps^2 (the reference's standalone ppl.py does; its "
                             "library path does not)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import torch

    from .evaluation import get_ppl_score
    from .models import load_lpips
    from .utils import load_generator, resolve_device

    device = resolve_device(args.device)
    g = load_generator(args.ckpt, args.generated_img_size, args.latent, args.n_mlp,
                       device=device)
    lpips = load_lpips(args.lpips_vgg_ckpt if os.path.exists(args.lpips_vgg_ckpt) else None,
                       args.lpips_lins_ckpt, device=device).requires_grad_(False).eval()

    print(f"Number of samples: {args.n_sample}")
    start_time = time.time()
    ppl = get_ppl_score(g, lpips, n_sample=args.n_sample, batch_size=args.batch_size,
                        eps=args.eps, generator=torch.Generator(device).manual_seed(args.seed),
                        divide_eps_sq=args.divide_eps_sq, info_print=args.info_print)
    print(f"Total time is: {round(time.time() - start_time, 4)}")
    print(f"PPL Scores: {ppl}\n")
    return ppl


if __name__ == "__main__":
    main()
