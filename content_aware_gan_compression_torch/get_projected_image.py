"""Image projection CLI, with the flags of the JAX package's (and the
reference's) ``get_projected_image.py``:

    python -m content_aware_gan_compression_torch.get_projected_image \\
        --ckpt g.npz --image_file face.png

Projects the target image into the generator's W+ latent and noise maps
with L-BFGS (``--opt Adam`` for Adam), prints the ``LPIPS Score:`` (when the
VGG16 weights are present) and ``PSNR Score:`` lines and writes the target
and the projection side by side as a PNG (``--out``). The target is read
with Pillow when it is installed (``convert('RGB')`` and a resize to
``--generated_img_size``, as the JAX CLI does); without Pillow only 8-bit
PNGs of that size are read (``utils.logging.read_png``). Runs on ``cuda``
unless ``--device cpu`` is given; the draws come from a
``torch.Generator(device)`` seeded with ``--seed``. The JAX CLI's
``--packed`` (a TPU form) has no counterpart.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def load_target_image(path: str, size: int) -> np.ndarray:
    """The target as uint8 [size, size, 3]: through Pillow when it imports,
    else through ``read_png`` (grey repeated to RGB, alpha dropped, as
    Pillow's ``convert('RGB')``), which takes no other size."""
    try:
        from PIL import Image
    except ImportError:
        from .utils.logging import read_png

        arr = read_png(path)
        if arr.shape[:2] != (size, size):
            raise ValueError(f"{path} is {arr.shape[1]}x{arr.shape[0]}, not {size}x{size}; "
                             "without Pillow the target is not resized: install Pillow or "
                             f"pass a {size}x{size} PNG") from None
        return np.ascontiguousarray(np.repeat(arr, 3, axis=2) if arr.shape[2] == 1
                                    else arr[..., :3])
    return np.asarray(Image.open(path).convert("RGB").resize((size, size)), np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--generated_img_size", type=int, default=256)
    p.add_argument("--ckpt", type=str, default="./Model/full_size_model/256px_full_size.pt")
    p.add_argument("--image_file", type=str, required=True)
    p.add_argument("--num_iters", type=int, default=800)
    p.add_argument("--info_print", action="store_true", default=False)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--opt", type=str, default="LBFGS", choices=["LBFGS", "Adam"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lpips_vgg_ckpt", type=str, default="./Model/metrics/vgg16_torchvision.pth")
    p.add_argument("--lpips_lins_ckpt", type=str, default="./lpips/weights/v0.1/vgg.pth")
    p.add_argument("--out", type=str, default="./Image_Projection_Visualization.png")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from .models import load_lpips
    from .projector import image_projector, img_to_tensor, psnr, to_uint8_image
    from .utils import load_generator, resolve_device
    from .utils.logging import write_png

    device = resolve_device(args.device)
    g = load_generator(args.ckpt, args.generated_img_size, args.latent, args.n_mlp,
                       device=device).requires_grad_(False)
    lpips = None
    if os.path.exists(args.lpips_vgg_ckpt):
        lpips = load_lpips(args.lpips_vgg_ckpt, args.lpips_lins_ckpt,
                           device=device).requires_grad_(False)
    else:
        print(f"WARNING: no VGG weights at {args.lpips_vgg_ckpt}; projecting with MSE only, "
              "skipping LPIPS score")

    target_uint8 = load_target_image(args.image_file, args.generated_img_size)
    target = img_to_tensor(target_uint8).to(device)
    output, _, _, losses = image_projector(
        g, target, lpips=lpips, generator=torch.Generator(device).manual_seed(args.seed),
        opt=args.opt, num_iters=args.num_iters, print_iters=100 if args.info_print else None)

    out_uint8 = to_uint8_image(output[0].cpu().numpy())
    result = {"losses": losses}
    if lpips is not None:
        with torch.no_grad():
            result["lpips"] = float(lpips(output, target).squeeze())
        print(f"LPIPS Score: {round(result['lpips'], 4)}")
    result["psnr"] = psnr(out_uint8, target_uint8)
    print(f"PSNR Score: {round(result['psnr'], 4)}")
    write_png(args.out, np.concatenate([target_uint8, out_uint8], axis=1))
    print(f"saved visualization to {args.out}")
    return result


if __name__ == "__main__":
    main()
