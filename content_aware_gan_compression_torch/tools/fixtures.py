"""Seeded files that the port's CLIs read, built by the port alone. No
released weights are in the repository; these stand in for them, in the
real files' schemas:

- PNG folders written by ``utils.logging.write_png`` (no JPEG: the card's
  machine may have no Pillow) and uint8 caches of the same kind of images;
- teacher and student checkpoints in the port's ``.npz`` format, the student
  at ``get_uniform_remove_list``'s widths; with ``carry_d`` both carry a
  discriminator, as the reference's prune.py expects of its input;
- the LPIPS files (torchvision's ``features.N.*``, the reference's
  ``lin{k}.model.1.weight``), BiSeNet's ``79999_iter.pth`` and the FID
  Inception (the pytorch-fid release), read by the CLIs' importers;
- a real-statistics pickle of random features, ``{'mean', 'cov'}``;
- the BiSeNet whose content-aware mask keeps 2-98% of the teacher's pixels
  (``pick_parser``): a random parser mostly parses every pixel as one
  class, which makes the mask, and so content-aware KD, all or nothing.

``chip_smoke.py`` and the ``e2e_validation`` and ``fid_descent_validation``
tools build their files here.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

STUDENT_SEED, TEACHER_SEED, D_SEED = 0, 1, 2
LPIPS_SEED = 5
INCEPTION_SEED = 0
PARSER_PICK_SEED = 7  # the latents of the teacher images the parser is picked on


# -- images -------------------------------------------------------------------
def _image(i, side, rng):
    """Smooth, photo-like content with noise (so that zlib has work to do):
    uint8 [side, side, 3]; draws the noise from ``rng``."""
    yy, xx = np.mgrid[0:side, 0:side] / side
    base = np.stack([np.sin(6 * xx + i), np.cos(5 * yy - i), np.sin(4 * (xx + yy))], -1)
    img = 127.5 * (base + 1) + rng.normal(0, 12, (side, side, 3))
    return img.clip(0, 255).astype(np.uint8)


def write_pngs(folder, side, n, seed, workers=8):
    """``n`` seeded 8-bit RGB PNGs of ``side`` pixels, written by
    ``write_png`` (row filter 0) in ``workers`` threads."""
    from ..utils.logging import write_png

    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    with ThreadPoolExecutor(workers) as pool:
        for start in range(0, n, 2 * workers):  # a bounded number of images in flight
            imgs = [(i, _image(i, side, rng)) for i in range(start, min(n, start + 2 * workers))]
            list(pool.map(lambda a: write_png(os.path.join(folder, f"{a[0]:05d}.png"), a[1]),
                          imgs))
    return folder


def smooth_noise(i, side, seed):
    """Image ``i`` of ``seed``: uniform noise blurred by a Gaussian of sigma 4
    in each channel, uint8 [side, side, 3] (the decode cost of a photo lies
    between pure noise's and a smooth field's)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng([seed, i])
    noise = rng.integers(0, 256, (side, side, 3)).astype(np.float32)
    return gaussian_filter(noise, sigma=(4, 4, 0)).round().clip(0, 255).astype(np.uint8)


def write_noise_pngs(folder, side, n, seed, workers=8):
    """``n`` PNGs of ``smooth_noise`` at ``side`` pixels, written by
    ``write_png`` in ``workers`` threads."""
    from ..utils.logging import write_png

    os.makedirs(folder, exist_ok=True)

    def one(i):
        write_png(os.path.join(folder, f"{i:05d}.png"), smooth_noise(i, side, seed))

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(one, range(n)))
    return folder


def write_cache(path, side, n, seed):
    """A uint8 [n, side, side, 3] ``.npy`` cache of ``write_pngs``' kind of
    images drawn at ``side`` (a resize needs Pillow, which the card's
    machine may lack)."""
    rng = np.random.RandomState(seed)
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=(n, side, side, 3))
    for i in range(n):
        out[i] = _image(i, side, rng)
    out.flush()
    del out
    return path


# -- checkpoints ----------------------------------------------------------------
def scaled_net_shape(size, width_scale=1.0):
    """The full generator's net_shape at ``size``, each width times
    ``width_scale`` (at least 1)."""
    from ..models import default_net_shape

    return tuple(max(1, int(c * width_scale)) for c in default_net_shape(size))


def student_shape(net_shape, remove_ratio=0.7):
    """``net_shape`` less ``get_uniform_remove_list``'s channels."""
    from ..pruning import get_uniform_remove_list

    return tuple(c - r for c, r in zip(net_shape, get_uniform_remove_list(list(net_shape),
                                                                           remove_ratio)))


def write_train_checkpoints(work, size, *, remove_ratio=0.7, carry_d=False, width_scale=1.0,
                            latent=512, n_mlp=8):
    """Seeded ``student<size>.npz`` {'g', 'g_ema'} (seed 0, the widths
    ``remove_ratio`` leaves) and ``teacher<size>.npz`` {'g_ema'} (seed 1,
    full width) at ``size``; with ``carry_d`` both also carry D (seed 2) and
    the teacher ``g``. ``width_scale`` < 1 narrows the teacher and D (their
    widths are read off the tensors when loaded). Returns both paths."""
    from ..models import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig
    from ..utils import save_checkpoint

    full = scaled_net_shape(size, width_scale)

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    def g_state(shape, seed):
        return Generator(GeneratorConfig(size=size, style_dim=latent, n_mlp=n_mlp,
                                         net_shape=shape), device="cpu",
                         generator=seeded(seed)).state_dict()

    student = g_state(student_shape(full, remove_ratio), STUDENT_SEED)
    teacher = g_state(full, TEACHER_SEED)
    s_trees, t_trees = {"g": student, "g_ema": student}, {"g_ema": teacher}
    if carry_d:
        d_cfg = DiscriminatorConfig(size=size, channel_max=max(1, int(512 * width_scale)))
        d = Discriminator(d_cfg, device="cpu", generator=seeded(D_SEED)).state_dict()
        s_trees["d"] = d
        t_trees.update(g=teacher, d=d)
    paths = (os.path.join(work, f"student{size}.npz"), os.path.join(work, f"teacher{size}.npz"))
    save_checkpoint(paths[0], s_trees, metadata={"size": size, "seed": STUDENT_SEED})
    save_checkpoint(paths[1], t_trees, metadata={"size": size, "seed": TEACHER_SEED})
    return paths


# -- aux nets -------------------------------------------------------------------
def seeded_lpips(width_scale=1.0):
    """LPIPS-VGG16 on the CPU, drawn from ``LPIPS_SEED``."""
    from ..models import LPIPS, vgg16_widths

    return LPIPS(vgg16_widths(width_scale), device="cpu",
                 generator=torch.Generator().manual_seed(LPIPS_SEED))


def seeded_inception(width_scale=1.0, seed=INCEPTION_SEED):
    """The FID InceptionV3 on the CPU, drawn from ``seed``."""
    from ..models import InceptionV3

    return InceptionV3(width_scale, device="cpu",
                       generator=torch.Generator().manual_seed(seed)).eval()


def mask_share(parser, img_nhwc):
    """The share of ``img_nhwc``'s pixels the content-aware mask keeps, with
    ``parser``'s parse."""
    from ..models import make_parse_fn
    from ..pruning import batch_img_parsing, get_masked_tensor

    parse = batch_img_parsing(img_nhwc, make_parse_fn(parser, "NHWC"), "NHWC")
    return get_masked_tensor(torch.ones_like(img_nhwc[..., :1]), parse, "NHWC").mean().item()


def pick_parser(img_nhwc, width_scale=1.0, seeds=64):
    """A seeded BiSeNet whose mask keeps between 2% and 98% of these
    images' pixels: the first seed that does, on the images' device. Returns
    (net, seed, share); raises when none of ``seeds`` does."""
    from ..models import BiSeNet, bisenet_widths

    for seed in range(seeds):
        net = BiSeNet(bisenet_widths(width_scale), device="cpu",
                      generator=torch.Generator().manual_seed(seed))
        net = net.to(img_nhwc.device, img_nhwc.dtype).requires_grad_(False).eval()
        share = mask_share(net, img_nhwc)
        if 0.02 <= share <= 0.98:
            return net, seed, share
    raise RuntimeError(f"no BiSeNet seed in 0..{seeds - 1} parses the teacher's images into a "
                       "mixed mask")


def teacher_images(teacher, n, seed=PARSER_PICK_SEED):
    """``n`` NHWC images of the generator ``teacher`` from fresh latents and
    noise drawn from ``seed`` on its device."""
    gen = torch.Generator(teacher.device).manual_seed(seed)
    with torch.no_grad():
        z = torch.randn(n, teacher.config.style_dim, generator=gen, device=teacher.device)
        return teacher([z], noise=teacher.make_noise(n, gen), output_format="NHWC")


def bisenet_file_state(parser):
    """``parser``'s state dict in the 79999_iter.pth schema
    (``num_batches_tracked`` in every batch norm), on the CPU."""
    sd = {k: v.cpu() for k, v in parser.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(79999)
    return sd


def write_aux_files(work, lpips, parser=None):
    """``lpips`` and ``parser`` in the files the train CLI reads:
    torchvision's VGG16 (``features.N.*``), the reference's LPIPS heads
    (``lin{k}.model.1.weight``) and, with a parser, 79999_iter.pth."""
    files = {"vgg16.pth": {f"features.{k}": v.cpu() for k, v in lpips.vgg.state_dict().items()},
             "lpips_lins.pth": {f"lin{k}.model.1.weight": lin.weight.detach().cpu()
                                for k, lin in enumerate(lpips.lins)}}
    if parser is not None:
        files["79999_iter.pth"] = bisenet_file_state(parser)
    paths = [os.path.join(work, name) for name in files]
    for path, sd in zip(paths, files.values()):
        torch.save(sd, path)
    return paths


def write_fid_inception(path, inception):
    """``inception`` in the pytorch-fid release's schema (the classifier
    ``fc.*`` and ``num_batches_tracked`` in every batch norm, which the
    importer drops)."""
    from ..models import pool3_dim

    sd = dict(inception.state_dict())
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    sd.update({"fc.weight": torch.zeros(1008, pool3_dim(inception)), "fc.bias": torch.zeros(1008)})
    torch.save({k: v.cpu() for k, v in sd.items()}, path)
    return path


def write_real_stats(path, dim, n=4096, seed=0):
    """``{'mean', 'cov'}`` (float64) of ``n`` standard-normal ``dim``-wide
    features: real statistics for a run whose FID only has to run."""
    feats = np.random.default_rng(seed).standard_normal((n, dim))
    with open(path, "wb") as f:
        pickle.dump({"mean": feats.mean(0), "cov": np.cov(feats, rowvar=False)}, f)
    return path


def write_run_files(work, size, device, *, remove_ratio=0.7, width_scale=1.0, latent=512,
                    n_mlp=8, aux_width_scale=1.0, inception_width_scale=1.0, pick_batch=16):
    """Every seeded file a retraining run reads: the checkpoints
    (``write_train_checkpoints`` with D carried), the LPIPS files, the
    BiSeNet picked on ``pick_batch`` of the teacher's images on ``device``,
    and the FID Inception. Returns their paths by name, with the parser's
    seed and share and Inception's feature width."""
    from ..models import pool3_dim
    from ..utils import load_generator

    os.makedirs(work, exist_ok=True)
    student, teacher = write_train_checkpoints(work, size, remove_ratio=remove_ratio,
                                               carry_d=True, width_scale=width_scale,
                                               latent=latent, n_mlp=n_mlp)
    t = load_generator(teacher, size, latent, n_mlp, device=device).eval()
    parser, parser_seed, share = pick_parser(teacher_images(t, pick_batch), aux_width_scale)
    del t
    vgg, lins, bisenet = write_aux_files(work, seeded_lpips(aux_width_scale), parser)
    inc = seeded_inception(inception_width_scale)
    inception = write_fid_inception(os.path.join(work, "pt_inception.pth"), inc)
    return {"student": student, "teacher": teacher, "vgg16": vgg, "lins": lins,
            "bisenet": bisenet, "inception": inception, "pool3_dim": pool3_dim(inc),
            "parser_seed": parser_seed, "parser_share": share}
