"""Image projection into the generator's W+ latent and noise maps (the JAX
package's projector/project.py, itself reconstructed from the reference's
get_projected_image.py:44-93 and Miscellaneous/Image2StyleGAN_util.py:8-105).

The W+ latent starts at the mean W of ``avg_w_samples`` mapped z, one copy
per layer and per sample, and the noise maps at a ``make_noise`` draw; both
(or the latent alone) are optimized against MSE + LPIPS with L-BFGS
(``lbfgs.LBFGS``, optax's, the JAX projector's default) or Adam (lr 0.01).
The variables travel as one flat vector in the JAX pytree's leaf order
(latent, then the noise maps), so the generator reads them as views and one
backward gives the whole gradient. Draws come from a ``torch.Generator`` on
the generator's device or are handed in as tensors.

The JAX projector's ``packed`` trunk is a TPU form, a no-op below 512px, and
has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from .lbfgs import LBFGS

OPTIMIZERS = ("LBFGS", "Adam")


def img_to_tensor(image) -> torch.Tensor:
    """A uint8 [H, W, 3] image (a PIL image or an array) -> [1, 3, H, W]
    float32 in [-1, 1] (the reference's im2tensor)."""
    arr = np.asarray(image, np.float32).transpose(2, 0, 1) / 127.5 - 1.0
    return torch.from_numpy(np.ascontiguousarray(arr))[None]


def psnr(img_a_uint8, img_b_uint8) -> float:
    """PSNR between uint8 images (reference Get_PSNR_Model_Image)."""
    a = np.asarray(img_a_uint8, np.float64)
    b = np.asarray(img_b_uint8, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(255.0 / np.sqrt(mse)))


def image_reconstruction_loss(output, target, lpips=None):
    """The 'mse+lpips' criterion (Image2StyleGAN_util.py:76-78): the MSE,
    plus the mean LPIPS at the images' own size when ``lpips`` is given."""
    loss = torch.mean(torch.square(output - target))
    if lpips is not None:
        loss = loss + torch.mean(lpips(output, target))
    return loss


def latent_style_mixing(img_latent, inject_index):
    """Two W+ codes mixed at a layer index: layers below ``inject_index``
    from the first (Image2StyleGAN_util.py:107-121)."""
    a, b = img_latent
    pos = torch.arange(a.shape[1], device=a.device)[None, :, None]
    return torch.where(pos < inject_index, a, b)


def noise_style_mixing(noises, inject_index):
    """Per-layer noise crossover: the first ``inject_index - 1`` maps from
    the first list (Image2StyleGAN_util.py:124-135)."""
    return list(noises[0][:inject_index - 1]) + list(noises[1][inject_index - 1:])


def image_projector(g, target_images, *, lpips=None, generator=None, avg_w_z=None, noise=None,
                    per_layer_w=True, optimize_noise=True, opt="LBFGS", num_iters=800, lr=None,
                    avg_w_samples=4096, print_iters=None, info=None):
    """Project target images (reference Image_Projector,
    Image2StyleGAN_util.py:8-105).

    Args:
      g: the ``Generator``; it is not changed.
      target_images: [N, 3, H, W] in [-1, 1].
      lpips: an ``LPIPS`` for the loss's perceptual term, or None (MSE).
      generator: a ``torch.Generator`` on ``g``'s device for the draws that
        are not handed in: ``avg_w_z`` [avg_w_samples, style_dim], the z
        whose mean W starts the latent, and ``noise``, the initial
        per-layer NHWC noise maps.
      opt: 'LBFGS' (optax's L-BFGS with its zoom line search; ``lr`` is not
        used) or 'Adam' (lr 0.01 unless ``lr``).
      info: a dict that gets the run's ``evaluations`` of the objective
        (and for L-BFGS the accepted ``stepsizes``).
    Returns (output images [N, 3, H, W], the final latent, the final noise
    maps, the loss at the start of each iteration as a numpy array).
    """
    if opt not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {opt!r}")
    device = g.device
    target = target_images.to(device)
    batch = target.shape[0]
    with torch.no_grad():
        if avg_w_z is None:
            avg_w = g.mean_latent(avg_w_samples, generator)
        else:
            avg_w = g.get_latent(avg_w_z.to(device)).mean(0, keepdim=True)
    if per_layer_w:
        avg_w = avg_w[:, None, :].repeat(1, g.config.n_latent, 1)
    latent0 = avg_w.repeat(batch, *([1] * (avg_w.dim() - 1)))
    noises0 = ([n.to(device) for n in noise] if noise is not None
               else g.make_noise(batch, generator))

    leaves = [latent0] + (noises0 if optimize_noise else [])
    sizes = [t.numel() for t in leaves]

    def unflatten(x):
        parts = [p.view(t.shape) for p, t in zip(torch.split(x, sizes), leaves)]
        return parts[0], (parts[1:] if optimize_noise else noises0)

    def synth(x):
        latent, noises = unflatten(x)
        return g([latent], input_is_latent=True, noise=noises)

    stats = {"evaluations": 0}

    def value_and_grad(x):
        stats["evaluations"] += 1
        x = x.detach().requires_grad_(True)
        loss = image_reconstruction_loss(synth(x), target, lpips)
        (grad,) = torch.autograd.grad(loss, x)
        return loss.detach(), grad

    x = torch.cat([t.reshape(-1) for t in leaves]).detach()
    losses = []
    if opt == "LBFGS":
        solver = LBFGS()
        stats["stepsizes"] = []
        for _ in range(num_iters):
            x, value = solver.step(x, value_and_grad)
            losses.append(value)
            stats["stepsizes"].append(solver.last.stepsize)
        losses = np.asarray(losses, np.float32)
    else:
        x.requires_grad_(True)
        solver = torch.optim.Adam([x], lr=lr if lr is not None else 0.01)
        for _ in range(num_iters):
            value, x.grad = value_and_grad(x)
            losses.append(value)
            solver.step()
        x = x.detach()
        losses = (torch.stack(losses).cpu().numpy() if losses
                  else np.zeros(0, np.float32))
    if print_iters:
        for i in range(0, num_iters, print_iters):
            print(f"iter {i}: loss {losses[i]:.6f}")
    if info is not None:
        info.update(stats)
    with torch.no_grad():
        output = synth(x)
    latent, noises = unflatten(x)
    return output, latent, [n.detach() for n in noises], losses


def to_uint8_image(image_chw) -> np.ndarray:
    """A [3, H, W] image in [-1, 1] -> uint8 [H, W, 3], rounded as the JAX
    CLI rounds."""
    arr = np.asarray(image_chw, np.float32)
    out = ((np.clip(arr, -1, 1) + 1) * 127.5 + 0.5).clip(0, 255)
    return out.astype(np.uint8).transpose(1, 2, 0)
