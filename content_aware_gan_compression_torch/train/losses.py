"""GAN and distillation losses (the JAX package's train/losses.py; reference
train.py:145-206). Images may be NCHW or NHWC: every loss here is a mean or a
sum over all elements, so the layout does not change it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEXT_SLICE = ("content-aware KD masks and LPIPS come with the next slice of the "
               "port (BiSeNet, LPIPS and the COI mask helpers)")


def d_logistic_loss(real_pred, fake_pred):
    """Softplus logistic D loss (reference train.py:187-191)."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    """Non-saturating G loss (reference train.py:203-206)."""
    return F.softplus(-fake_pred).mean()


def r1_penalty(discriminator, real_img):
    """R1 = E[||grad_x D(x)||^2] (reference train.py:194-200), with the graph
    kept for its own gradient. Returns the raw penalty; the caller weighs it
    by r1/2 * d_reg_every."""
    real_img = real_img.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(discriminator(real_img).float().sum(), real_img,
                                  create_graph=True)
    return grad.reshape(grad.shape[0], -1).square().sum(1).mean()


def kd_loss(fake_img, fake_img_list, teacher_img_list, *, kd_l1_lambda, kd_lpips_lambda,
            kd_mode, size, lpips_params=None, parse_fn=None, lpips_image_size=256):
    """Knowledge distillation from the teacher (reference KD_loss,
    train.py:145-184): L1 between student and teacher images, the final
    output only or summed over the per-scale rgb list. Teacher images arrive
    without gradients. Returns ``(kd_l1, kd_lpips)``; ``kd_lpips`` is 0 here.

    The content-aware mask (``parse_fn``) and the LPIPS term
    (``lpips_params``) are not ported yet and raise."""
    del size, lpips_image_size, kd_lpips_lambda  # used by the LPIPS term only
    if parse_fn is not None or lpips_params is not None:
        raise NotImplementedError(_NEXT_SLICE)
    if kd_mode == "Output_Only":
        kd_l1 = kd_l1_lambda * torch.mean(torch.abs(teacher_img_list[-1] - fake_img))
    elif kd_mode == "Intermediate":
        # as the reference (train.py:165-169): the rgb-list L1 takes the
        # unmasked intermediate images
        kd_l1 = kd_l1_lambda * sum(torch.mean(torch.abs(t - s))
                                   for t, s in zip(teacher_img_list, fake_img_list))
    else:
        raise ValueError(f"unknown kd_mode {kd_mode!r}")
    return kd_l1, torch.zeros((), dtype=fake_img.dtype, device=fake_img.device)
