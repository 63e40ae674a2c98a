"""GAN and distillation losses (the JAX package's train/losses.py; reference
train.py:145-206). The GAN losses are means or sums over all elements, so
they take either layout; ``kd_loss`` takes its images' layout as
``data_format``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..pruning.content_aware import batch_img_parsing, bilinear_resize, get_masked_tensor


def d_logistic_loss(real_pred, fake_pred):
    """Softplus logistic D loss (reference train.py:187-191)."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    """Non-saturating G loss (reference train.py:203-206)."""
    return F.softplus(-fake_pred).mean()


def r1_penalty(discriminator, real_img, dtype=None, remat=False):
    """R1 = E[||grad_x D(x)||^2] (reference train.py:194-200), with the graph
    kept for its own gradient; D runs in ``dtype`` (its res-blocks
    checkpointed with ``remat``), the gradient comes back in the image's
    type. Returns the raw penalty; the caller weighs it by r1/2 *
    d_reg_every."""
    real_img = real_img.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(discriminator(real_img, dtype, remat).float().sum(),
                                  real_img, create_graph=True)
    return grad.reshape(grad.shape[0], -1).square().sum(1).mean()


def kd_loss(fake_img, fake_img_list, teacher_img_list, *, kd_l1_lambda, kd_lpips_lambda,
            kd_mode, size, lpips=None, parse_fn=None, lpips_image_size=256,
            data_format="NCHW", aux_dtype=None):
    """Content-masked knowledge distillation (reference KD_loss,
    train.py:145-184): L1 between the (COI-masked) student and teacher
    images, the final output only or summed over the per-scale rgb list,
    plus LPIPS between the (masked, and above ``lpips_image_size``
    downsampled to 256) final images. Returns ``(kd_l1, kd_lpips)``.

    The teacher's parse (``parse_fn``, BiSeNet head 0) masks both images;
    teacher images arrive without gradients. ``lpips`` is an ``LPIPS``
    module (or None: no LPIPS term). ``data_format`` is the layout of every
    image and of ``parse_fn``'s input and output. ``aux_dtype`` is the VGG
    trunk's compute type (``LPIPS``'s ``dtype``; the caller's ``parse_fn``
    handles BiSeNet's); the L1 term and the loss values stay in the images'
    type."""
    fake_img_teacher = teacher_img_list[-1]
    if parse_fn is not None:
        teacher_parsing = batch_img_parsing(fake_img_teacher, parse_fn, data_format)
        fake_img_teacher = get_masked_tensor(fake_img_teacher, teacher_parsing, data_format)
        fake_img = get_masked_tensor(fake_img, teacher_parsing, data_format)

    if kd_mode == "Output_Only":
        kd_l1 = kd_l1_lambda * torch.mean(torch.abs(fake_img_teacher - fake_img))
    elif kd_mode == "Intermediate":
        # as the reference (train.py:165-169): the rgb-list L1 takes the
        # unmasked intermediate images, and LPIPS then sees the unmasked
        # final teacher image
        kd_l1 = kd_l1_lambda * sum(torch.mean(torch.abs(t - s))
                                   for t, s in zip(teacher_img_list, fake_img_list))
        fake_img_teacher = teacher_img_list[-1]
    else:
        raise ValueError(f"unknown kd_mode {kd_mode!r}")

    if lpips is None:
        return kd_l1, torch.zeros((), dtype=fake_img.dtype, device=fake_img.device)
    a, b = fake_img, fake_img_teacher
    if size > lpips_image_size:
        # the reference pools >256px images to 256 (train.py:176-182)
        a, b = (bilinear_resize(t, 256, 256, data_format) for t in (a, b))
    kw = {} if aux_dtype is None else {"dtype": aux_dtype}
    kd_lpips = kd_lpips_lambda * torch.mean(lpips(a, b, data_format=data_format, **kw).float())
    return kd_l1, kd_lpips
