"""Latent-space image projection (reference get_projected_image.py and
Miscellaneous/Image2StyleGAN_util.py; the JAX package's projector), with
optax's L-BFGS and zoom line search in PyTorch (``lbfgs``)."""

from .lbfgs import LBFGS, ZoomLineSearch
from .project import (
    OPTIMIZERS,
    image_projector,
    image_reconstruction_loss,
    img_to_tensor,
    latent_style_mixing,
    noise_style_mixing,
    psnr,
    to_uint8_image,
)

__all__ = ["LBFGS", "ZoomLineSearch", "OPTIMIZERS", "image_projector",
           "image_reconstruction_loss", "img_to_tensor", "latent_style_mixing",
           "noise_style_mixing", "psnr", "to_uint8_image"]
