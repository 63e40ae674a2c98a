"""StyleGAN2 generator (the discriminator comes with the training slice)."""

from .stylegan2 import (
    Generator,
    GeneratorConfig,
    default_channels,
    default_net_shape,
    net_shape_from_params,
)

__all__ = ["Generator", "GeneratorConfig", "default_channels", "default_net_shape",
           "net_shape_from_params"]
