"""StyleGAN2 generator and discriminator."""

from .stylegan2 import (
    Discriminator,
    DiscriminatorConfig,
    Generator,
    GeneratorConfig,
    default_channels,
    default_net_shape,
    discriminator_config_from_params,
    net_shape_from_params,
)

__all__ = ["Discriminator", "DiscriminatorConfig", "Generator", "GeneratorConfig",
           "default_channels", "default_net_shape", "discriminator_config_from_params",
           "net_shape_from_params"]
