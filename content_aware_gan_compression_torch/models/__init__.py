"""StyleGAN2 generator and discriminator, the KD objective's aux nets
(LPIPS-VGG16 and the BiSeNet face parser) and FID's InceptionV3."""

from .bisenet import BISENET_WIDTHS, N_CLASSES, BiSeNet, bisenet_widths, load_bisenet, make_parse_fn
from .inception import POOL3_DIM, InceptionV3, load_fid_inception, pool3_dim
from .lpips import (
    LPIPS,
    LPIPS_CHANNELS,
    VGG16_CONVS,
    VGG16Features,
    import_lpips_lins,
    import_vgg16_features,
    load_lpips,
    vgg16_widths,
)
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
           "net_shape_from_params", "BISENET_WIDTHS", "N_CLASSES", "BiSeNet", "bisenet_widths",
           "load_bisenet", "make_parse_fn", "LPIPS", "LPIPS_CHANNELS", "VGG16_CONVS",
           "VGG16Features", "import_lpips_lins", "import_vgg16_features", "load_lpips",
           "vgg16_widths", "POOL3_DIM", "InceptionV3", "load_fid_inception", "pool3_dim"]
