"""Generator FLOPs accounting (reference Util/Calculators.py; the JAX
package's utils/calculators.py), and MAC counts of the aux nets and the
discriminator.

The generator counters take a ``net_shape`` tuple, a ``Generator`` or its
flat state dict: the widths are the model description. The mapping and
modulation counters read the state dict's ``style.N.weight`` and
``*.conv.modulation.weight`` shapes.
"""

from __future__ import annotations

import math

MAP_SIZE = []
for _i in range(2, 11):
    MAP_SIZE += [2 ** _i, 2 ** _i]

STYLE_CONV_KER_SIZE = 3
TORGB_CONV_KER_SIZE = 1
NUM_RGB_CHANNEL = 3
GENERATOR_FLOPS_256PX = 45_124_673_536   # reference Calculators.py:13
GENERATOR_FLOPS_1024PX = 74_266_894_336  # reference Calculators.py:14


def _state_dict(params_or_module):
    if hasattr(params_or_module, "state_dict"):
        return params_or_module.state_dict()
    return params_or_module


def _net_shape(params_or_shape):
    if isinstance(params_or_shape, (tuple, list)):
        return list(params_or_shape)
    from ..models.stylegan2 import net_shape_from_params

    return list(net_shape_from_params(_state_dict(params_or_shape)))


def styled_conv_flops(params_or_shape, return_detail=True):
    """Styled-conv FLOPs (reference Calculators.py:16-37)."""
    net_shape = _net_shape(params_or_shape)
    lay = [net_shape[i] * net_shape[i + 1] * STYLE_CONV_KER_SIZE ** 2 * MAP_SIZE[i] ** 2
           for i in range(len(net_shape) - 1)]
    return (sum(lay), lay) if return_detail else sum(lay)


def to_rgb_flops(params_or_shape, return_detail=True):
    """ToRGB conv FLOPs (reference Calculators.py:39-61)."""
    net_shape = _net_shape(params_or_shape)
    lst = [net_shape[2 * i + 1] * NUM_RGB_CHANNEL * TORGB_CONV_KER_SIZE ** 2
           * MAP_SIZE[2 * i + 1] ** 2 for i in range(len(net_shape) // 2)]
    return (sum(lst), lst) if return_detail else sum(lst)


def mapping_network_flops(params):
    """Style-MLP FLOPs from the ``style.N.weight`` shapes (reference
    Calculators.py:63-77)."""
    sd = _state_dict(params)
    return sum(math.prod(v.shape) for k, v in sd.items()
               if k.startswith("style.") and k.endswith(".weight"))


def style_modulation_flops(params):
    """Modulation affine FLOPs from the ``*.conv.modulation.weight`` shapes
    (reference Calculators.py:79-93)."""
    sd = _state_dict(params)
    return sum(math.prod(v.shape) for k, v in sd.items()
               if k.endswith(".conv.modulation.weight"))


def stylegan2_flops(params):
    """Total generator FLOPs (reference Calculators.py:95-105)."""
    return (styled_conv_flops(params, False) + to_rgb_flops(params, False)
            + mapping_network_flops(params) + style_modulation_flops(params))


def vgg16_lpips_flops(input_size: int = 256):
    """MACs of one LPIPS forward (VGG16 features through relu5_3 plus the
    five 1x1 heads) at ``input_size``**2, per image and per branch (the JAX
    package's count)."""
    from ..models.lpips import LPIPS_CHANNELS, POOL_POSITIONS, SLICE_ENDS, VGG16_CONVS

    total, hw, seq, slice_i = 0, input_size, 0, 0
    for idx, cin, cout in VGG16_CONVS:
        while seq in POOL_POSITIONS:
            hw //= 2
            seq += 1
        assert idx == seq, (idx, seq)
        total += cin * cout * 9 * hw * hw
        seq += 2
        if seq - 1 in SLICE_ENDS:
            total += LPIPS_CHANNELS[slice_i] * hw * hw  # the 1x1 head
            slice_i += 1
    return total


def bisenet_flops(input_size: int = 512):
    """MACs of one BiSeNet head-0 parse at ``input_size``**2, the live path
    only: the ResNet-18 context path, ARM16/32, FFM and the fused head (the
    JAX package's count)."""
    s2, s4 = input_size // 2, input_size // 4
    s8, s16, s32 = input_size // 8, input_size // 16, input_size // 32
    t = 3 * 64 * 49 * s2 * s2                       # conv1 7x7 stride 2
    t += 2 * 2 * 64 * 64 * 9 * s4 * s4              # layer1: 2 basic blocks

    def down_layer(cin, cout, res):
        # block0 (conv1 s2 + conv2 + 1x1 downsample) + block1 (2 convs)
        return (cin * cout * 9 * res * res + cout * cout * 9 * res * res
                + cin * cout * res * res + 2 * cout * cout * 9 * res * res)

    t += down_layer(64, 128, s8)                    # layer2 -> feat8
    t += down_layer(128, 256, s16)                  # layer3 -> feat16
    t += down_layer(256, 512, s32)                  # layer4 -> feat32
    t += 512 * 128                                  # conv_avg 1x1 @ 1x1
    t += 512 * 128 * 9 * s32 * s32 + 128 * 128      # arm32 conv + attention
    t += 128 * 128 * 9 * s16 * s16                  # conv_head32 @ feat16 res
    t += 256 * 128 * 9 * s16 * s16 + 128 * 128      # arm16 conv + attention
    t += 128 * 128 * 9 * s8 * s8                    # conv_head16 @ feat8 res
    t += 256 * 256 * s8 * s8 + 256 * 64 + 64 * 256  # FFM convblk + attens
    t += 256 * 256 * 9 * s8 * s8 + 256 * 19 * s8 * s8  # fused output head
    return t


def discriminator_flops(size: int, channel_multiplier: int = 2, channel_max: int = 512):
    """Discriminator MACs per image: the 1x1 stem, log2(size)-2 ResBlocks
    (3x3 conv, stride-2 3x3 conv, 1x1 skip), the stddev channel, the final
    3x3 conv and the two linears (the JAX package's count)."""
    from ..models.stylegan2 import default_channels

    ch = {k: min(v, channel_max) for k, v in default_channels(channel_multiplier).items()}
    total = 3 * ch[size] * size * size  # stem 1x1
    res, in_ch = size, ch[size]
    while res > 4:
        out_ch = ch[res // 2]
        total += in_ch * in_ch * 9 * res * res          # conv1 3x3
        total += in_ch * out_ch * 9 * (res // 2) ** 2   # conv2 3x3 stride 2
        total += in_ch * out_ch * (res // 2) ** 2       # skip 1x1
        in_ch = out_ch
        res //= 2
    total += (in_ch + 1) * ch[4] * 9 * 16               # final_conv @4x4
    total += ch[4] * 16 * ch[4] + ch[4]                 # final linears
    return total
