"""Model MACs, counted from a configuration's widths and a cell's shapes
(frozen copies of the reference's Util/Calculators.py and of the count of
``content_aware_gan_compression_torch/bench.py:iteration_macs``).

Every count is the model's work: no recomputation, whatever the program
runs. One iteration of retraining at batch B is
  B (g + 6 d)                     the D step: the student's forward, D's
                                  forward and backward on two batches
+ B (3 g + 2 d + t)               the G step: the student's forward and
                                  backward, D's forward and input backward,
                                  the teacher's forward
+ B 6 d / d_reg_every             R1's grad of grad
+ (B / shrink) 6 g / g_reg_every  path length's grad of grad
+ B (3 lpips(256) + parse(512))   the full objective's aux nets
with g, t, d the student's, the teacher's and D's MACs per image.
"""

from __future__ import annotations

import math

MAP_SIZE = [2 ** (i // 2 + 2) for i in range(18)]  # 4, 4, 8, 8, ..., 1024, 1024
# peaks of one NVIDIA H100 SXM (data sheet, dense): TFLOP/s by compute type and
# device-memory bytes/s
PEAK_TFLOPS = {"bfloat16": 989.4, "tf32": 494.7, "float32": 66.9}
HBM_BYTES_PER_S = 3.35e12


def generator_macs(net_shape, style_dim=512, n_mlp=8) -> int:
    """MACs of one image of a StyleGAN2 generator of widths ``net_shape``:
    the styled convolutions, the ToRGB convolutions, the mapping network and
    every modulation's affine (the reference's stylegan2_flops)."""
    ns = list(net_shape)
    convs = sum(ns[i] * ns[i + 1] * 9 * MAP_SIZE[i] ** 2 for i in range(len(ns) - 1))
    rgbs = sum(ns[2 * i + 1] * 3 * MAP_SIZE[2 * i + 1] ** 2 for i in range(len(ns) // 2))
    mapping = n_mlp * style_dim * style_dim
    # conv1, then each StyledConv's input width; each ToRGB's
    modulation = style_dim * (sum(ns[:-1]) + sum(ns[2 * i + 1] for i in range(len(ns) // 2)))
    return convs + rgbs + mapping + modulation


def discriminator_macs(size: int, channels: dict) -> int:
    """MACs of one image of StyleGAN2's discriminator."""
    total = 3 * channels[size] * size * size
    res, cin = size, channels[size]
    while res > 4:
        cout = channels[res // 2]
        total += cin * cin * 9 * res * res + cin * cout * 9 * (res // 2) ** 2 \
            + cin * cout * (res // 2) ** 2
        cin, res = cout, res // 2
    return total + (cin + 1) * channels[4] * 9 * 16 + channels[4] * 16 * channels[4] + channels[4]


VGG16 = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M", (128, 256), (256, 256),
         (256, 256), "M", (256, 512), (512, 512), (512, 512), "M", (512, 512), (512, 512),
         (512, 512)]
LPIPS_HEADS = {1: 64, 3: 128, 6: 256, 9: 512, 12: 512}  # conv index -> 1x1 head width


def lpips_macs(size=256) -> int:
    """MACs of one LPIPS branch (VGG16 to relu5_3 and the 1x1 heads)."""
    total, hw, k = 0, size, 0
    for layer in VGG16:
        if layer == "M":
            hw //= 2
            continue
        total += layer[0] * layer[1] * 9 * hw * hw
        total += LPIPS_HEADS.get(k, 0) * hw * hw
        k += 1
    return total


def bisenet_macs(size=512) -> int:
    """MACs of one BiSeNet head-0 parse: the ResNet-18 context path,
    ARM16/32, FFM and the fused output head."""
    s2, s4, s8, s16, s32 = (size // d for d in (2, 4, 8, 16, 32))
    t = 3 * 64 * 49 * s2 * s2 + 2 * 2 * 64 * 64 * 9 * s4 * s4

    def down(cin, cout, r):
        return cin * cout * 9 * r * r + cout * cout * 9 * r * r + cin * cout * r * r \
            + 2 * cout * cout * 9 * r * r

    t += down(64, 128, s8) + down(128, 256, s16) + down(256, 512, s32)
    t += 512 * 128 + 512 * 128 * 9 * s32 * s32 + 128 * 128 + 128 * 128 * 9 * s16 * s16
    t += 256 * 128 * 9 * s16 * s16 + 128 * 128 + 128 * 128 * 9 * s8 * s8
    t += 256 * 256 * s8 * s8 + 256 * 64 + 64 * 256 + 256 * 256 * 9 * s8 * s8 \
        + 256 * 19 * s8 * s8
    return t


def inception_macs(size: int) -> int:
    """MACs of one FID InceptionV3 forward to pool3 (the input resized to
    299), counted over the reference network's convolutions on the meta
    device."""
    import torch

    from ..reference.aux_nets import InceptionV3

    total = 0

    def hook(module, inputs, output):
        nonlocal total
        w = module.conv.weight
        total += math.prod(output.shape[1:]) * math.prod(w.shape[1:])

    with torch.device("meta"):
        net = InceptionV3()
        for m in net.modules():
            if type(m).__name__ == "BasicConv2d":
                m.register_forward_hook(hook)
        net(torch.empty(1, 3, size, size))
    return total


def retrain_iteration_macs(cfg: dict, traffic: dict) -> float:
    """MACs of one retraining iteration at the traffic's global batch (the
    module docstring's count)."""
    b, size = traffic["batch"], cfg["size"]
    g = generator_macs(cfg["student_net_shape"])
    t = generator_macs(cfg["teacher_net_shape"])
    d = discriminator_macs(size, {int(k): v for k, v in cfg["discriminator_channels"].items()})
    macs = (b * (g + 6 * d) + b * (3 * g + 2 * d + t) + b * 6 * d / traffic["d_reg_every"]
            + (b // traffic["path_batch_shrink"]) * 6 * g / traffic["g_reg_every"])
    return macs + b * (3 * lpips_macs(256) + bisenet_macs(512))


def infer_image_macs(cfg: dict, traffic: dict) -> float:
    """MACs of one image through the student and, for FID, Inception."""
    macs = generator_macs(cfg["student_net_shape"])
    if traffic.get("inception"):
        macs += inception_macs(cfg["size"])
    return macs


def peak_tflops(compute_dtype: str) -> float:
    """The dense peak the cell's compute type can reach: bf16's tensor cores,
    or TF32's for float32, which cuDNN may use under PyTorch's defaults."""
    return PEAK_TFLOPS["bfloat16" if compute_dtype == "bfloat16" else "tf32"]
