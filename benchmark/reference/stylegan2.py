"""StyleGAN2's generator and discriminator (Karras et al., arXiv:1912.04958;
the layout of rosinality's stylegan2-pytorch model.py, which the
content-aware compression code builds on), in plain PyTorch on NCHW
tensors.

Modulated convolutions take the published non-fused form (NVlabs
stylegan2-ada-pytorch, ``modulated_conv2d`` with ``fused_modconv=False``):
the input scaled by each sample's style, one convolution with the shared
weight, the output scaled by each sample's demodulation coefficients.
Parameter names are those of the published checkpoints, so one state dict
loads here and in the system under test. ``net_shape`` lists the
generator's per-layer widths, so a pruned student is a generator with other
widths.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import ops


def channels(channel_multiplier=2):
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * channel_multiplier,
            128: 128 * channel_multiplier, 256: 64 * channel_multiplier,
            512: 32 * channel_multiplier, 1024: 16 * channel_multiplier}


def full_net_shape(size, channel_multiplier=2):
    ch = channels(channel_multiplier)
    shape = [ch[4], ch[4]]
    for i in range(3, int(math.log2(size)) + 1):
        shape += [ch[2 ** i], ch[2 ** i]]
    return tuple(shape)


def uniform_student_shape(size, remove_ratio, channel_multiplier=2):
    """The student's widths: ``int(c * remove_ratio)`` channels removed from
    every layer of the full generator (the reference's
    ``get_uniform_remove_list``)."""
    return tuple(c - int(c * remove_ratio) for c in full_net_shape(size, channel_multiplier))


def _empty(*shape):
    return nn.Parameter(torch.empty(*shape))


def init_rule(name: str, shape) -> tuple[float, float]:
    """(std, mean) of the normal each generator or discriminator tensor is
    drawn from: the equalized-learning-rate weights are standard normal
    (the mapping's divided by its lr multiplier 0.01), the modulation biases
    1; biases and noise strengths are drawn small rather than left at 0, so
    that every term of the layers they feed is exercised."""
    if name.startswith("style.") and name.endswith(".weight"):
        return 100.0, 0.0
    if name.endswith("modulation.bias"):
        return 0.0, 1.0
    if name.startswith("noises."):
        return 1.0, 0.0
    if name.endswith("bias") or name.endswith("noise.weight"):
        return 0.1, 0.0
    return 1.0, 0.0


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, lr_mul=1.0, activation=False):
        super().__init__()
        self.weight = _empty(out_dim, in_dim)
        self.bias = _empty(out_dim)
        self.scale, self.lr_mul, self.activation = lr_mul / math.sqrt(in_dim), lr_mul, activation

    def forward(self, x):
        out = ops.linear(x, self.weight * self.scale)
        if self.activation:
            return ops.lrelu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class PixelNorm(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class ModulatedConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, k, style_dim, demodulate=True, upsample=False):
        super().__init__()
        self.weight = _empty(1, out_ch, in_ch, k, k)
        self.modulation = EqualLinear(style_dim, in_ch)
        self.scale = 1 / math.sqrt(in_ch * k * k)
        self.demodulate, self.upsample, self.k = demodulate, upsample, k

    def forward(self, x, style):
        s = self.modulation(style)  # [B, in]
        w = self.weight[0] * self.scale  # [out, in, k, k]
        x = x * s[:, :, None, None]
        if self.upsample:
            out = ops.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        else:
            out = ops.conv2d(x, w, padding=self.k // 2)
        if self.demodulate:
            d = torch.rsqrt(s.square() @ w.square().sum((2, 3)).T + 1e-8)  # [B, out]
            out = out * d[:, :, None, None]
        if self.upsample:
            out = ops.blur(out, (1, 1), gain=4.0)
        return out


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = _empty(1)


class FusedLeakyReLU(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.bias = _empty(ch)


class StyledConv(nn.Module):
    def __init__(self, in_ch, out_ch, k, style_dim, upsample=False):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, k, style_dim, upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)

    def forward(self, x, style, noise):
        out = self.conv(x, style) + self.noise.weight * noise
        return ops.lrelu(out, self.activate.bias)


class ToRGB(nn.Module):
    def __init__(self, in_ch, style_dim):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False)
        self.bias = _empty(1, 3, 1, 1)

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias
        return out if skip is None else out + ops.upsample_skip(skip)


class ConstantInput(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.input = _empty(1, ch, 4, 4)


class Generator(nn.Module):
    """``forward(z, inject_index, noise)``: two z [B, 512], the mixing point
    (a 0-dim tensor; ``n_latent`` for none) and the per-layer noise maps
    [B, H, W, 1] (NHWC, as the benchmark draws them) -> images [B, 3, H, W]."""

    def __init__(self, size, net_shape=None, style_dim=512, n_mlp=8):
        super().__init__()
        ns = tuple(net_shape or full_net_shape(size))
        self.size, self.n_latent = size, int(math.log2(size)) * 2 - 2
        self.num_layers = (int(math.log2(size)) - 2) * 2 + 1
        self.style = nn.Sequential(PixelNorm(), *[EqualLinear(style_dim, style_dim, 0.01, True)
                                                  for _ in range(n_mlp)])
        self.input = ConstantInput(ns[0])
        self.conv1 = StyledConv(ns[0], ns[1], 3, style_dim)
        self.to_rgb1 = ToRGB(ns[1], style_dim)
        self.noises = nn.Module()
        for i in range(self.num_layers):
            res = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(f"noise_{i}", torch.empty(1, 1, res, res))
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        for i in range(1, len(ns) // 2):
            self.convs.append(StyledConv(ns[2 * i - 1], ns[2 * i], 3, style_dim, upsample=True))
            self.convs.append(StyledConv(ns[2 * i], ns[2 * i + 1], 3, style_dim))
            self.to_rgbs.append(ToRGB(ns[2 * i + 1], style_dim))

    def latent(self, z, inject_index):
        w0, w1 = (self.style(t) for t in z)
        pos = torch.arange(self.n_latent, device=w0.device)[None, :, None]
        return torch.where(pos < inject_index, w0[:, None], w1[:, None])

    def synthesis(self, latent, noise):
        noise = [n.permute(0, 3, 1, 2) for n in noise]
        x = self.input.input.expand(latent.shape[0], -1, -1, -1)
        x = self.conv1(x, latent[:, 0], noise[0])
        skip = self.to_rgb1(x, latent[:, 1])
        i = 1
        for p, rgb in enumerate(self.to_rgbs):
            x = self.convs[2 * p](x, latent[:, i], noise[2 * p + 1])
            x = self.convs[2 * p + 1](x, latent[:, i + 1], noise[2 * p + 2])
            skip = rgb(x, latent[:, i + 2], skip)
            i += 2
        return skip

    def forward(self, z, inject_index, noise):
        return self.synthesis(self.latent(z, inject_index), noise)

    def path_lengths(self, z, inject_index, noise, ppl_noise):
        """Per-sample ||J^T y|| with respect to W+, y = ppl_noise / sqrt(H W)
        (``ppl_noise`` NHWC), differentiable in the parameters."""
        latent = self.latent(z, inject_index)
        img = self.synthesis(latent, noise)
        y = ppl_noise.permute(0, 3, 1, 2) / math.sqrt(img.shape[2] * img.shape[3])
        (grad,) = torch.autograd.grad((img * y).sum(), latent, create_graph=True)
        return torch.sqrt(grad.square().sum(2).mean(1))


class Blur(nn.Module):
    def __init__(self, pad):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return ops.blur(x, self.pad)


class EqualConv2d(nn.Module):
    def __init__(self, in_ch, out_ch, k, stride=1, padding=0):
        super().__init__()
        self.weight = _empty(out_ch, in_ch, k, k)
        self.scale, self.stride, self.padding = 1 / math.sqrt(in_ch * k * k), stride, padding

    def forward(self, x):
        return ops.conv2d(x, self.weight * self.scale, stride=self.stride, padding=self.padding)


class BiasLeakyReLU(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.bias = _empty(ch)

    def forward(self, x):
        return ops.lrelu(x, self.bias)


class ConvLayer(nn.Sequential):
    def __init__(self, in_ch, out_ch, k, downsample=False, activate=True):
        layers = []
        if downsample:
            pb = 2 + (k - 1)
            layers.append(Blur(((pb + 1) // 2, pb // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, k // 2
        layers.append(EqualConv2d(in_ch, out_ch, k, stride, padding))
        if activate:
            layers.append(BiasLeakyReLU(out_ch))
        super().__init__(*layers)


class ResBlock(nn.Module):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


def minibatch_stddev(x, group=4):
    """StyleGAN2's minibatch stddev over the whole batch ``x`` (samples
    grouped with stride B // group), one feature appended."""
    b, c, h, w = x.shape
    g = min(b, group)
    y = x.reshape(g, b // g, 1, c, h, w)
    std = torch.sqrt(y.var(0, unbiased=False) + 1e-8).mean((2, 3, 4))  # [B//g, 1]
    std = std.repeat(g, 1)[:, :, None, None].expand(b, 1, h, w)
    return torch.cat([x, std], 1)


class Discriminator(nn.Module):
    """[B, 3, H, W] images -> scores [B, 1]."""

    def __init__(self, size, channel_multiplier=2):
        super().__init__()
        ch = channels(channel_multiplier)
        self.convs = nn.ModuleList([ConvLayer(3, ch[size], 1)])
        in_ch = ch[size]
        for i in range(int(math.log2(size)), 2, -1):
            self.convs.append(ResBlock(in_ch, ch[2 ** (i - 1)]))
            in_ch = ch[2 ** (i - 1)]
        self.final_conv = ConvLayer(in_ch + 1, ch[4], 3)
        self.final_linear = nn.Sequential(EqualLinear(ch[4] * 16, ch[4], activation=True),
                                          EqualLinear(ch[4], 1))

    def forward(self, img):
        x = img
        for conv in self.convs:
            x = conv(x)
        x = self.final_conv(minibatch_stddev(x))
        return self.final_linear(x.reshape(x.shape[0], -1))
