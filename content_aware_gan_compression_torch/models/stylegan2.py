"""StyleGAN2 generator in PyTorch (reference model.py:398, Generator).

Module names mirror the JAX package's parameter tree, which mirrors the
reference state dict ('conv1.conv.weight', 'convs.3.activate.bias',
'noises.noise_4', ...), so a JAX tree or a reference checkpoint loads with
``strict=True``. FIR taps are not part of the state.

Activations are NHWC, as in the JAX package: a convolution takes
``x.permute(0, 3, 1, 2)``, a channels-last NCHW view, and returns a
channels-last result whose NHWC permute is contiguous again, so the kernels
between convolutions see contiguous NHWC tensors without a copy.

Modulated convolutions use the scale-input/scale-output form of the JAX
package: one shared convolution of ``x * s`` with the equalized weight, then
the demodulation ``rsqrt(scale^2 * (s^2 @ sum_kk W^2) + 1e-8)`` applied to
the output, instead of the reference's per-sample grouped convolutions.

Net widths are data: ``net_shape`` lists the per-layer channel counts, so a
pruned (non-uniform) generator is a config with another tuple.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import blur, fused_leaky_relu, fused_noise_bias_lrelu, make_kernel, upsample_2d
from ..utils.runtime import resolve_device

# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def default_channels(channel_multiplier: int = 2) -> dict[int, int]:
    """Per-resolution channel table (reference model.py:432-442)."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


def default_net_shape(size: int, channel_multiplier: int = 2) -> tuple[int, ...]:
    """Per-layer widths of the unpruned generator: [conv1_in, conv1_out,
    up_out, conv_out, up_out, conv_out, ...] (len == n_convs + 1)."""
    ch = default_channels(channel_multiplier)
    shape = [ch[4], ch[4]]
    for i in range(3, int(math.log2(size)) + 1):
        shape += [ch[2 ** i], ch[2 ** i]]
    return tuple(shape)


@dataclass(frozen=True)
class GeneratorConfig:
    """Generator architecture (the JAX package's GeneratorConfig)."""
    size: int
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    blur_kernel: tuple[int, ...] = (1, 3, 3, 1)
    lr_mlp: float = 0.01
    net_shape: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.net_shape is None:
            object.__setattr__(self, "net_shape",
                               default_net_shape(self.size, self.channel_multiplier))
        else:
            object.__setattr__(self, "net_shape", tuple(int(c) for c in self.net_shape))
        want = 2 * (self.log_size - 2) + 2
        if len(self.net_shape) != want:
            raise ValueError(
                f"net_shape has {len(self.net_shape)} entries but size="
                f"{self.size} needs n_convs+1 = {want}")

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def num_layers(self) -> int:
        """Number of noise-injection layers (reference model.py:460)."""
        return (self.log_size - 2) * 2 + 1

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    @property
    def n_convs(self) -> int:
        return self.num_layers


def net_shape_from_params(state_dict) -> tuple[int, ...]:
    """Per-layer widths read off the conv weights [1, out, in, k, k] of a flat
    state dict (reference Util/network_util.py:27-38)."""
    w1 = state_dict["conv1.conv.weight"]
    shape = [int(w1.shape[2]), int(w1.shape[1])]
    i = 0
    while f"convs.{i}.conv.weight" in state_dict:
        shape.append(int(state_dict[f"convs.{i}.conv.weight"].shape[1]))
        i += 1
    return tuple(shape)


def _to_nhwc(x_nchw: torch.Tensor) -> torch.Tensor:
    """NHWC view of a convolution's result; copies only if the convolution
    did not return channels-last memory."""
    return x_nchw.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class PixelNorm(nn.Module):
    """x * rsqrt(mean(x^2) + 1e-8) over the last axis (reference model.py:14-24)."""

    def forward(self, x):
        return x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """Equalized-lr linear (reference model.py:137-166); weight [out, in].
    ``lr_mul`` scales both the weight and the bias."""

    def __init__(self, in_dim, out_dim, *, bias_init=0.0, lr_mul=1.0, activation=None,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim, generator=generator) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class ModulatedConv2d(nn.Module):
    """Per-sample modulated conv in scale-input/scale-output form; weight
    [1, out, in, k, k] as in the reference. ``upsample`` runs the stride-2
    transposed conv and then the 4x4 blur (the blur4 kernel on the card)."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim, *, demodulate=True,
                 upsample=False, blur_kernel=(1, 3, 3, 1), generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(1, out_ch, in_ch, kernel_size, kernel_size, generator=generator))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0, generator=generator)
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.demodulate = demodulate
        self.upsample = upsample
        if upsample:
            # blur pads after the transposed conv (reference model.py:207-213)
            factor = 2
            p = (len(blur_kernel) - factor) - (kernel_size - 1)
            self.blur_pad = ((p + 1) // 2 + factor - 1, p // 2 + 1)
            # host taps: blur4 passes them to the kernel by value
            self.blur_taps = make_kernel(blur_kernel)

    def forward(self, x, style):
        w = self.weight[0]  # [out, in, k, k]
        k = w.shape[-1]
        s = self.modulation(style)  # [B, in]
        xs = (x * s[:, None, None, :]).permute(0, 3, 1, 2)  # channels-last view
        ws = w * self.scale
        if self.upsample:
            out = _to_nhwc(F.conv_transpose2d(xs, ws.transpose(0, 1), stride=2))
        else:
            out = _to_nhwc(F.conv2d(xs, ws, padding=k // 2))
        if self.demodulate:
            wsq = torch.sum(torch.square(w.float()), dim=(2, 3))  # [out, in]
            sigma = (self.scale * self.scale) * (torch.square(s.float()) @ wsq.T) + 1e-8
            out = out * torch.rsqrt(sigma).to(out.dtype)[:, None, None, :]
        if self.upsample:
            out = blur(out, self.blur_taps, pad=self.blur_pad, upsample_factor=2)
        return out


class NoiseInjection(nn.Module):
    """Holds the noise weight [1]; StyledConv applies it in the fused epilogue."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))


class FusedLeakyReLU(nn.Module):
    """Holds the activation bias [C]; StyledConv applies it in the fused epilogue."""

    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))


class StyledConv(nn.Module):
    """Modulated conv + noise injection + bias-LeakyReLU (reference
    model.py:323-367); the epilogue is one ``fused_noise_bias_lrelu``."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim, *, upsample=False,
                 blur_kernel=(1, 3, 3, 1), generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim, upsample=upsample,
                                    blur_kernel=blur_kernel, generator=generator)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)

    def forward(self, x, style, noise):
        """noise: [B or 1, H, W, 1] at the output resolution."""
        out = self.conv(x, style)
        return fused_noise_bias_lrelu(out, noise, self.activate.bias, self.noise.weight)


class ToRGB(nn.Module):
    """1x1 modulated conv (no demodulation) + bias + upsampled skip
    (reference model.py:370-395); bias [1, 3, 1, 1] as in the reference."""

    def __init__(self, in_ch, style_dim, *, blur_kernel=(1, 3, 3, 1), generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False,
                                    generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.register_buffer("kernel", make_kernel(blur_kernel), persistent=False)

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias.permute(0, 2, 3, 1)
        if skip is not None:
            out = out + upsample_2d(skip, self.kernel)
        return out


class ConstantInput(nn.Module):
    def __init__(self, channels, size=4, generator=None):
        super().__init__()
        self.input = nn.Parameter(torch.randn(1, channels, size, size, generator=generator))


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------


class Generator(nn.Module):
    """StyleGAN2 generator (the JAX package's generator_init/generator_apply).

    Parameters are drawn from the same distributions as ``generator_init``,
    from ``generator`` (a CPU ``torch.Generator``; the global RNG if None),
    and then moved to ``device``. ``device`` defaults to ``cuda`` and raises
    when no card is present; pass ``device="cpu"`` for the plain path.
    """

    def __init__(self, config: GeneratorConfig, *, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        ns, d, bk = config.net_shape, config.style_dim, config.blur_kernel
        g = generator

        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(d, d, lr_mul=config.lr_mlp, activation="fused_lrelu", generator=g)
            for _ in range(config.n_mlp)])
        self.input = ConstantInput(ns[0], generator=g)
        self.conv1 = StyledConv(ns[0], ns[1], 3, d, blur_kernel=bk, generator=g)
        self.to_rgb1 = ToRGB(ns[1], d, blur_kernel=bk, generator=g)
        self.noises = nn.Module()
        for layer_idx in range(config.num_layers):
            res = 2 ** ((layer_idx + 5) // 2)
            self.noises.register_buffer(f"noise_{layer_idx}",
                                        torch.randn(1, 1, res, res, generator=g))
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        for i in range(1, len(ns) // 2):
            self.convs.append(StyledConv(ns[2 * i - 1], ns[2 * i], 3, d, upsample=True,
                                         blur_kernel=bk, generator=g))
            self.convs.append(StyledConv(ns[2 * i], ns[2 * i + 1], 3, d,
                                         blur_kernel=bk, generator=g))
            self.to_rgbs.append(ToRGB(ns[2 * i + 1], d, blur_kernel=bk, generator=g))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.input.input.device

    # -- latents and noise --------------------------------------------------

    def get_latent(self, z):
        """z -> W (reference Generator.get_latent, model.py:542-543)."""
        return self.style(z)

    def mean_latent(self, n_latent: int, generator=None):
        """Mean W over ``n_latent`` z drawn from ``generator`` (on this
        module's device), shape [1, style_dim] (reference model.py:534-540)."""
        z = torch.randn(n_latent, self.config.style_dim, generator=generator, device=self.device)
        return self.get_latent(z).mean(0, keepdim=True)

    def make_noise(self, batch: int = 1, generator=None):
        """Per-layer NHWC noise maps [B, H, W, 1] (reference model.py:523-532)."""
        return [torch.randn(batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1,
                            generator=generator, device=self.device)
                for i in range(self.config.num_layers)]

    def _noise_buffers_nhwc(self):
        return [getattr(self.noises, f"noise_{i}").permute(0, 2, 3, 1)
                for i in range(self.config.num_layers)]

    # -- forward ------------------------------------------------------------

    def synthesis(self, latent, noise):
        """W+ latent [B, n_latent, D] + per-layer noise -> (NHWC image, list
        of per-scale NHWC rgb skips) (reference model.py:612-646)."""
        batch = latent.shape[0]
        # the one layout copy of the forward: the [1, C, 4, 4] constant to
        # NHWC (16*C floats), so that x * s below comes out NHWC-contiguous
        x = self.input.input.permute(0, 2, 3, 1).contiguous().expand(batch, -1, -1, -1)
        x = self.conv1(x, latent[:, 0], noise[0])
        skip = self.to_rgb1(x, latent[:, 1])
        rgb_list = [skip]
        i = 1
        for pair, to_rgb in enumerate(self.to_rgbs):
            x = self.convs[2 * pair](x, latent[:, i], noise[2 * pair + 1])
            x = self.convs[2 * pair + 1](x, latent[:, i + 1], noise[2 * pair + 2])
            skip = to_rgb(x, latent[:, i + 2], skip)
            rgb_list.append(skip)
            i += 2
        return skip, rgb_list

    def forward(self, styles, *, input_is_latent: bool = False, inject_index=None,
                truncation=1.0, truncation_latent=None, noise=None,
                randomize_noise: bool = True, generator=None,
                return_latents: bool = False, return_rgb_list: bool = False,
                return_style_scalars: bool = False, PPL_regularize: bool = False):
        """Generator forward (the JAX package's generator_apply).

        Args:
          styles: list of z [B, D] (1 or 2 entries; 2 -> style mixing), or of
            W when ``input_is_latent``; a single W+ tensor [B, n_latent, D]
            is also accepted then.
          inject_index: mixing point — int, tensor, or None (None with two
            styles draws it uniform in [1, n_latent-1] from ``generator``).
          noise: list of per-layer NHWC noise maps [B, H, W, 1]; if None and
            ``randomize_noise``, fresh noise is drawn from ``generator``; if
            None and not ``randomize_noise``, the ``noises.noise_*`` buffers.
          generator: a ``torch.Generator`` on this module's device.

        Returns NCHW images (a list per scale with ``return_rgb_list``), and
        the W+ latent with ``return_latents``.
        """
        if return_style_scalars or PPL_regularize:
            raise NotImplementedError(
                "return_style_scalars and PPL_regularize are not ported yet "
                "(pruning and training slices)")
        cfg = self.config
        if not input_is_latent:
            styles = [self.get_latent(z) for z in styles]
        elif not isinstance(styles, (list, tuple)):
            styles = [styles]

        if noise is None:
            if randomize_noise:
                if generator is None:
                    raise ValueError("randomize_noise=True requires generator")
                noise = self.make_noise(styles[0].shape[0], generator)
            else:
                noise = self._noise_buffers_nhwc()

        # truncation trick (reference model.py:583-591)
        if truncation is not None and not (
                isinstance(truncation, (int, float)) and truncation == 1):
            styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]

        # W -> W+ with style mixing (reference model.py:593-610)
        if len(styles) < 2:
            latent = styles[0]
            if latent.dim() < 3:
                latent = latent[:, None, :].expand(-1, cfg.n_latent, -1)
        else:
            if inject_index is None:
                if generator is None:
                    raise ValueError("two styles with inject_index=None requires generator")
                inject_index = torch.randint(1, cfg.n_latent, (), generator=generator,
                                             device=generator.device)
            pos = torch.arange(cfg.n_latent, device=styles[0].device)[None, :, None]
            latent = torch.where(pos < inject_index, styles[0][:, None, :],
                                 styles[1][:, None, :])

        image, rgb_list = self.synthesis(latent, noise)
        if return_rgb_list:
            out = [r.permute(0, 3, 1, 2) for r in rgb_list]
        else:
            out = image.permute(0, 3, 1, 2)
        if return_latents:
            return out, latent
        return out
