"""StyleGAN2 generator and discriminator in PyTorch (reference model.py:398,
Generator, and model.py:744, Discriminator).

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

``dtype`` (``Generator.forward``, ``Discriminator.forward``) is the compute
type of the activations, e.g. ``torch.bfloat16``, at the JAX package's cast
points: parameters stay float32 and each layer casts its weights to the
activations' type where it uses them; demodulation's sigma is computed in
float32 and cast. None keeps the input's type.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import parallel
from ..ops import blur, fused_leaky_relu, fused_noise_bias_lrelu, make_kernel, upsample_2d
from ..utils.runtime import resolve_device

def checkpointed(fn, remat: bool, *args):
    """``fn(*args)``, under activation checkpointing when ``remat`` and
    gradients are being recorded: ``torch.utils.checkpoint`` in its
    non-reentrant form, the one that supports ``autograd.grad``,
    ``backward(inputs=...)`` and the grad of grad of R1 and path length.
    ``fn`` draws nothing at random, so no RNG state is stashed."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


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
        out = F.linear(x, (self.weight * self.scale).to(x.dtype))
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + (self.bias * self.lr_mul).to(out.dtype)


class ModulatedConv2d(nn.Module):
    """Per-sample modulated conv in scale-input/scale-output form; weight
    [1, out, in, k, k] as in the reference. ``upsample`` runs the stride-2
    transposed conv and then the 4x4 blur (the blur4 kernel on the card).
    ``downsample`` blurs the modulated input (blur4, pads ((4-2)+(k-1)+1)//2
    and ((4-2)+(k-1))//2) and then runs the stride-2 conv without padding
    (reference model.py:214-222; the JAX package's ``down`` branch); no
    network of either package calls it."""

    def __init__(self, in_ch, out_ch, kernel_size, style_dim, *, demodulate=True,
                 upsample=False, downsample=False, blur_kernel=(1, 3, 3, 1), generator=None):
        super().__init__()
        if upsample and downsample:
            raise ValueError("a modulated conv upsamples or downsamples, not both")
        self.weight = nn.Parameter(
            torch.randn(1, out_ch, in_ch, kernel_size, kernel_size, generator=generator))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0, generator=generator)
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.demodulate = demodulate
        self.upsample = upsample
        self.downsample = downsample
        factor = 2
        if upsample:
            # blur pads after the transposed conv (reference model.py:207-213)
            p = (len(blur_kernel) - factor) - (kernel_size - 1)
            self.blur_pad = ((p + 1) // 2 + factor - 1, p // 2 + 1)
        if downsample:
            # blur pads before the stride-2 conv (reference model.py:214-218)
            p = (len(blur_kernel) - factor) + (kernel_size - 1)
            self.blur_pad = ((p + 1) // 2, p // 2)
        if upsample or downsample:
            # host taps: blur4 passes them to the kernel by value
            self.blur_taps = make_kernel(blur_kernel)

    def forward(self, x, style):
        """Returns (the output, the modulation scalars ``s`` [B, in])."""
        w = self.weight[0]  # [out, in, k, k]
        k = w.shape[-1]
        s = self.modulation(style)  # [B, in]
        xs = x * s[:, None, None, :].to(x.dtype)
        ws = (w * self.scale).to(x.dtype)
        if self.upsample:
            out = _to_nhwc(F.conv_transpose2d(xs.permute(0, 3, 1, 2), ws.transpose(0, 1),
                                              stride=2))
        elif self.downsample:
            xs = blur(xs, self.blur_taps, pad=self.blur_pad)
            out = _to_nhwc(F.conv2d(xs.permute(0, 3, 1, 2), ws, stride=2))
        else:
            out = _to_nhwc(F.conv2d(xs.permute(0, 3, 1, 2), ws, padding=k // 2))
        if self.demodulate:
            wsq = torch.sum(torch.square(w.float()), dim=(2, 3))  # [out, in]
            sigma = (self.scale * self.scale) * (torch.square(s.float()) @ wsq.T) + 1e-8
            out = out * torch.rsqrt(sigma).to(out.dtype)[:, None, None, :]
        if self.upsample:
            out = blur(out, self.blur_taps, pad=self.blur_pad, upsample_factor=2)
        return out, s


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
        """noise: [B or 1, H, W, 1] at the output resolution. Returns (the
        output, the modulation scalars [B, in]). The noise, bias and noise
        weight are cast to the output's type."""
        out, s = self.conv(x, style)
        return fused_noise_bias_lrelu(out, noise.to(out.dtype), self.activate.bias.to(out.dtype),
                                      self.noise.weight.to(out.dtype)), s


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
        """Returns (the output, the modulation scalars [B, in])."""
        out, s = self.conv(x, style)
        out = out + self.bias.permute(0, 2, 3, 1).to(out.dtype)
        if skip is not None:
            out = out + upsample_2d(skip, self.kernel)
        return out, s


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

    def get_latent(self, z, dtype=None):
        """z -> W (reference Generator.get_latent, model.py:542-543), the
        mapping MLP in ``dtype`` (z's type if None)."""
        return self.style(z if dtype is None else z.to(dtype))

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

    # -- what the pruning metrics read ----------------------------------------

    def scored_convs(self):
        """The modulated convs whose input channels the pruning metrics
        score: ``[conv1] + convs + [to_rgbs[-1]]``."""
        return [self.conv1.conv, *[c.conv for c in self.convs], self.to_rgbs[-1].conv]

    def feature_maps(self, z, noise=None, generator=None):
        """Per-layer NHWC activations ``[const input, conv1 out, convs.0 out,
        ...]``, ``len(net_shape)`` maps (the JAX package's
        generator_feature_maps, which returns them NCHW; reference
        Util/network_util.py:54-87). One W, not W+, conditions every layer;
        ``noise`` is drawn from ``generator`` when not given."""
        w = self.get_latent(z)
        if noise is None:
            if generator is None:
                raise ValueError("feature_maps needs noise or a generator")
            noise = self.make_noise(z.shape[0], generator)
        x = self.input.input.permute(0, 2, 3, 1).contiguous().expand(z.shape[0], -1, -1, -1)
        outs = [x]
        x, _ = self.conv1(x, w, noise[0])
        outs.append(x)
        for i, conv in enumerate(self.convs):
            x, _ = conv(x, w, noise[i + 1])
            outs.append(x)
        return outs

    def modulation_styles(self, z):
        """The modulation scalars ``s = A(W)`` [N, in] of each of
        ``scored_convs()`` (the JAX package's generator_modulation_styles;
        reference Util/network_util.py:168-198)."""
        w = self.get_latent(z)
        return [conv.modulation(w) for conv in self.scored_convs()]

    def effective_weight_means(self, z):
        """The batch mean [O, I, k, k] of each of ``scored_convs()``'s
        (de)modulated kernels (the JAX package's
        generator_effective_weight_means). A sample's kernel is ``scale * W *
        s[i] * d[o]``, a rank-1 modulation of the shared kernel, so the mean
        is ``scale * W`` times the [O, I] mean of ``d[o] s[i]``; no per-sample
        kernel is made. ToRGB never demodulates (reference model.py:377)."""
        outs = []
        for conv, s in zip(self.scored_convs(), self.modulation_styles(z)):
            w = conv.weight[0].float()  # [O, I, k, k]
            o, i = w.shape[:2]
            s = s.float()
            if conv.demodulate:
                wsq = torch.sum(torch.square(w), dim=(2, 3))  # [O, I]
                d = torch.rsqrt((conv.scale * conv.scale) * (torch.square(s) @ wsq.T) + 1e-8)
                m = torch.einsum("no,ni->oi", d, s) / s.shape[0]
            else:
                m = s.mean(0)[None, :].expand(o, i)
            outs.append(conv.scale * w * m[:, :, None, None])
        return outs

    # -- forward ------------------------------------------------------------

    def _block(self, pair, x, skip, lat0, lat1, lat2, n0, n1):
        """Resolution block ``pair``: the up StyledConv, the StyledConv and
        the ToRGB with its skip. Returns (x, skip, the two StyledConvs'
        modulation scalars, the ToRGB's)."""
        x, s0 = self.convs[2 * pair](x, lat0, n0)
        x, s1 = self.convs[2 * pair + 1](x, lat1, n1)
        skip, s2 = self.to_rgbs[pair](x, lat2, skip)
        return x, skip, s0, s1, s2

    def synthesis(self, latent, noise, dtype=None, remat=False):
        """W+ latent [B, n_latent, D] + per-layer noise -> (NHWC image, list
        of per-scale NHWC rgb skips, list of modulation scalars) (reference
        model.py:612-646). The scalars [B, in] are those of conv1, of every
        StyledConv and of the last ToRGB only (reference model.py:637-639;
        the JAX package's ``last_rgb_scalars``). ``dtype`` casts the
        constant input and the latent.

        ``remat`` checkpoints each resolution block (the JAX package's
        ``jax.checkpoint`` of ``_synthesis``'s block): its activations are
        not kept for the backward but recomputed there, about a third more
        work. ``conv1`` and ``to_rgb1`` stay outside. The math is the same:
        a block draws nothing at random and issues no collective, so its
        replay gives the same values."""
        batch = latent.shape[0]
        # the one layout copy of the forward: the [1, C, 4, 4] constant to
        # NHWC (16*C floats), so that x * s below comes out NHWC-contiguous
        x = self.input.input.permute(0, 2, 3, 1).contiguous()
        if dtype is not None:
            x, latent = x.to(dtype), latent.to(dtype)
        x = x.expand(batch, -1, -1, -1)
        x, s = self.conv1(x, latent[:, 0], noise[0])
        styles = [s]
        skip, _ = self.to_rgb1(x, latent[:, 1])
        rgb_list = [skip]
        i = 1
        for pair in range(len(self.to_rgbs)):
            args = (pair, x, skip, latent[:, i], latent[:, i + 1], latent[:, i + 2],
                    noise[2 * pair + 1], noise[2 * pair + 2])
            x, skip, s0, s1, s2 = checkpointed(self._block, remat, *args)
            styles += [s0, s1]
            if pair == len(self.to_rgbs) - 1:
                styles.append(s2)
            rgb_list.append(skip)
            i += 2
        return skip, rgb_list, styles

    def forward(self, styles, *, input_is_latent: bool = False, inject_index=None,
                truncation=1.0, truncation_latent=None, noise=None,
                randomize_noise: bool = True, generator=None,
                return_latents: bool = False, return_rgb_list: bool = False,
                return_style_scalars: bool = False, PPL_regularize: bool = False,
                ppl_noise=None, output_format: str = "NCHW", dtype=None, remat: bool = False):
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
          PPL_regularize: return ``(image, path_lengths)``, where
            ``path_lengths`` [B] is the per-sample ``||J^T y||`` of the
            synthesis with respect to the W+ latent (the JAX package's
            generator_apply, reference model.py:661-666), differentiable in
            the parameters. ``y = ppl_noise / sqrt(H*W)`` on the NHWC image;
            ``ppl_noise`` [B, H, W, 3] is a standard normal draw, taken from
            ``generator`` when not given.
          output_format: "NCHW" (the reference's) or "NHWC", the synthesis's
            own layout, which the discriminator and the losses take as it is.
          dtype: the compute type of the activations (e.g. torch.bfloat16):
            the mapping MLP, the noise maps, ``y`` and the synthesis run in
            it; the path lengths are computed in float32. None keeps
            float32.
          remat: checkpoint the synthesis's resolution blocks (``synthesis``),
            the JAX package's ``remat``: the same values, less activation
            memory, the blocks' forward replayed in the backward.

        Returns images (a list per scale with ``return_rgb_list``), as
        ``(images, styles)`` with ``return_style_scalars`` (the modulation
        scalars of conv1, every StyledConv and the last ToRGB, each [B, in]),
        and with the W+ latent appended with ``return_latents``.
        """
        if output_format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown output_format {output_format!r}")
        to_out = ((lambda t: t) if output_format == "NHWC"
                  else (lambda t: t.permute(0, 3, 1, 2)))
        cfg = self.config
        if not input_is_latent:
            styles = [self.get_latent(z, dtype) for z in styles]
        elif not isinstance(styles, (list, tuple)):
            styles = [styles]

        if noise is None:
            if randomize_noise:
                if generator is None:
                    raise ValueError("randomize_noise=True requires generator")
                noise = self.make_noise(styles[0].shape[0], generator)
            else:
                noise = self._noise_buffers_nhwc()
        if dtype is not None:
            noise = [n.to(dtype) for n in noise]

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

        if PPL_regularize:
            if not latent.requires_grad:  # W given as a plain tensor
                latent = latent.detach().requires_grad_(True)
            image, _, _ = self.synthesis(latent, noise, dtype, remat)
            if ppl_noise is None:
                if generator is None:
                    raise ValueError("PPL_regularize without ppl_noise requires generator")
                ppl_noise = torch.randn(image.shape, generator=generator, device=image.device)
            y = ppl_noise.to(image.dtype) / math.sqrt(image.shape[1] * image.shape[2])
            (grad,) = torch.autograd.grad(image, latent, y, create_graph=True)
            path_lengths = torch.sqrt(torch.square(grad.float()).sum(2).mean(1))
            return to_out(image), path_lengths

        image, rgb_list, styles = self.synthesis(latent, noise, dtype, remat)
        if return_rgb_list:
            out = [to_out(r) for r in rgb_list]
        else:
            out = to_out(image)
        if return_style_scalars:
            out = (out, styles)
        if return_latents:
            return out, latent
        return out


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Discriminator architecture (the JAX package's DiscriminatorConfig).
    ``channel_max`` clamps the per-resolution channel table; 512 is the
    reference table."""
    size: int
    channel_multiplier: int = 2
    blur_kernel: tuple[int, ...] = (1, 3, 3, 1)
    stddev_group: int = 4
    stddev_feat: int = 1
    channel_max: int = 512

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    def channels(self) -> dict[int, int]:
        return {k: min(v, self.channel_max)
                for k, v in default_channels(self.channel_multiplier).items()}


class Blur(nn.Module):
    """The parameter-free 4x4 FIR blur before a stride-2 conv (the blur4
    kernel on the card); index 0 of a downsampling ConvLayer."""

    def __init__(self, blur_kernel, pad):
        super().__init__()
        self.taps = make_kernel(blur_kernel)  # host taps, not state
        self.pad = pad

    def forward(self, x):
        return blur(x, self.taps, pad=self.pad)


class EqualConv2d(nn.Module):
    """Equalized-lr conv on NHWC activations (reference model.py:99-128);
    weight [out, in, k, k]. No bias: in a ConvLayer the activation holds it."""

    def __init__(self, in_ch, out_ch, kernel_size, *, stride=1, padding=0, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(out_ch, in_ch, kernel_size, kernel_size, generator=generator))
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return _to_nhwc(F.conv2d(x.permute(0, 3, 1, 2), (self.weight * self.scale).to(x.dtype),
                                 stride=self.stride, padding=self.padding))


class BiasLeakyReLU(nn.Module):
    """Holds a ConvLayer's activation bias [C]; applies fused_leaky_relu."""

    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class ConvLayer(nn.Sequential):
    """ConvLayer (reference model.py:670-716; the JAX package's _conv_layer).
    Indices follow the reference Sequential, so the JAX tree's keys load as
    they are: with ``downsample`` the blur is index 0, the stride-2 conv 1
    and the activation 2; without, the conv is 0 and the activation 1. The
    discriminator uses two forms: activated with a bias, and (the skip) with
    neither."""

    def __init__(self, in_ch, out_ch, kernel_size, *, downsample=False, bias=True,
                 activate=True, blur_kernel=(1, 3, 3, 1), generator=None):
        if activate != bias:
            raise ValueError("ConvLayer takes activate and bias together or neither")
        layers = []
        if downsample:
            pb = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, ((pb + 1) // 2, pb // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                                  generator=generator))
        if activate:
            layers.append(BiasLeakyReLU(out_ch))
        super().__init__(*layers)


class ResBlock(nn.Module):
    """Reference model.py:719-741; the JAX package's _res_block."""

    def __init__(self, in_ch, out_ch, blur_kernel=(1, 3, 3, 1), generator=None):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, blur_kernel=blur_kernel, generator=generator)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, blur_kernel=blur_kernel,
                               generator=generator)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, activate=False, bias=False,
                              blur_kernel=blur_kernel, generator=generator)

    def forward(self, x):
        # the sum and the scale in float32 at least, rounded once (as in
        # fused_leaky_relu: XLA's fusion of the JAX package's bfloat16 chain)
        out = self.conv2(self.conv1(x))
        acc = torch.promote_types(out.dtype, torch.float32)
        return ((out.to(acc) + self.skip(x).to(acc)) / math.sqrt(2)).to(out.dtype)


def minibatch_stddev(x_nhwc, group_size: int, stddev_feat: int):
    """Minibatch stddev feature (reference model.py:780-791). Samples are
    grouped with stride B//group (a view(group, -1, ...) over dim 0); the
    biased std across each group, averaged over H, W and C//feat, is appended
    as ``stddev_feat`` constant channels.

    With a process group up, B is the global batch, as on the JAX package's
    mesh: the ranks' rows are gathered (``parallel.gather_rows``), grouped
    as one batch, and each rank keeps the features of its own rows."""
    xg = parallel.gather_rows(x_nhwc)
    b, h, w, c = xg.shape
    group = min(b, group_size)
    m = b // group
    y = xg.reshape(group, m, h, w, stddev_feat, c // stddev_feat).float()
    std = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)  # [m, H, W, feat, C/feat]
    std = std.mean(dim=(1, 2, 4))  # [m, feat]
    # sample g*m + j takes std[j] (the reference's .repeat(group, 1, H, W))
    std = parallel.shard_rows(std.repeat(group, 1))
    std = std[:, None, None, :].expand(x_nhwc.shape[0], h, w, stddev_feat)
    return torch.cat([x_nhwc, std.to(x_nhwc.dtype)], dim=-1)


class Discriminator(nn.Module):
    """StyleGAN2 discriminator (the JAX package's discriminator_init and
    discriminator_apply, unpacked form). Takes NHWC images; activations stay
    NHWC, each convolution taking a channels-last view as in the generator.
    Weights come from ``generator`` (a CPU ``torch.Generator``) and move to
    ``device``, which defaults to ``cuda``."""

    def __init__(self, config: DiscriminatorConfig, *, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        ch, bk, g = config.channels(), config.blur_kernel, generator
        self.convs = nn.ModuleList([ConvLayer(3, ch[config.size], 1, blur_kernel=bk,
                                              generator=g)])
        in_ch = ch[config.size]
        for i in range(config.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            self.convs.append(ResBlock(in_ch, out_ch, bk, generator=g))
            in_ch = out_ch
        self.final_conv = ConvLayer(in_ch + config.stddev_feat, ch[4], 3, blur_kernel=bk,
                                    generator=g)
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, ch[4], activation="fused_lrelu", generator=g),
            EqualLinear(ch[4], 1, generator=g))
        self.to(device)

    def forward(self, image_nhwc, dtype=None, remat=False):
        """[B, H, W, 3] -> scores [B, 1], computed in ``dtype`` (the image's
        type if None). ``remat`` checkpoints each ResBlock, as the JAX
        package's ``discriminator_apply(remat=True)``. Under R1's grad of
        grad (``autograd.grad(create_graph=True)``) the replayed blocks'
        graphs are kept for the second order, so there remat frees nothing,
        unlike JAX's. ``convs[0]``, the minibatch stddev (a collective under
        data parallel) and the final layers stay outside."""
        x = image_nhwc if dtype is None else image_nhwc.to(dtype)
        x = self.convs[0](x)
        for block in self.convs[1:]:
            x = checkpointed(block, remat, x)
        x = minibatch_stddev(x, self.config.stddev_group, self.config.stddev_feat)
        x = self.final_conv(x)
        # flatten in NCHW order, so final_linear matches reference checkpoints
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return self.final_linear(x)


def discriminator_config_from_params(state_dict, size: int,
                                     channel_multiplier: int = 2) -> DiscriminatorConfig:
    """The config of a discriminator state dict: its channel clamp is the
    widest layer it holds, as in every table ``DiscriminatorConfig`` makes."""
    widest = max(int(v.shape[0]) for k, v in state_dict.items()
                 if k.endswith("weight") and v.dim() == 4)
    return DiscriminatorConfig(size=size, channel_multiplier=channel_multiplier,
                               channel_max=widest)
