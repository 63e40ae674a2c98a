"""Fused bias + LeakyReLU + gain (reference op/fused_act.py semantics), and
the StyledConv epilogue that adds noise injection to it.

``fused_leaky_relu`` and ``scaled_leaky_relu`` are plain PyTorch, and
autograd differentiates them. ``fused_noise_bias_lrelu`` is the hand-written
CUDA kernel on a CUDA tensor and its plain version on a CPU tensor, with the
``masked_scale`` kernel as its backward and double backward
(``ops/cuda/fused_noise_bias_lrelu.py``).
"""

from __future__ import annotations

import math

import torch

from .cuda import fused_noise_bias_lrelu


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor | None = None,
                     negative_slope: float = 0.2, scale: float = math.sqrt(2.0),
                     channel_axis: int = -1) -> torch.Tensor:
    """(x + bias) -> LeakyReLU(negative_slope) -> * scale.

    ``channel_axis`` is the axis the 1-D bias broadcasts over (-1 for NHWC
    maps and [B, D] vectors, 1 for NCHW)."""
    if bias is not None:
        shape = [1] * x.dim()
        shape[channel_axis] = bias.shape[0]
        x = x + bias.reshape(shape)
    return torch.where(x >= 0, x, x * negative_slope) * scale


def scaled_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU * sqrt(2) without bias (reference model.py:174-183)."""
    return torch.where(x >= 0, x, x * negative_slope) * math.sqrt(2.0)


__all__ = ["fused_leaky_relu", "scaled_leaky_relu", "fused_noise_bias_lrelu"]
