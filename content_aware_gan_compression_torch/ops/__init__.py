"""Resampling and activation ops: plain PyTorch, with the two hot ones
(4x4 blur, StyledConv epilogue) on hand-written CUDA kernels (``ops/cuda``)."""

from .fused_act import fused_leaky_relu, fused_noise_bias_lrelu, scaled_leaky_relu
from .upfirdn2d import blur, downsample_2d, make_kernel, upfirdn2d, upsample_2d

__all__ = [
    "upfirdn2d",
    "make_kernel",
    "upsample_2d",
    "downsample_2d",
    "blur",
    "fused_leaky_relu",
    "scaled_leaky_relu",
    "fused_noise_bias_lrelu",
]
