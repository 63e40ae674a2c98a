"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper launches its kernel on a CUDA tensor and runs its plain PyTorch
version, kept in the same module, on a CPU tensor. ``<wrapper>.launches``
counts the kernel launches, so a run can show that its path went through
them. Kernels build at first use (``build.py``); the build raises if it fails.
"""

from .blur4 import blur4, blur4_plain, correlation_taps
from .fused_noise_bias_lrelu import fused_noise_bias_lrelu, fused_noise_bias_lrelu_plain

__all__ = ["blur4", "blur4_plain", "correlation_taps", "fused_noise_bias_lrelu",
           "fused_noise_bias_lrelu_plain"]
