"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper launches its kernel on a CUDA tensor and runs its plain PyTorch
version, kept in the same module, on a CPU tensor. Each is differentiable
through a ``torch.autograd.Function`` whose backward is a kernel too, the same
on both devices, so gradients of any order stay on the kernels.

Launch counts, so a run can show that its path went through the kernels:
``blur4.launches`` (forward) and ``blur4.backward_launches`` (made by
autograd's backward), ``fused_noise_bias_lrelu.launches`` and
``masked_scale.launches`` (the epilogue's backward, of any order).
``blur4.grad_copies`` and ``masked_scale.grad_copies`` count gradients that
arrived non-contiguous and were copied before a launch. Kernels build at
first use (``build.py``); the build raises if it fails.
"""

from .blur4 import Blur4Fn, blur4, blur4_plain, correlation_taps
from .fused_noise_bias_lrelu import (
    FusedNoiseBiasLReLUFn, fused_noise_bias_lrelu, fused_noise_bias_lrelu_plain)
from .masked_scale import MaskedScaleFn, masked_scale, masked_scale_plain


def reset_counts() -> None:
    """Set every launch and copy count to 0."""
    blur4.launches = blur4.backward_launches = blur4.grad_copies = 0
    fused_noise_bias_lrelu.launches = 0
    masked_scale.launches = masked_scale.grad_copies = 0


def counts() -> dict[str, int]:
    """Every launch and copy count, by name."""
    return {"blur4": blur4.launches, "blur4_backward": blur4.backward_launches,
            "fused_noise_bias_lrelu": fused_noise_bias_lrelu.launches,
            "masked_scale": masked_scale.launches,
            "blur4_grad_copies": blur4.grad_copies,
            "masked_scale_grad_copies": masked_scale.grad_copies}


__all__ = ["Blur4Fn", "blur4", "blur4_plain", "correlation_taps", "FusedNoiseBiasLReLUFn",
           "fused_noise_bias_lrelu", "fused_noise_bias_lrelu_plain", "MaskedScaleFn",
           "masked_scale", "masked_scale_plain", "reset_counts", "counts"]
