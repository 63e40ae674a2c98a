"""Content-Aware GAN Compression in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (H100).

A port of ``content_aware_gan_compression_tpu`` (JAX), which stays the
reference: module names match, so each module's counterpart is found under
the same path. This package imports neither JAX nor the JAX package.

Ported so far: the generator forward and ``generate``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
