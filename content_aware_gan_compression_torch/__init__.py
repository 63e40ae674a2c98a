"""Content-Aware GAN Compression in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (H100).

A port of ``content_aware_gan_compression_tpu`` (JAX), which stays the
reference: module names match, so each module's counterpart is found under
the same path. This package imports neither JAX nor the JAX package.

Ported so far: the generator and ``generate``; the discriminator, the
losses, the four training steps and the ``Trainer`` with its CLI
(``python -m content_aware_gan_compression_torch.train``), with the
reference's default objective: content-aware KD (BiSeNet's parse of the
teacher masks both images) plus LPIPS-VGG16; FID (the FID InceptionV3) and
PPL, in the loop and from their CLIs (``calc_inception``, ``get_fid``,
``get_ppl``); channel pruning, content-aware and by the 8 baseline metrics,
with its CLI (``prune``); the GAN-Slimming sparsity baseline with
in-training pruning (``train_sparsity``); the image projector with optax's
L-BFGS or Adam (``get_projected_image``); the FLOPs calculators and the log
analysis; bf16 compute for retraining (``--dtype bfloat16``) with bf16
forms of the three kernels, and the retraining benchmark (``bench``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
