"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present.

    Entry points default to ``cuda`` and never fall back to the CPU on their
    own: the CPU runs only when the caller asks for it with ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch path")
    return device
