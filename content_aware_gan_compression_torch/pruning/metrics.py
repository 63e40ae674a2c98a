"""Channel-importance metrics (reference Util/pruning_metrics.py; the JAX
package's pruning/metrics.py).

Each metric takes an NCHW activation stack or an OIHW effective kernel, the
layouts the reference's formulas are written in, and returns one score per
channel as a tensor on the input's device.
"""

from __future__ import annotations

import torch


def asv_score(fea_maps: torch.Tensor) -> torch.Tensor:
    """Across-sample std (ddof 0), averaged spatially: [N, C, H, W] -> [C]
    (reference pruning_metrics.py:3-13)."""
    return torch.std(fea_maps, dim=0, correction=0).mean(dim=(1, 2))


def map_l1_norm(fea_maps: torch.Tensor) -> torch.Tensor:
    """Mean |activation| per channel (reference pruning_metrics.py:15-24)."""
    return fea_maps.abs().mean(dim=(0, 2, 3))


def map_l2_norm(fea_maps: torch.Tensor) -> torch.Tensor:
    """Root sum of squares per channel (reference pruning_metrics.py:26-35)."""
    return fea_maps.square().sum(dim=(0, 2, 3)).sqrt()


def l1_normalized_asv(fea_maps: torch.Tensor) -> torch.Tensor:
    """ASV / mean |x| (reference pruning_metrics.py:38-49)."""
    return asv_score(fea_maps) / map_l1_norm(fea_maps)


def l2_normalized_asv(fea_maps: torch.Tensor) -> torch.Tensor:
    """ASV / l2 norm (reference pruning_metrics.py:52-63)."""
    return asv_score(fea_maps) / map_l2_norm(fea_maps)


def outgoing_l1_norm(filter_4d: torch.Tensor) -> torch.Tensor:
    """L1 norm of each input channel's outgoing kernels: [O, I, H, W] -> [I]
    (reference pruning_metrics.py:66-78)."""
    return filter_4d.abs().sum(dim=(0, 2, 3))


def incoming_l1_norm(filter_4d: torch.Tensor) -> torch.Tensor:
    """L1 norm of each output channel's incoming kernels: [O, I, H, W] -> [O]
    (reference pruning_metrics.py:81-93)."""
    return filter_4d.abs().sum(dim=(1, 2, 3))
