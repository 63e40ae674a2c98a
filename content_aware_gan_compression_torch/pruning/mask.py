"""Checkpoint surgery: a generator state dict sliced down to a pruned one
(reference Util/mask_util.py:11-48; the JAX package's pruning/mask.py), as
flat state-dict slicing, the reference's own form:

  * input.input                  [1, C, 4, 4]        channels by mask[0]
  * <conv>.conv.weight           [1, out, in, k, k]  out by mask[i+1], in by mask[i]
  * <conv>.conv.modulation.*     [in, style] / [in]  by mask[i]
  * <conv>.activate.bias         [out]               by mask[i+1]
  * to_rgb head j (to_rgb1, to_rgbs.0, ...), fed by layer 2j+1:
      conv.weight [1, 3, in, 1, 1] in by mask[2j+1]; modulation by mask[2j+1]

where <conv> is conv1, convs.0, convs.1, ... (layer i). Everything else
(noise weights, ``noises.noise_*``, the ToRGB biases, the style MLP) is
copied as it is. The result loads into ``Generator`` through
``net_shape_from_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.checkpoint import state_dict_from_jax


def _conv_prefixes(sd):
    prefixes = ["conv1"]
    while f"convs.{len(prefixes) - 1}.conv.weight" in sd:
        prefixes.append(f"convs.{len(prefixes) - 1}")
    return prefixes


def _rgb_prefixes(sd):
    prefixes = ["to_rgb1"]
    while f"to_rgbs.{len(prefixes) - 1}.conv.weight" in sd:
        prefixes.append(f"to_rgbs.{len(prefixes) - 1}")
    return prefixes


def mask_the_generator(state_dict, net_mask_list) -> dict[str, torch.Tensor]:
    """The pruned generator's flat state dict.

    Args:
      state_dict: a generator state dict (flat or nested, tensors or arrays;
        FIR buffers are dropped).
      net_mask_list: per-layer boolean keep-masks, ``len == n_convs + 1``
        (mask[0]: the constant input and conv1's inputs; mask[i+1]: layer
        i's outputs).
    """
    sd = state_dict_from_jax(state_dict)
    convs = _conv_prefixes(sd)
    if len(net_mask_list) != len(convs) + 1:
        raise ValueError(f"need {len(convs) + 1} masks (n_convs + 1), got {len(net_mask_list)}")
    masks = [torch.from_numpy(np.asarray(m, dtype=bool)) for m in net_mask_list]

    def keep(t, mask, dim):
        return t.index_select(dim, mask.nonzero()[:, 0].to(t.device))

    out = dict(sd)
    out["input.input"] = keep(sd["input.input"], masks[0], 1)
    for i, p in enumerate(convs):
        in_m, out_m = masks[i], masks[i + 1]
        out[f"{p}.conv.weight"] = keep(keep(sd[f"{p}.conv.weight"], out_m, 1), in_m, 2)
        out[f"{p}.conv.modulation.weight"] = keep(sd[f"{p}.conv.modulation.weight"], in_m, 0)
        out[f"{p}.conv.modulation.bias"] = keep(sd[f"{p}.conv.modulation.bias"], in_m, 0)
        out[f"{p}.activate.bias"] = keep(sd[f"{p}.activate.bias"], out_m, 0)
    for j, p in enumerate(_rgb_prefixes(sd)):
        m = masks[2 * j + 1]
        out[f"{p}.conv.weight"] = keep(sd[f"{p}.conv.weight"], m, 2)
        out[f"{p}.conv.modulation.weight"] = keep(sd[f"{p}.conv.modulation.weight"], m, 0)
        out[f"{p}.conv.modulation.bias"] = keep(sd[f"{p}.conv.modulation.bias"], m, 0)
    return out
