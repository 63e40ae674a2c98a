"""Weights drawn from a seed, on the device, in one call per network.

A network's tensors are named and shaped by a reference module built on the
``meta`` device; each tensor's (std, mean) comes from the network's init
rule. One flat standard normal of the network's whole size is drawn with a
``torch.Generator`` on the device and cut into the tensors, which are scaled
and shifted in place with two foreach calls. The same seed gives the same
tensors, and the same state dict is loaded into the system under test and
into the reference.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def meta_module(build):
    """``build()`` on the meta device: names and shapes, no memory."""
    with torch.device("meta"):
        return build()


def spec(module, rule) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, std, mean) of every tensor of ``module``'s state dict."""
    return [(k, tuple(v.shape), *rule(k, tuple(v.shape)))
            for k, v in module.state_dict().items()]


def draw(tensors: list, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of ``spec``'s tensors drawn from ``seed`` on
    ``device``, float32."""
    device = torch.device(device)
    sizes = [max(1, int(torch.Size(s).numel())) for _, s, _, _ in tensors]
    gen = torch.Generator(device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    parts = [p.view(s) for p, (_, s, _, _) in zip(flat.split(sizes), tensors)]
    torch._foreach_mul_(parts, [std for _, _, std, _ in tensors])
    torch._foreach_add_(parts, [mean for _, _, _, mean in tensors])
    return {name: p for (name, _, _, _), p in zip(tensors, parts)}


def materialize(build, rule, seed: int, device):
    """The reference module ``build()`` with its tensors drawn from ``seed``
    on ``device``; returns (module, state dict)."""
    module = meta_module(build)
    state = draw(spec(module, rule), seed, device)
    module.load_state_dict(state, assign=True)
    return module, state
