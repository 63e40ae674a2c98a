"""The inputs a cell feeds the system: real batches and each iteration's
random draws, made from the run's seed with the parameters of the cell's
traffic file, the same for the system under test and for the reference.

Draws follow StyleGAN2's training loop: two latent batches, style mixing
with probability ``mixing`` at a point uniform in [1, n_latent), per-layer
noise maps [B, H, W, 1] (NHWC, the system's layout), the teacher's own noise
maps, and every ``g_reg_every`` iterations the path-length batch with its
standard normal ``ppl_noise`` [B, H, W, 3]. A run over ranks draws the
global batch and hands each rank its contiguous rows.
"""

from __future__ import annotations

import torch

from .weights import sub_seed


def noise_sizes(size: int) -> list[int]:
    """The side of each noise map of a generator at ``size``."""
    n_layers = (size.bit_length() - 1 - 2) * 2 + 1
    return [2 ** ((i + 5) // 2) for i in range(n_layers)]


def real_pool(seed: int, count: int, batch: int, size: int, device) -> list[torch.Tensor]:
    """``count`` distinct uint8 [batch, size, size, 3] host batches, drawn on
    ``device`` and copied to host memory."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "real"))
    pool = torch.randint(0, 256, (count, batch, size, size, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    return list(pool.cpu().unbind(0))


class Draws:
    """Each iteration's draws from one ``torch.Generator`` on the device."""

    def __init__(self, seed: int, traffic: dict, config: dict, device):
        size = config["size"]
        self.gen = torch.Generator(device).manual_seed(sub_seed(seed, "draws"))
        self.t, self.size, self.style_dim, self.device = traffic, size, config["style_dim"], device
        self.n_latent = (size.bit_length() - 1) * 2 - 2
        self.sides = noise_sizes(size)

    def _mixing(self, batch):
        z = torch.randn(2, batch, self.style_dim, generator=self.gen, device=self.device)
        coin = torch.rand((), generator=self.gen, device=self.device) < self.t["mixing"]
        index = torch.randint(1, self.n_latent, (), generator=self.gen, device=self.device)
        return [z[0], z[1]], torch.where(coin, index, torch.full_like(index, self.n_latent))

    def _noise(self, batch):
        return [torch.randn(batch, s, s, 1, generator=self.gen, device=self.device)
                for s in self.sides]

    def iteration(self, i: int) -> dict:
        """The global draws of iteration ``i``: 'd', 'g' and, every
        ``g_reg_every``, 'g_reg'."""
        b = self.t["batch"]
        out = {}
        for phase in ("d", "g"):
            z, index = self._mixing(b)
            out[phase] = {"z": z, "inject_index": index, "noise": self._noise(b)}
        out["g"]["teacher_noise"] = self._noise(b)
        if i % self.t["g_reg_every"] == 0:
            pb = b // self.t["path_batch_shrink"]
            z, index = self._mixing(pb)
            out["g_reg"] = {"z": z, "inject_index": index, "noise": self._noise(pb),
                            "ppl_noise": torch.randn(pb, self.size, self.size, 3,
                                                     generator=self.gen, device=self.device)}
        return out


def rows(draws, rank: int, world: int):
    """A rank's contiguous rows of every batch tensor of ``draws`` (the
    mixing point is shared)."""
    if world == 1:
        return draws
    if isinstance(draws, dict):
        return {k: v if k == "inject_index" else rows(v, rank, world) for k, v in draws.items()}
    if isinstance(draws, list):
        return [rows(v, rank, world) for v in draws]
    k = draws.shape[0] // world
    return draws[rank * k:(rank + 1) * k]
