"""Perceptual Path Length (the JAX package's evaluation/ppl.py; reference
Evaluation/ppl.py).

The library path's semantics: W-space lerp pairs at distance eps, LPIPS-VGG
between the two images of each pair, the mean of the distances between the
1st and 99th percentiles, and, as the reference's library path (ppl.py:114;
its ``__main__`` divides), no division by eps^2 unless asked for.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def normalize(x):
    return x / torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))


def lerp(a, b, t):
    return a + (b - a) * t


def slerp(a, b, t):
    """Spherical interpolation (reference ppl.py:17-25)."""
    a, b = normalize(a), normalize(b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    p = t * torch.arccos(d)
    c = normalize(b - d * a)
    return normalize(a * torch.cos(p) + c * torch.sin(p))


def _ppl_batch(g, lpips, z, lerp_t, eps, *, noise=None, generator=None):
    """One PPL batch (reference ppl.py:33-70, 100-115): 2B z -> W, pairs
    lerped at t and t + eps and interleaved, the generator on W
    (``input_is_latent``), a bilinear pool to 256 without antialias above
    256px, LPIPS between the two images of each pair. ``noise`` is a list of
    per-layer NHWC maps for the 2B images, or None to draw them from
    ``generator``. Returns the B distances."""
    with torch.inference_mode():
        latent = g.get_latent(z)  # [2B, D]
        t0, t1 = latent[::2], latent[1::2]
        e0 = lerp(t0, t1, lerp_t[:, None])
        e1 = lerp(t0, t1, lerp_t[:, None] + eps)
        latent_e = torch.stack([e0, e1], 1).reshape(latent.shape)
        image = g([latent_e], input_is_latent=True, noise=noise, generator=generator)
        if image.shape[2] // 256 > 1:
            image = F.interpolate(image, size=(256, 256), mode="bilinear", align_corners=False,
                                  antialias=False)
        return lpips(image[::2], image[1::2]).reshape(-1)


def get_ppl_score(g, lpips, *, n_sample=5000, batch_size=64, eps=1e-4, generator=None,
                  divide_eps_sq=False, info_print=False, return_distances=False):
    """PPL over ``n_sample`` pairs (reference Get_PPL_Score, ppl.py:74-128).
    Each batch draws its 2B z, its B lerp positions and its noise maps from
    ``generator`` (a ``torch.Generator`` on the generator's device). With
    ``return_distances``, also the raw distances before the filter."""
    generator = (generator if generator is not None
                 else torch.Generator(g.device).manual_seed(0))
    n_batch = n_sample // batch_size
    resid = n_sample - n_batch * batch_size
    # A residual batch runs at full size and keeps its first `resid`
    # distances, so the count equals n_sample (the reference appends a
    # full-size batch and overshoots, ppl.py:84-91; equal at 5000/50).
    distances = []
    total = n_batch + (1 if resid else 0)
    for idx in range(total):
        z = torch.randn(batch_size * 2, g.config.style_dim, generator=generator, device=g.device)
        lerp_t = torch.rand(batch_size, generator=generator, device=g.device)
        if info_print:
            print(f"PPL batch {idx + 1}/{total}")
        d = _ppl_batch(g, lpips, z, lerp_t, eps, generator=generator)
        if divide_eps_sq:
            d = d / (eps ** 2)
        distances.append(d[:resid] if idx == n_batch else d)

    distances = torch.cat(distances).cpu().numpy()
    lo = np.percentile(distances, 1, method="lower")
    hi = np.percentile(distances, 99, method="higher")
    score = float(distances[(distances >= lo) & (distances <= hi)].mean())
    if return_distances:  # the reference's __main__ prints their stats (ppl.py:196-204)
        return score, distances
    return score
