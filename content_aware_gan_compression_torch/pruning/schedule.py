"""Channel scoring by the baseline metrics, and the prune-mask schedule
(reference Util/pruning_util.py; the JAX package's pruning/schedule.py).

Scores are computed on the generator's device and come back to the host as
numpy arrays, one per entry of ``net_shape``; the argsort that turns them
into keep-masks runs in numpy, as in the JAX package, so equal scores give
equal masks. Randomness comes from an explicit ``torch.Generator`` on the
generator's device, or is handed in as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import metrics as M

METRIC_LIST = ("Random", "ASV", "l1-norm-ASV", "l2-norm-ASV", "l1-map",
               "l1-in", "l1-out", "l1-style")

MAP_METRICS = ("ASV", "l1-map", "l1-norm-ASV", "l2-norm-ASV")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _chunk_moments(maps):
    """Per layer, over one chunk of NHWC maps [m, H, W, C]: the mean and M2
    (sum of squared deviations from it) per pixel [H, W, C], and the sums
    of x^2 and of |x| per channel [C]."""
    out = []
    for o in maps:
        # shifted by the first sample, so a layer equal in every sample (the
        # constant input) gets its mean exactly and an M2 of exactly 0
        mean = o[0] + (o - o[0]).mean(0)
        out.append((mean, torch.square(o - mean).sum(0), torch.square(o).sum((0, 1, 2)),
                    o.abs().sum((0, 1, 2))))
    return out


@torch.no_grad()
def get_map_based_score(g, z, metric, batch_size=10, *, noise=None, generator=None):
    """Scores from layer activations (reference pruning_util.py:9-50).

    Streaming, as in the JAX package: chunks of ``batch_size`` samples go
    through ``g.feature_maps`` and are reduced into accumulators the size of
    one sample's maps: per pixel a mean and M2, merged chunk by chunk with
    Chan's parallel-variance rule (the naive sum-of-squares form cancels,
    e.g. on the constant input, whose ASV is exactly 0), and per channel
    the sums of x^2 and |x|. ``n_batch = max(n // batch_size, 1)`` chunks
    of ``m = min(batch_size, n)`` samples: a residual ``n % batch_size`` is
    dropped, and every merge weighs its chunk by ``m``.

    ``noise``: one list of per-layer NHWC noise maps per chunk; drawn from
    ``generator`` (``g.make_noise(m)`` per chunk) when not given.
    """
    if metric not in MAP_METRICS:
        raise ValueError(f"unknown map metric {metric!r}")
    if noise is None and generator is None:
        raise ValueError("map-based metrics need noise or a generator")
    n = z.shape[0]
    n_batch = max(n // batch_size, 1)
    m = min(batch_size, n)
    acc, count = None, 0
    for i in range(n_batch):
        zc = z[i * batch_size:(i + 1) * batch_size]
        chunk_noise = noise[i] if noise is not None else g.make_noise(m, generator)
        mom = _chunk_moments(g.feature_maps(zc, chunk_noise))
        if acc is None:
            acc = mom
        else:
            tot = count + m
            acc = [(mean_a + (mean_b - mean_a) * (m / tot),
                    m2_a + m2_b + torch.square(mean_b - mean_a) * (count * m / tot),
                    s2_a + s2_b, ab_a + ab_b)
                   for (mean_a, m2_a, s2_a, ab_a), (mean_b, m2_b, s2_b, ab_b) in zip(acc, mom)]
        count += zc.shape[0]

    scores = []
    for mean, m2, s2, sabs in acc:
        h, w = mean.shape[:2]
        asv = torch.sqrt(m2 / count).mean((0, 1))  # std with ddof 0
        if metric == "ASV":
            score = asv
        elif metric == "l1-map":
            score = sabs / (count * h * w)
        elif metric == "l1-norm-ASV":
            score = asv / (sabs / (count * h * w))
        else:  # l2-norm-ASV
            score = asv / torch.sqrt(s2)
        scores.append(_host(score))
    return scores


@torch.no_grad()
def get_weight_based_score(g, z, metric, *, generator=None, head=None):
    """Scores from the batch-mean effective kernels (reference
    pruning_util.py:70-112). ``l1-in`` scores each conv's outputs and puts
    in front a uniform draw for the constant input (unevaluated, as in the
    reference): ``head`` [net_shape[0]], or drawn from ``generator`` (a
    generator seeded 0 on ``z``'s device if None). ``l1-out`` scores each
    conv's inputs, the last ToRGB's included."""
    weights = g.effective_weight_means(z)
    if metric == "l1-in":
        if head is None:
            gen = generator or torch.Generator(z.device).manual_seed(0)
            head = torch.rand(weights[0].shape[1], generator=gen, device=z.device)
        return [_host(head)] + [_host(M.incoming_l1_norm(w)) for w in weights[:-1]]
    if metric == "l1-out":
        return [_host(M.outgoing_l1_norm(w)) for w in weights]
    raise ValueError(f"unknown weight metric {metric!r}")


@torch.no_grad()
def get_style_based_score(g, z, metric="l1-style"):
    """|mean over samples of s| per channel (reference pruning_util.py:116-143)."""
    return [_host(s.mean(0).abs()) for s in g.modulation_styles(z)]


def get_network_score_list(g, z, metric, *, generator=None, batch_size=10, noise=None):
    """Scores of ``metric`` (reference Get_Network_Score_List,
    pruning_util.py:146-180): a list of per-layer numpy arrays aligned with
    ``g.config.net_shape``; for the weight and style families the last
    entry scores the last ToRGB's inputs, the last conv's outputs.
    ``Random`` draws uniform scores from ``generator``; the map metrics
    take ``noise`` or draw it from ``generator``."""
    if metric not in METRIC_LIST:
        raise ValueError(f"metric must be one of {METRIC_LIST}")
    if metric == "Random":
        gen = generator or torch.Generator(z.device).manual_seed(0)
        return [_host(torch.rand(c, generator=gen, device=z.device))
                for c in g.config.net_shape]
    if metric in MAP_METRICS:
        return get_map_based_score(g, z, metric, batch_size, noise=noise, generator=generator)
    if metric in ("l1-in", "l1-out"):
        return get_weight_based_score(g, z, metric, generator=generator)
    return get_style_based_score(g, z, metric)


def get_uniform_remove_list(net_shape, pruning_ratio, keep_multiple=1):
    """``int(width * ratio)`` channels removed from each layer (reference
    pruning_util.py:233-244). With ``keep_multiple > 1`` the kept width is
    rounded up to a multiple of it (never past the width); the extra kept
    channels are the next best scored."""
    rmv = [int(c * pruning_ratio) for c in net_shape]
    if keep_multiple > 1:
        out = []
        for c, r in zip(net_shape, rmv):
            keep = min(c, ((c - r + keep_multiple - 1) // keep_multiple) * keep_multiple)
            out.append(c - keep)
        return out
    return rmv


def generate_prune_mask_list(net_score_list, net_shape, rmve_list, info_print=False):
    """Boolean keep-masks by a per-layer argsort of the scores (reference
    pruning_util.py:197-230): the ``rmv`` lowest-scored channels go."""
    masks = []
    for lay_k, (scores, width, rmv) in enumerate(zip(net_score_list, net_shape, rmve_list)):
        scores = np.asarray(scores)
        if scores.shape[0] != width:
            raise ValueError(f"layer {lay_k}: {scores.shape[0]} scores for width {width}")
        mask = np.ones(width, dtype=bool)
        if width > rmv > 0:
            mask[np.argsort(scores)[:rmv]] = False
            if info_print:
                print(f"layer {lay_k}: removed {rmv}, keeping {mask.sum()}")
        masks.append(mask)
    return masks
