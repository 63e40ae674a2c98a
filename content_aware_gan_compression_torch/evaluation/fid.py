"""FID (the JAX package's evaluation/fid.py; reference Evaluation/fid.py).

Samples go through the generator and Inception on the device, one full-size
batch at a time; the Frechet distance is computed on the host in float64 with
``scipy.linalg.sqrtm`` (fid.py:41-64, with the singular-covariance eps retry
and the imaginary-component check). Real statistics come from a pickle
(``{'mean', 'cov'}``, the reference's format) or are built from an image
folder by ``compute_real_stats_from_folder``.

Random draws come from a ``torch.Generator`` on the generator's device: each
batch draws its z, then its noise maps. The same generator state gives the
same features in ``extract_feature_from_samples`` and in
``OverlappedFIDEval``.
"""

from __future__ import annotations

import copy
import os
import pickle
import time
import warnings

import numpy as np
import torch

# the feature function both sides of the Frechet distance must share: the
# patched FID InceptionV3 fed [-1, 1] images raw (normalize_input=False,
# reference calc_inception.py:54); the JAX package stamps the same string
INCEPTION_REGIME = "patched_fid_inception_raw[-1,1]"


def _feature_step(g, inception, z, *, noise=None, generator=None, truncation=1.0,
                  truncation_latent=None):
    """One batch of samples -> pool3 features on the device. ``noise`` is a
    list of per-layer NHWC maps, or None to draw them from ``generator``."""
    with torch.inference_mode():
        img = g([z], truncation=truncation, truncation_latent=truncation_latent, noise=noise,
                generator=generator)
        # [-1, 1] images enter Inception raw, as the reference's FID net
        # (load_patched_inception_v3, normalize_input=False) takes them
        return inception(img, normalize_input=False)


def _draw_features(g, inception, batch_size, generator, truncation, truncation_latent):
    """z, then the noise maps, from ``generator``; the batch's features."""
    z = torch.randn(batch_size, g.config.style_dim, generator=generator, device=g.device)
    return _feature_step(g, inception, z, generator=generator, truncation=truncation,
                         truncation_latent=truncation_latent)


def _default_generator(g, generator):
    return generator if generator is not None else torch.Generator(g.device).manual_seed(0)


def extract_feature_from_samples(g, inception, *, truncation=1.0, truncation_latent=None,
                                 batch_size=64, n_sample=50000, generator=None,
                                 info_print=False):
    """pool3 features of ``n_sample`` generated images, float64 [n_sample,
    pool3_dim] (reference fid.py:19-38). Every batch has ``batch_size``
    samples: ceil(n_sample / batch_size) batches, and the surplus rows of the
    last are dropped. The features stay on the device until the end."""
    generator = _default_generator(g, generator)
    n_batch = max(1, -(-n_sample // batch_size))
    feats = []
    for idx in range(n_batch):
        if info_print and idx % 50 == 0:
            print(f"FID features: batch {idx + 1}/{n_batch}")
        feats.append(_draw_features(g, inception, batch_size, generator, truncation,
                                    truncation_latent))
    return torch.cat(feats).cpu().numpy()[:n_sample].astype(np.float64)


def calc_fid(sample_mean, sample_cov, real_mean, real_cov, eps=1e-6):
    """Frechet distance between two Gaussians, in float64 (reference
    fid.py:41-64)."""
    from scipy import linalg

    # modern sqrtm warns instead of failing on singular input; the retry
    # below keeps the reference's disp=False semantics
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", linalg.LinAlgWarning)
        cov_sqrt = linalg.sqrtm(sample_cov @ real_cov)

    if not np.isfinite(cov_sqrt).all():
        warnings.warn(f"product of cov matrices is singular; retrying with eps={eps} on the "
                      "diagonals", RuntimeWarning, stacklevel=2)
        offset = np.eye(sample_cov.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sample_cov + offset) @ (real_cov + offset))

    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            m = np.max(np.abs(cov_sqrt.imag))
            raise ValueError(f"Imaginary component {m}")
        cov_sqrt = cov_sqrt.real

    mean_diff = sample_mean - real_mean
    mean_norm = mean_diff @ mean_diff
    trace = np.trace(sample_cov) + np.trace(real_cov) - 2 * np.trace(cov_sqrt)
    return mean_norm + trace


def feature_stats(features) -> dict:
    """{'mean', 'cov'} of float64 features [N, D]."""
    return {"mean": np.mean(features, 0), "cov": np.cov(features, rowvar=False)}


def load_real_stats(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _check_regime(stats: dict):
    """Refuse statistics computed under another Inception feature function
    (no key: built by the reference, or before the stamp; accepted)."""
    regime = stats.get("inception_regime")
    if regime is not None and regime != INCEPTION_REGIME:
        raise ValueError(
            f"real-stats pickle was computed under feature regime {regime!r} but this build "
            f"extracts {INCEPTION_REGIME!r}; regenerate the stats "
            "(compute_real_stats_from_folder / calc_inception)")


def _real_stats(real_stats) -> dict:
    stats = load_real_stats(real_stats) if isinstance(real_stats, str) else real_stats
    _check_regime(stats)
    return stats


def get_model_fid_score(g, inception, real_stats, *, truncation=1.0, truncation_latent=None,
                        batch_size=100, num_sample=50000, generator=None, info_print=False):
    """FID of ``g`` against ``real_stats`` ({'mean', 'cov'} or a pickle
    path) (reference Get_Model_FID_Score, fid.py:67-121)."""
    real_stats = _real_stats(real_stats)
    start = time.time()
    features = extract_feature_from_samples(
        g, inception, truncation=truncation, truncation_latent=truncation_latent,
        batch_size=batch_size, n_sample=num_sample, generator=generator, info_print=info_print)
    if info_print:
        print(f"feature extraction took {time.time() - start:.2f}s, shape {features.shape}")
    stats = feature_stats(features)
    return calc_fid(stats["mean"], stats["cov"], real_stats["mean"], real_stats["cov"])


class OverlappedFIDEval:
    """In-loop FID interleaved with training instead of stalling it (the
    reference blocks the loop for the whole pass, train.py:436-441).

    Scores a snapshot of ``g`` taken at construction, so the score is that of
    ``g_ema`` at the iteration that started the eval while training goes on.
    ``advance`` queues a few feature batches on the device's stream after the
    training step; each batch's features are copied to pinned host memory
    without blocking and read only after the next batch has been queued, so
    the host never waits on the batch it has just queued. The same
    ``generator`` state gives the same score as ``get_model_fid_score``.
    """

    def __init__(self, g, inception, real_stats, *, batch_size=64, n_sample=50000,
                 generator=None, truncation=1.0, truncation_latent=None):
        self._g = copy.deepcopy(g).requires_grad_(False)  # the live g_ema keeps training
        self._inc = inception
        self._real = _real_stats(real_stats)
        self._gen = _default_generator(g, generator)
        self._bs = batch_size
        self._n_sample = n_sample
        self._n_batch = max(1, -(-n_sample // batch_size))
        self._truncation, self._truncation_latent = truncation, truncation_latent
        self._idx = 0
        self._pending = None  # (host features, copy-done event) of the last batch
        self._feats = []
        self.started = time.time()
        self.extra_seconds = 0.0  # host time spent waiting on fetches and scoring

    @property
    def done(self) -> bool:
        return self._idx >= self._n_batch and self._pending is None

    def _fetch(self):
        t0 = time.time()
        host, event = self._pending
        if event is not None:
            event.synchronize()
        self._feats.append(host)
        self._pending = None
        self.extra_seconds += time.time() - t0

    def advance(self, n_batches: int = 1):
        """Queue up to ``n_batches`` feature batches and read the one before.
        Returns the FID when the stream is complete, else None."""
        for _ in range(n_batches):
            if self._idx >= self._n_batch:
                break
            feats = _draw_features(self._g, self._inc, self._bs, self._gen, self._truncation,
                                   self._truncation_latent)
            if feats.is_cuda:
                host = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
                host.copy_(feats, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = feats, None
            if self._pending is not None:
                self._fetch()
            self._pending = (host, event)
            self._idx += 1
        if self._idx < self._n_batch or self._pending is None:
            return None
        self._fetch()
        t0 = time.time()
        features = torch.cat(self._feats).numpy()[:self._n_sample].astype(np.float64)
        self._feats, self._g = [], None  # release the snapshot
        stats = feature_stats(features)
        score = calc_fid(stats["mean"], stats["cov"], self._real["mean"], self._real["cov"])
        self.extra_seconds += time.time() - t0
        return score


def compute_real_stats_from_folder(folder: str, inception, *, size: int, batch_size=64,
                                   n_sample=None, save_path: str | None = None,
                                   info_print=False) -> dict:
    """{'mean', 'cov', 'size', 'inception_regime'} Inception statistics of a
    folder of images, resized with Lanczos to ``size`` (the reference's
    calc_inception flow without the LMDB store; ``FFHQDataset``), fed to
    Inception as [-1, 1] like the generated images."""
    from ..data.dataset import FFHQDataset

    ds = FFHQDataset(folder, size, random_flip=False, resample="lanczos")
    n = min(n_sample, len(ds)) if n_sample else len(ds)
    device = next(inception.parameters()).device
    feats = []
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            batch = np.stack([ds.load_uint8(i, None) for i in range(start,
                                                                    min(start + batch_size, n))])
            feats.append(uint8_features(inception, torch.from_numpy(batch).to(device)))
            if info_print:
                print(f"real stats: {min(start + batch_size, n)}/{n} images")
    features = torch.cat(feats).cpu().numpy().astype(np.float64)
    # the stamp names the feature function, so that statistics of another
    # regime are refused instead of giving a silently wrong FID
    stats = {**feature_stats(features), "size": size, "inception_regime": INCEPTION_REGIME}
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        with open(save_path, "wb") as f:
            pickle.dump(stats, f)
    return stats


def uint8_features(inception, u8_nhwc):
    """pool3 features of uint8 [B, H, W, 3] images on Inception's device,
    scaled to [-1, 1] as the reference's ToTensor + Normalize(0.5, 0.5)
    (calc_inception.py:92-99) and fed raw."""
    img = u8_nhwc.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    return inception(img, normalize_input=False)
