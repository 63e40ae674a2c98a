"""Content-aware pruning, the paper's own metric, and the content-aware KD
mask (reference Util/content_aware_pruning.py; the JAX package's
pruning/content_aware.py).

The mask: parse images at 512px with BiSeNet and keep the content of
interest (every face class: parsing > 0 and != 16, cloth). Each mask helper
takes ``data_format`` "NCHW" (the JAX package's plain functions) or "NHWC"
(its ``_nhwc`` twins, and the layout the port's generator returns). Both
bilinear resizes are ``F.interpolate(..., align_corners=False,
antialias=False)``, the half-pixel grid of ``jax.image.resize(...,
antialias=False)``.

The scorer (reference :120-249): per batch, generate images, parse them,
put salt-and-pepper noise on a Bernoulli share of the content's pixels, and
score each input channel of ``[conv1] + convs + [to_rgbs[-1]]`` by the mean
|gradient| of ``sum |noisy - img|`` with respect to its kernel. One
generator forward serves both the parse and the gradient, so a scoring
batch runs the generator forward and backward once: on the card blur4 and
its backward, the epilogue and its backward ``masked_scale``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PARSING_SIZE = 512
CLOTH_CLASS = 16


def _channel_dim(data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unknown data_format {data_format!r}")
    return 1 if data_format == "NCHW" else 3


def bilinear_resize(x, h, w, data_format="NCHW"):
    """Bilinear resize to (h, w) on the half-pixel grid, no antialias on a
    downscale (torch's and ``jax.image.resize(antialias=False)``'s)."""
    nhwc = _channel_dim(data_format) == 3
    x = x.permute(0, 3, 1, 2) if nhwc else x
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1) if nhwc else out


def normalize_for_parsing(img, data_format="NCHW"):
    """[-1, 1] images -> 512px ImageNet-normalized images (reference
    Batch_Img_Parsing, content_aware_pruning.py:70-83)."""
    x = torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)
    x = bilinear_resize(x, PARSING_SIZE, PARSING_SIZE, data_format)
    shape = (1, 3, 1, 1) if _channel_dim(data_format) == 1 else (1, 1, 1, 3)
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).reshape(shape)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).reshape(shape)
    return (x - mean) / std


@torch.no_grad()
def batch_img_parsing(img, parse_fn, data_format="NCHW"):
    """Class map [N, 512, 512] of [-1, 1] images. ``parse_fn`` maps the
    normalized images to logits in the same layout (BiSeNet head 0,
    ``models.bisenet.make_parse_fn``). An argmax has no gradient, so no graph
    is built."""
    logits = parse_fn(normalize_for_parsing(img, data_format))
    return torch.argmax(logits, dim=_channel_dim(data_format))


def coi_mask_from_parsing(parsing):
    """Content of interest: every face class except background (0) and cloth
    (16) (reference content_aware_pruning.py:103)."""
    return (parsing > 0) & (parsing != CLOTH_CLASS)


def get_masked_tensor(img, batch_parsing, data_format="NCHW"):
    """``img`` masked to the content of interest, differentiably in ``img``
    (reference content_aware_pruning.py:90-117): the float mask at 512,
    bilinear to the image's size, thresholded at 0.5."""
    nhwc = _channel_dim(data_format) == 3
    mask = coi_mask_from_parsing(batch_parsing).float()[:, None]
    h, w = (img.shape[1], img.shape[2]) if nhwc else (img.shape[2], img.shape[3])
    mask = (bilinear_resize(mask, h, w) > 0.5).to(img.dtype)
    return img * (mask.permute(0, 2, 3, 1) if nhwc else mask)


# ---------------------------------------------------------------------------
# the content-aware scorer
# ---------------------------------------------------------------------------


def salt_pepper_noisy_images(img, coi_mask_hw, noise_prob, generator=None, *, sp=None,
                             bern=None):
    """Salt-and-pepper noise on NHWC images (reference :152-171): inside the
    mask each pixel is replaced, in every channel, by one +-1 value with
    probability ``noise_prob``.

    Args:
      img: [N, H, W, C] images (their shape, dtype and device are used).
      coi_mask_hw: [N, H, W] bool at the image's size.
      sp, bern: the draws, [N, H, W, 1]: the +-1 values and the Bernoulli
        replace mask (bool); each drawn from ``generator`` when not given.
    Returns (sp, replace), both [N, H, W, 1] in ``img``'s dtype.
    """
    n, h, w, _ = img.shape
    if sp is None:
        sp = torch.randint(0, 2, (n, h, w, 1), generator=generator, device=img.device) * 2 - 1
    if bern is None:
        bern = torch.rand((n, h, w, 1), generator=generator, device=img.device) < noise_prob
    replace = bern & coi_mask_hw[..., None]
    return sp.to(img.dtype), replace.to(img.dtype)


def _resize_mask_to_image(mask_512, size):
    """A [N, 512, 512] mask at the image's size, nearest. ``nearest-exact``
    samples the half-pixel grid, as ``jax.image.resize(method="nearest")``
    does (512 -> 256 keeps rows 1, 3, 5, ...); plain ``nearest`` keeps rows
    0, 2, 4, ... and would shift the mask by a pixel."""
    resized = F.interpolate(mask_512.float()[:, None], size=(size, size), mode="nearest-exact")
    return resized[:, 0] > 0.5


def _image_grad_scores(g, img, sp_values, replace_mask):
    """Per-layer scores of ``img``, the NHWC output of ``g`` still holding its
    graph: mean |d loss / d W| over (0, out, kh, kw), one per input channel,
    of ``loss = sum(|sp - img| * replace)``. Where ``replace`` is 0 the term
    and its gradient are 0, as with the reference's copy-and-assign."""
    loss = torch.sum(torch.abs(sp_values - img) * replace_mask)
    grads = torch.autograd.grad(loss, [conv.weight for conv in g.scored_convs()])
    return [gr.abs().mean((0, 1, 3, 4)) for gr in grads]


def _grad_scores(g, z, noise, sp_values, replace_mask):
    """Per-layer input-channel scores of one batch (reference :174-196): the
    generator's NHWC image at ``z`` and ``noise`` through
    ``_image_grad_scores``; ``sp_values`` and ``replace_mask`` [N, H, W, 1]."""
    with torch.enable_grad():
        img = g([z], noise=noise, output_format="NHWC")
        return _image_grad_scores(g, img, sp_values, replace_mask)


def draw_scoring_batch(g, batch_size, noise_prob, generator):
    """One scoring batch's draws from ``generator``, in the order the scorer
    takes them: z [B, style_dim], the per-layer noise, the +-1 values and
    the Bernoulli replace mask [B, size, size, 1]."""
    dev, size = g.device, g.config.size
    z = torch.randn(batch_size, g.config.style_dim, generator=generator, device=dev)
    noise = g.make_noise(batch_size, generator)
    # with a mask that keeps every pixel, the replace mask is the Bernoulli draw
    everywhere = torch.ones((batch_size, size, size), dtype=torch.bool, device=dev)
    sp, bern = salt_pepper_noisy_images(torch.empty((batch_size, size, size, 1), device=dev),
                                        everywhere, noise_prob, generator)
    return z, noise, sp, bern.bool()


def get_content_aware_pruning_score(g, *, parse_fn, n_sample, batch_size, noise_prob,
                                    generator=None, draws=None, info_print=False):
    """Per-batch list of per-layer input-channel scores, as numpy arrays
    (reference Get_Content_Aware_Pruning_Score, :200-249); sum over the
    batches for the final score, as ``prune`` does.

    Args:
      parse_fn: normalized NHWC [N, 512, 512, 3] -> NHWC logits
        (``models.bisenet.make_parse_fn(net, "NHWC")``), or None to count
        the whole image as content.
      generator: a ``torch.Generator`` on ``g``'s device, for the draws.
      draws: instead, one ``(z, noise, sp, bern)`` per batch
        (``draw_scoring_batch``'s form).

    Every batch has ``batch_size`` rows, as in the JAX package: a residual
    ``n_sample % batch_size`` is one more full batch whose surplus rows get
    a zero replace mask, so they add nothing (the reference grows its last
    batch instead; same samples, same scores).
    """
    n_full, rem = divmod(n_sample, batch_size)
    n_batch = n_full + (1 if rem else 0)
    size = g.config.size
    all_scores = []
    for idx in range(n_batch):
        if info_print:
            print(f"content-aware scoring batch {idx + 1}/{n_batch}")
        if draws is not None:
            z, noise, sp, bern = draws[idx]
        else:
            z, noise, sp, bern = draw_scoring_batch(g, batch_size, noise_prob, generator)
        with torch.enable_grad():
            img = g([z], noise=noise, output_format="NHWC")
            if parse_fn is not None:
                parsing = batch_img_parsing(img.detach(), parse_fn, data_format="NHWC")
                mask = _resize_mask_to_image(coi_mask_from_parsing(parsing), size)
            else:
                mask = torch.ones((batch_size, size, size), dtype=torch.bool, device=img.device)
            sp, replace = salt_pepper_noisy_images(img, mask, noise_prob, sp=sp, bern=bern)
            n_valid = batch_size if idx < n_full else rem
            valid = torch.arange(batch_size, device=img.device) < n_valid
            replace = replace * valid[:, None, None, None].to(replace.dtype)
            scores = _image_grad_scores(g, img, sp, replace)
        all_scores.append([s.detach().cpu().numpy() for s in scores])
    return all_scores
