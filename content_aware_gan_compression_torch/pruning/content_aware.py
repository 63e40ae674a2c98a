"""The content-aware KD mask (reference Util/content_aware_pruning.py:61-117;
the JAX package's pruning/content_aware.py:32-116): parse the teacher's
images at 512px with BiSeNet, keep the content of interest (every face class:
parsing > 0 and != 16, cloth) and mask images with it.

Each helper takes ``data_format`` "NCHW" (the JAX package's plain functions)
or "NHWC" (its ``_nhwc`` twins, and the layout the port's generator returns).
Both bilinear resizes are ``F.interpolate(..., align_corners=False,
antialias=False)``, the half-pixel grid of ``jax.image.resize(...,
antialias=False)``. The channel scoring belongs to the pruning slice.
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
