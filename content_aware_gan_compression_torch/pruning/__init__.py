"""Content-aware pruning. Ported so far: the KD mask helpers."""

from .content_aware import (
    CLOTH_CLASS,
    IMAGENET_MEAN,
    IMAGENET_STD,
    PARSING_SIZE,
    batch_img_parsing,
    bilinear_resize,
    coi_mask_from_parsing,
    get_masked_tensor,
    normalize_for_parsing,
)

__all__ = ["CLOTH_CLASS", "IMAGENET_MEAN", "IMAGENET_STD", "PARSING_SIZE", "batch_img_parsing",
           "bilinear_resize", "coi_mask_from_parsing", "get_masked_tensor",
           "normalize_for_parsing"]
