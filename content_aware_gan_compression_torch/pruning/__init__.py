"""Channel pruning: the scoring metrics, the prune-mask schedule, state-dict
surgery and the paper's content-aware gradient metric, with the
content-aware KD mask (reference Util/pruning_metrics.py,
Util/pruning_util.py, Util/mask_util.py, Util/content_aware_pruning.py)."""

from .content_aware import (
    CLOTH_CLASS,
    IMAGENET_MEAN,
    IMAGENET_STD,
    PARSING_SIZE,
    batch_img_parsing,
    bilinear_resize,
    coi_mask_from_parsing,
    draw_scoring_batch,
    get_content_aware_pruning_score,
    get_masked_tensor,
    normalize_for_parsing,
    salt_pepper_noisy_images,
)
from .mask import mask_the_generator
from .metrics import (
    asv_score,
    incoming_l1_norm,
    l1_normalized_asv,
    l2_normalized_asv,
    map_l1_norm,
    map_l2_norm,
    outgoing_l1_norm,
)
from .schedule import (
    METRIC_LIST,
    generate_prune_mask_list,
    get_network_score_list,
    get_uniform_remove_list,
)

__all__ = [
    "asv_score", "map_l1_norm", "map_l2_norm", "l1_normalized_asv", "l2_normalized_asv",
    "outgoing_l1_norm", "incoming_l1_norm",
    "get_network_score_list", "generate_prune_mask_list", "get_uniform_remove_list",
    "METRIC_LIST",
    "mask_the_generator",
    "get_content_aware_pruning_score", "salt_pepper_noisy_images", "draw_scoring_batch",
    "get_masked_tensor", "batch_img_parsing", "coi_mask_from_parsing",
    "CLOTH_CLASS", "IMAGENET_MEAN", "IMAGENET_STD", "PARSING_SIZE", "bilinear_resize",
    "normalize_for_parsing",
]
