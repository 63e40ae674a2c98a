"""Evaluators: FID (reference Evaluation/fid.py) and PPL (Evaluation/ppl.py)."""

from .fid import (
    OverlappedFIDEval,
    calc_fid,
    compute_real_stats_from_folder,
    extract_feature_from_samples,
    get_model_fid_score,
)
from .ppl import get_ppl_score, lerp, slerp

__all__ = [
    "extract_feature_from_samples",
    "calc_fid",
    "get_model_fid_score",
    "compute_real_stats_from_folder",
    "OverlappedFIDEval",
    "get_ppl_score",
    "lerp",
    "slerp",
]
