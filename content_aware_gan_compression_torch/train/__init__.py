"""Distillation retraining: config, losses, the four steps and the loop.
``python -m content_aware_gan_compression_torch.train`` is the CLI."""

from .config import TrainConfig
from .loop import Trainer
from .losses import d_logistic_loss, g_nonsaturating_loss, kd_loss, r1_penalty
from .steps import (
    EMA_ACCUM, AdamNoMu, d_reg_step, d_step, draw_d, draw_g, draw_g_reg, ema_accumulate,
    g_reg_step, g_step, make_optimizers, prepare_real, reg_ratio_adam)

__all__ = ["TrainConfig", "Trainer", "d_logistic_loss", "g_nonsaturating_loss", "kd_loss",
           "r1_penalty", "EMA_ACCUM", "AdamNoMu", "d_reg_step", "d_step", "draw_d", "draw_g",
           "draw_g_reg", "ema_accumulate", "g_reg_step", "g_step", "make_optimizers",
           "prepare_real", "reg_ratio_adam"]
