"""The GAN-Slimming sparsity baseline (reference
Miscellaneous/train_sparsity.py; the JAX package's train/sparsity.py):
GAN + KD training with an L1 penalty on the modulation scalars of every
layer, and in-training pruning (the l1-style metric by default) that cuts
the student and restarts both optimizers.

Reference quirks kept, as the JAX package keeps them:

- The 'VGG' percept term is an MSE over the LPIPS-VGG16 trunk's five slices
  on the raw [-1, 1] images, without LPIPS's shift and scale
  (``vgg_perceptual_loss``; the reference's GAN_Slimming_Util is missing).
- The percept term compares images average-pooled to 256px
  (``avg_pool_to_256``, kernel = stride = size // 256), not ``kd_loss``'s
  resized and masked images; KD Intermediate is unmasked.
- Global_Number keeps the scores strictly above the ``num_rmve_channel``-th
  smallest: it removes ``num_rmve_channel + 1`` channels when the scores are
  distinct, and more on ties.
- Layer_Uniform takes its remove counts from the full 256px shape at 256px,
  and from the model's own widths at other sizes.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..data import FFHQDataset, data_loader
from ..models.stylegan2 import default_net_shape
from ..pruning import (
    generate_prune_mask_list, get_network_score_list, get_uniform_remove_list,
    mask_the_generator)
from ..utils.calculators import GENERATOR_FLOPS_256PX, styled_conv_flops
from ..utils.checkpoint import build_generator_from_state_dict
from .loop import Trainer
from .losses import g_nonsaturating_loss
from .steps import _f32_up, make_optimizers

PERCEPT_MODES = ("LPIPS", "VGG")
SPARSITY_DEFAULTS = dict(sparsity_eta=1e-5, model_prune_freq=500000, lay_rmve_ratio=0.1,
                         num_rmve_channel=588, prune_metric="l1-style",
                         pruning_mode="Global_Number", kd_percept_mode="VGG")
PRUNE_SAMPLES = 500  # latents scored at a prune event (reference train_sparsity.py:428)


def l1_style_sparse_loss(style_list, eta):
    """eta * sum over layers of ||mean over the batch of s||_1 (reference
    train_sparsity.py:261-274); the batch is the global one with a process
    group up (the mean is inside the absolute value, so a mean per rank
    would be another loss)."""
    total = 0.0
    for s in style_list:
        total = total + parallel.global_mean(s, dim=0).abs().sum()
    return eta * total


def vgg_perceptual_loss(lpips, a, b, data_format="NCHW"):
    """The MSE over the five VGG16 slices of ``lpips.vgg`` between ``a`` and
    ``b``, fed as they are (no LPIPS shift and scale)."""
    if data_format == "NHWC":
        a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    return sum(torch.mean(torch.square(x - y)) for x, y in zip(lpips.vgg(a), lpips.vgg(b)))


def avg_pool_to_256(img_nhwc, size):
    """Average pooling with kernel = stride = ``size // 256`` of NHWC images;
    the identity at 256px and below (reference train_sparsity.py:245-249)."""
    k = size // 256
    if k <= 1:
        return img_nhwc
    return F.avg_pool2d(img_nhwc.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def get_network_prune_mask(network_score, net_shape, *, pruning_mode, lay_rmve_ratio,
                           num_rmve_channel, full_shape_256=None):
    """Keep-masks of Layer_Uniform or Global_Number (reference
    train_sparsity.py:405-421). Layer_Uniform removes ``int(c * ratio)``
    channels of each width of ``full_shape_256`` (the full 256px shape if
    None); Global_Number keeps every score above the
    ``int(num_rmve_channel)``-th smallest of all layers."""
    if pruning_mode == "Layer_Uniform":
        base = full_shape_256 or list(default_net_shape(256))
        return generate_prune_mask_list(network_score, net_shape,
                                        get_uniform_remove_list(base, lay_rmve_ratio))
    if pruning_mode == "Global_Number":
        all_scores = sorted(itertools.chain.from_iterable(
            np.asarray(s).tolist() for s in network_score))
        thres = all_scores[int(num_rmve_channel)]
        return [np.asarray(s) > thres for s in network_score]
    raise ValueError(f"unknown pruning_mode {pruning_mode!r}")


def sparse_g_step(g, g_opt, d, draws, cfg, opts, teacher=None, lpips=None,
                  dtype=None) -> dict:
    """The sparse G step (the JAX package's sparsity g_step): the teacher's
    rgb list without gradients, the student with its rgb list and style
    scalars, D on the student's image; non-saturating loss + the L1 style
    penalty, plus KD-L1 (the final image or the unmasked rgb list) and the
    percept term (``opts['kd_percept_mode']``: VGG or LPIPS on the
    256-pooled images, with ``lpips``) when there is a teacher. One Adam
    step of ``g``. The teacher, the student and D run in ``dtype``, as the
    JAX package threads ``compute_dtype`` there; the losses in float32."""
    teacher_list = None
    if teacher is not None:
        with torch.no_grad():
            teacher_list = [_f32_up(t) for t in teacher(
                draws["z"], inject_index=draws["inject_index"], noise=draws["teacher_noise"],
                output_format="NHWC", return_rgb_list=True, dtype=dtype)]
    fake_list, style_list = g(draws["z"], inject_index=draws["inject_index"],
                              noise=draws["noise"], output_format="NHWC",
                              return_rgb_list=True, return_style_scalars=True, dtype=dtype)
    fake_list = [_f32_up(f) for f in fake_list]
    fake_img = fake_list[-1]
    g_loss = g_nonsaturating_loss(d(fake_img, dtype).float())
    sparse = l1_style_sparse_loss([_f32_up(s) for s in style_list], opts["sparsity_eta"])
    metrics = {"g": g_loss.detach(), "sparse": sparse.detach()}
    total = g_loss + sparse
    if teacher_list is not None:
        t_img = teacher_list[-1]
        if cfg.kd_mode == "Output_Only":
            kd_l1 = cfg.kd_l1_lambda * torch.mean(torch.abs(t_img - fake_img))
        else:
            kd_l1 = cfg.kd_l1_lambda * sum(torch.mean(torch.abs(t - s))
                                           for t, s in zip(teacher_list, fake_list))
        a = avg_pool_to_256(fake_img, cfg.generated_img_size)
        b = avg_pool_to_256(t_img, cfg.generated_img_size)
        if lpips is None:
            kd_p = torch.zeros((), dtype=fake_img.dtype, device=fake_img.device)
        elif opts["kd_percept_mode"] == "VGG":
            kd_p = cfg.kd_lpips_lambda * vgg_perceptual_loss(lpips, a, b, "NHWC")
        else:
            kd_p = cfg.kd_lpips_lambda * torch.mean(lpips(a, b, data_format="NHWC").float())
        metrics["kd_l1_loss"] = kd_l1.detach()
        metrics["kd_percept_loss"] = kd_p.detach()
        total = total + kd_l1 + kd_p
    g_opt.zero_grad(set_to_none=True)
    total.backward(inputs=list(g.parameters()))
    parallel.all_reduce_grads(g.parameters())
    g_opt.step()
    return metrics


class SparsityTrainer(Trainer):
    """The ``Trainer`` with the sparse G step on every iteration and
    in-training pruning every ``model_prune_freq`` iterations: its ``run``
    is the loop of the reference's train_sparsity.py:470-578, with that
    script's log line and the prune event after the checkpoint.

    ``sparsity_opts`` override ``SPARSITY_DEFAULTS``: sparsity_eta,
    model_prune_freq, lay_rmve_ratio, num_rmve_channel, prune_metric,
    pruning_mode and kd_percept_mode ('VGG' or 'LPIPS'). The other keywords
    are the ``Trainer``'s; the percept term uses its LPIPS net, which it
    keeps with a teacher and ``kd_lpips_lambda > 0``."""

    def __init__(self, cfg, sparsity_opts=None, **kw):
        self.opts = {**SPARSITY_DEFAULTS, **(sparsity_opts or {})}
        if self.opts["kd_percept_mode"] not in PERCEPT_MODES:
            raise ValueError(f"kd_percept_mode must be one of {PERCEPT_MODES}")
        super().__init__(cfg, **kw)

    def g_phase(self, draws) -> dict:
        return sparse_g_step(self.g, self.g_opt, self.d, draws, self.cfg, self.opts,
                             self.teacher, self.lpips, self.dtype)

    def open_loader(self, seed: int):
        """A ``.npy`` cache as the ``Trainer`` reads it; any other path as
        the JAX package's ``run_sparsity`` reads it (train/sparsity.py:
        235-241): its images decoded per read (``FFHQDataset``, even where
        the folder holds a cache) into float NCHW batches through the native
        transform."""
        if self.cfg.data_folder.endswith(".npy"):
            return super().open_loader(seed)
        dataset = FFHQDataset(self.cfg.data_folder, self.cfg.generated_img_size)
        return data_loader(dataset, self.cfg.batch_size, seed=seed,
                           shard=(parallel.rank(), parallel.world_size()))

    def prune_in_training(self, z=None):
        """Score ``g_ema`` on ``z`` (``PRUNE_SAMPLES`` latents drawn from the
        loop's generator if None) with ``prune_metric``, mask, cut ``g`` and
        ``g_ema`` to the new widths and rebuild both optimizers from scratch
        (reference Prune_Generator, train_sparsity.py:424-457). Returns
        (new net_shape, its styled-conv FLOPs as a percentage of the 256px
        generator's).

        With a process group up every rank draws and scores (the stream
        stays in step) and takes rank 0's masks, so every rank cuts to the
        same widths; the new optimizers hold the new parameters, and
        ``all_reduce_grads`` takes its bucket from them at each step."""
        cfg, opts = self.cfg, self.opts
        if z is None:
            z = torch.randn(PRUNE_SAMPLES, cfg.latent, generator=self.gen, device=self.device)
        score = get_network_score_list(self.g_ema, z.to(self.device), opts["prune_metric"],
                                       generator=self.gen)
        net_shape = list(self.g.config.net_shape)
        masks = get_network_prune_mask(
            score, net_shape, pruning_mode=opts["pruning_mode"],
            lay_rmve_ratio=opts["lay_rmve_ratio"], num_rmve_channel=opts["num_rmve_channel"],
            full_shape_256=None if cfg.generated_img_size == 256 else net_shape)
        masks = parallel.broadcast_object(masks)
        rebuild = [build_generator_from_state_dict(
            mask_the_generator(net.state_dict(), masks), cfg.generated_img_size, cfg.latent,
            cfg.n_mlp, device=self.device) for net in (self.g, self.g_ema)]
        self.g, self.g_ema = rebuild
        self.g_ema.requires_grad_(False)
        self.g_opt, self.d_opt = make_optimizers(self.g, self.d, cfg)
        new_shape = self.g.config.net_shape
        return new_shape, styled_conv_flops(new_shape, False) / GENERATOR_FLOPS_256PX * 100.0

    def log_iteration(self, logger, iter_idx, train_time, m):
        """The reference's line (train_sparsity.py:548-561) and a record."""
        logger.write(
            f"Iter #: {iter_idx} Train Time: {round(train_time, 2)}"
            f" D_Loss: {round(m.get('d', 0), 3)}"
            f" G_Loss: {round(m.get('g', 0), 3)}"
            f" Sparse_Loss: {round(m.get('sparse', 0), 3)}"
            f" KD_L1_Loss: {round(m.get('kd_l1_loss', 0), 3)}"
            f" KD_Percept_Loss: {round(m.get('kd_percept_loss', 0), 3)}"
            f" D_Reg: {round(m.get('r1', 0), 3)}"
            f" G_Reg: {round(m.get('path', 0), 3)}"
            f" G_Mean_Path: {round(m.get('mean_path_avg', 0), 4)}\n")
        logger.log_event({"iter": iter_idx, "train_time": train_time, **m})

    def event_due(self, iter_idx):
        return iter_idx % self.opts["model_prune_freq"] == 0 and iter_idx > 0

    def event(self, iter_idx, logger):
        """The prune event (reference train_sparsity.py:566-573), logged
        with the new shape and FLOPs %."""
        new_shape, flops_pct = self.prune_in_training()
        logger.write("\n\n-------After pruning------\n"
                     f"Shape: {list(new_shape)}\n"
                     f"FLOPs %: {round(flops_pct, 2)}\n\n")
        logger.log_event({"iter": iter_idx, "net_shape": list(new_shape),
                          "flops_pct": flops_pct})
        return "prune"
