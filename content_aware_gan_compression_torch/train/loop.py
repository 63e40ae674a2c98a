"""The distillation retraining loop (reference train.py:341-452; the JAX
package's train/loop.py): D and G steps with the lazy regularizers' cadence,
EMA, reference-format logs, sample grids, in-loop FID and checkpoints with
optimizer state, on one card.

Not ported, because they answer TPU and relay costs that a card on PCIe does
not have: the input-put probe and controller, the K-step scan window, data
echoing, and the in-loop FID's fallbacks to a synchronous or half-batch pass
when the TPU's 16 GB run out (the eval's extra memory on the card is
measured by chip_smoke.py; ROADMAP.md).
"""

from __future__ import annotations

import copy
import os
import time

import torch

from ..data import data_loader, open_dataset
from ..evaluation.fid import OverlappedFIDEval, get_model_fid_score
from ..models.stylegan2 import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig
from ..utils.checkpoint import (
    build_bisenet_from_state_dict, build_discriminator_from_state_dict,
    build_generator_from_state_dict, build_inception_from_state_dict, build_lpips_from_state_dict,
    load_optimizer_state, load_training_checkpoint, optimizer_state_to_jax, save_checkpoint)
from ..utils.logging import ExperimentLogger, save_image_grid
from ..utils.runtime import resolve_device
from .config import TrainConfig
from .steps import (
    d_reg_step, d_step, draw_d, draw_g, draw_g_reg, ema_accumulate, g_reg_step, g_step,
    make_optimizers, prepare_real, torch_dtype)


def _frozen(net_or_state, build, device):
    """An aux net (given as a module or as its state dict) on ``device``, in
    eval mode and without gradients."""
    net = (net_or_state.to(device) if isinstance(net_or_state, torch.nn.Module)
           else build(net_or_state, device=device))
    return net.requires_grad_(False).eval()


class Trainer:
    """Builds the student, its EMA copy, D, the teacher and the optimizers
    from a ``TrainConfig``; ``step`` runs one reference iteration and ``run``
    the loop.

    Weights come from ``cfg.ckpt`` ({'g', 'g_ema'[, 'd', 'g_optim',
    'd_optim']}) and ``cfg.teacher`` ({'g_ema'}), or are drawn from
    ``cfg.seed``; D is drawn when the checkpoint has none. Random draws of
    the loop come from a ``torch.Generator`` on ``device`` seeded with
    ``cfg.seed``. ``device`` defaults to ``cuda``.

    ``lpips_params`` (an ``LPIPS`` or its state dict, e.g. a JAX
    ``lpips_init`` tree) is kept when there is a teacher and
    ``kd_lpips_lambda > 0``; ``parse_params`` (a ``BiSeNet`` or its state
    dict) when there is a teacher and ``content_aware_KD``, as in the JAX
    Trainer. Both are moved to ``device`` once and frozen.

    ``inception_params`` (an ``InceptionV3`` or its state dict) with
    ``real_stats`` ({'mean', 'cov'} or a pickle path) turn on the FID of
    ``g_ema`` every ``model_save_freq`` iterations in ``run``.

    ``cfg.compute_dtype`` is the steps' compute type (``dtype``), as the JAX
    Trainer hands it to ``make_train_steps`` and nowhere else: ``g_ema``'s
    sample grids and the in-loop FID run in float32 there and here.
    ``cfg.opt_state_dtype`` is the type both optimizers store ``nu`` in.
    """

    def __init__(self, cfg: TrainConfig, *, device="cuda", exp_root=".", lpips_params=None,
                 parse_params=None, inception_params=None, real_stats=None):
        self.cfg = cfg
        self.device = device = resolve_device(device)
        self.dtype = torch_dtype(cfg.compute_dtype)
        self.exp_root = exp_root
        init = torch.Generator().manual_seed(cfg.seed)
        size, style, n_mlp = cfg.generated_img_size, cfg.latent, cfg.n_mlp

        # student, g_ema and D (reference train.py:483-496)
        self.metadata, trees = {}, {}
        if cfg.ckpt:
            trees, self.metadata = load_training_checkpoint(cfg.ckpt)
            self.g = build_generator_from_state_dict(trees["g"], size, style, n_mlp,
                                                     device=device)
            self.g_ema = build_generator_from_state_dict(trees["g_ema"], size, style, n_mlp,
                                                         device=device)
        else:
            self.g = Generator(GeneratorConfig(size=size, style_dim=style, n_mlp=n_mlp,
                                               channel_multiplier=cfg.channel_multiplier),
                               device=device, generator=init)
            self.g_ema = copy.deepcopy(self.g)
        if "d" in trees:
            self.d = build_discriminator_from_state_dict(trees["d"], size,
                                                         cfg.channel_multiplier, device=device)
        else:
            self.d = Discriminator(DiscriminatorConfig(
                size=size, channel_multiplier=cfg.channel_multiplier), device=device,
                generator=init)
        self.g_ema.requires_grad_(False)

        # teacher (reference train.py:500-506)
        self.teacher = None
        if cfg.teacher:
            t_trees, _ = load_training_checkpoint(cfg.teacher)
            self.teacher = build_generator_from_state_dict(t_trees["g_ema"], size, style,
                                                           n_mlp, device=device)
            self.teacher.requires_grad_(False)

        # aux nets of the KD objective (the JAX loop.py:189-192)
        self.lpips = self.parser = None
        if cfg.teacher and cfg.kd_lpips_lambda > 0 and lpips_params is not None:
            self.lpips = _frozen(lpips_params, build_lpips_from_state_dict, device)
        if cfg.teacher and cfg.content_aware_KD and parse_params is not None:
            self.parser = _frozen(parse_params, build_bisenet_from_state_dict, device)

        # in-loop FID (the JAX loop.py:528-559): both or neither
        self.inception = self.real_stats = None
        if inception_params is not None and real_stats is not None:
            self.inception = _frozen(inception_params, build_inception_from_state_dict, device)
            self.real_stats = real_stats

        self.g_opt, self.d_opt = make_optimizers(self.g, self.d, cfg)
        self.start_iter = 0
        if cfg.load_train_state and "g_optim" in trees:
            load_optimizer_state(self.g_opt, self.g, trees["g_optim"])
            load_optimizer_state(self.d_opt, self.d, trees["d_optim"])
            if "iter" in self.metadata:
                self.start_iter = int(self.metadata["iter"]) + 1
            else:  # the reference parses the iteration out of the file name (train.py:541)
                try:
                    self.start_iter = int(cfg.ckpt[-9:-3]) + 1
                except ValueError:
                    self.start_iter = 0
        self.gen = torch.Generator(device).manual_seed(cfg.seed)

    # -------------------------------------------------------------------------
    def draw(self, iter_idx: int) -> dict:
        """This iteration's random draws for each phase that runs."""
        draws = {"d": draw_d(self.gen, self.g, self.cfg),
                 "g": draw_g(self.gen, self.g, self.cfg, self.teacher)}
        if iter_idx % self.cfg.g_reg_freq == 0:
            draws["g_reg"] = draw_g_reg(self.gen, self.g, self.cfg)
        return draws

    def step(self, iter_idx: int, real_img, mean_path_length, draws=None, phase_hook=None):
        """One reference iteration (train.py:371-398): D GAN step, R1 every
        ``d_reg_freq``, G GAN + KD step against the updated D, path length
        every ``g_reg_freq``, EMA. ``real_img`` is a uint8 [B, H, W, 3] host
        batch or a float one, NHWC or NCHW (``prepare_real``); ``draws`` defaults to ``draw``'s.
        ``phase_hook(name)``, if given, runs after each phase ('d', 'd_reg',
        'g', 'g_reg', 'ema'). The G phase is ``g_phase``. Returns (metrics
        of 0-dim device tensors, the new mean path length)."""
        cfg = self.cfg
        real = prepare_real(real_img, self.device)
        draws = draws if draws is not None else self.draw(iter_idx)
        hook = phase_hook or (lambda name: None)
        metrics = d_step(self.g, self.d, self.d_opt, real, draws["d"], cfg, self.dtype)
        hook("d")
        if iter_idx % cfg.d_reg_freq == 0:
            metrics.update(d_reg_step(self.d, self.d_opt, real, cfg, self.dtype))
            hook("d_reg")
        metrics.update(self.g_phase(draws["g"]))
        hook("g")
        if iter_idx % cfg.g_reg_freq == 0:
            mean_path_length, m = g_reg_step(self.g, self.g_opt, draws["g_reg"],
                                             mean_path_length, cfg, self.dtype)
            metrics.update(m)
            hook("g_reg")
        ema_accumulate(self.g_ema, self.g)
        hook("ema")
        return metrics, mean_path_length

    def g_phase(self, draws) -> dict:
        """The G phase of ``step``: the GAN + KD step. A trainer with another
        G objective overrides this."""
        return g_step(self.g, self.g_opt, self.d, draws, self.cfg, self.teacher, self.lpips,
                      self.parser, self.dtype)

    # -------------------------------------------------------------------------
    def save(self, logger: ExperimentLogger, iter_idx: int) -> str:
        """``ckpt/<iter>.npz`` with both optimizers' state, in the JAX
        package's format."""
        path = os.path.join(logger.ckpt_dir, f"{str(iter_idx).zfill(6)}.npz")
        save_checkpoint(path, {
            "g": self.g.state_dict(), "d": self.d.state_dict(),
            "g_ema": self.g_ema.state_dict(),
            "g_optim": optimizer_state_to_jax(self.g_opt, self.g),
            "d_optim": optimizer_state_to_jax(self.d_opt, self.d),
        }, metadata={"iter": iter_idx, "size": self.cfg.generated_img_size,
                     "net_shape": list(self.g.config.net_shape)})
        return path

    def start_fid(self, logger, iter_idx: int):
        """FID of ``g_ema`` at ``iter_idx``: an ``OverlappedFIDEval`` that
        ``run`` advances every iteration (``fid_overlap``), or a synchronous
        pass logged at once (None returned). Its draws come from a generator
        seeded from the loop's own."""
        cfg = self.cfg
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.gen, device=self.device))
        gen = torch.Generator(self.device).manual_seed(seed)
        if cfg.fid_overlap:
            return OverlappedFIDEval(self.g_ema, self.inception, self.real_stats,
                                     batch_size=cfg.fid_batch, n_sample=cfg.fid_n_sample,
                                     generator=gen)
        logger.log_fid(get_model_fid_score(self.g_ema, self.inception, self.real_stats,
                                           batch_size=cfg.fid_batch, num_sample=cfg.fid_n_sample,
                                           generator=gen), iter_idx)
        return None

    def open_loader(self, seed: int):
        """``run``'s batches: uint8 [B, H, W, 3] from ``cfg.data_folder``
        (a ``.npy`` cache, a folder's cache, or the folder's images decoded
        per read; ``open_dataset``). A trainer that reads data otherwise
        overrides this."""
        dataset = open_dataset(self.cfg.data_folder, self.cfg.generated_img_size)
        return data_loader(dataset, self.cfg.batch_size, seed=seed, uint8_hwc=True)

    def log_iteration(self, logger, iter_idx: int, train_time: float, metrics: dict):
        """``run``'s line and record of one iteration."""
        logger.log_iteration(iter_idx, train_time, metrics)

    def event_due(self, iter_idx: int) -> bool:
        """Whether ``run`` calls ``event`` after this iteration: never here; a
        trainer with an event of its own overrides both."""
        return False

    def event(self, iter_idx: int, logger) -> str:
        """The event after an iteration, logged after its line; returns its
        name for ``phase_hook``."""
        raise NotImplementedError

    def run(self, *, max_iters: int | None = None, logger=None, data_seed=None,
            phase_hook=None):
        """The loop from ``start_iter``: one log line per iteration, a sample
        grid of ``g_ema`` every ``val_sample_freq``, the FID (with Inception
        and real statistics) and a checkpoint every ``model_save_freq``
        iterations, then ``event`` where ``event_due``. A step's metrics are
        fetched after the next step is queued, so the fetch does not stall
        the card. An overlapped FID advances ``fid_batches_per_iter`` batches
        after each step and is drained before ``run`` returns; its score is
        logged with the iteration it started at. ``phase_hook`` goes to
        ``step`` and is also called with 'sample' and the event's name after
        those. Batches come from ``open_loader``, closed when ``run`` ends."""
        logger = logger or ExperimentLogger(self.exp_root)
        loader = self.open_loader(data_seed if data_seed is not None else self.cfg.seed)
        try:
            return self._run(loader, logger, max_iters, phase_hook)
        finally:
            loader.close()

    def _run(self, loader, logger, max_iters, phase_hook):
        """``run``'s loop over ``loader``'s batches."""
        cfg = self.cfg
        hook = phase_hook or (lambda name: None)
        sample_z = torch.randn(cfg.val_sample_num, cfg.latent, generator=self.gen,
                               device=self.device)
        mean_path_length = torch.zeros((), device=self.device)
        last = {"r1": 0.0, "path": 0.0, "path_length": 0.0}
        end = cfg.training_iters if not max_iters else min(
            cfg.training_iters, self.start_iter + max_iters)

        def flush(pending):
            it, t0, keys, packed = pending
            vals = packed.tolist()
            last.update(zip(keys, vals[:-1]))
            last["mean_path_avg"] = vals[-1]
            self.log_iteration(logger, it, time.time() - t0, last)

        fid = {"eval": None, "iter": None}

        def fid_tick(n_batches):
            if fid["eval"] is None:
                return
            score = fid["eval"].advance(n_batches)
            if score is not None:
                logger.log_fid(score, fid["iter"])
                logger.write(f"FID eval overlapped with training: wall "
                             f"{time.time() - fid['eval'].started:.1f}s, host-side cost "
                             f"{fid['eval'].extra_seconds:.1f}s\n")
                fid["eval"] = None

        pending = None
        for it in range(self.start_iter, end):
            t0 = time.time()
            metrics, mean_path_length = self.step(it, next(loader), mean_path_length,
                                                  phase_hook=phase_hook)
            keys = sorted(metrics)
            packed = torch.stack([metrics[k].float() for k in keys]
                                 + [mean_path_length.float()])
            fid_tick(cfg.fid_batches_per_iter)
            if pending is not None:
                flush(pending)
            pending = (it, t0, keys, packed)
            event = self.event_due(it)
            if (it % cfg.val_sample_freq == 0 or (it % cfg.model_save_freq == 0 and it > 0)
                    or event):
                flush(pending)
                pending = None
                if it % cfg.val_sample_freq == 0:
                    with torch.no_grad():
                        sample = self.g_ema([sample_z], generator=self.gen)
                    save_image_grid(sample.cpu(), os.path.join(
                        logger.sample_dir, f"{str(it).zfill(6)}.png"),
                        nrow=int(cfg.val_sample_num ** 0.5))
                    hook("sample")
                if it % cfg.model_save_freq == 0 and it > 0:
                    if self.inception is not None:
                        fid_tick(10 ** 9)  # finish a straggler first
                        fid["eval"], fid["iter"] = self.start_fid(logger, it), it
                    self.save(logger, it)
                if event:
                    hook(self.event(it, logger))
        fid_tick(10 ** 9)
        if pending is not None:
            flush(pending)
        return logger
