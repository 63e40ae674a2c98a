"""Distillation retraining CLI (the JAX package's train.py, itself
flag-compatible with the reference train.py):

    python -m content_aware_gan_compression_torch.train --path data.npy \
        --ckpt student.npz --teacher_ckpt teacher.npz

Every reference flag keeps its name and default; boolean flags parse with
``str2bool``. ``--device`` (default ``cuda``) picks the card or the CPU.
``--dtype bfloat16`` runs the steps in bfloat16 and ``--opt_state_dtype
bfloat16`` stores Adam's second moment in it, as in the JAX CLI. The JAX
CLI's TPU flags (``--remat``, ``--packed_trunk``, ``--steps_per_dispatch``,
``--input_put``, ``--data_echo``) have no counterpart.

Data parallel: the JAX CLI's ``--n_devices N`` is torchrun's
``--nproc_per_node=N`` here,

    torchrun --nproc_per_node=N -m content_aware_gan_compression_torch.train ...

Each process trains on ``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device
cpu``), ``--batch_size`` is the global batch, split over the processes, and
rank 0 writes the log, the sample grids and the checkpoints. Without
torchrun's environment the CLI runs one process.

The content-aware KD mask and the LPIPS term need the aux nets' weights:
BiSeNet from ``--parsing_ckpt`` (the reference's ``79999_iter.pth`` schema),
VGG16 from ``--lpips_vgg_ckpt`` (torchvision's ``features.N.*``) and the
LPIPS heads from ``--lpips_lins_ckpt`` (the reference's
``lpips/weights/v0.1/vgg.pth``, ``lin{k}.model.1.weight``). When the BiSeNet
or VGG16 file is absent, this prints the JAX CLI's warning and drops that
term, as the JAX CLI does.

``--real_stats`` (an Inception statistics pickle, from ``calc_inception``)
with the FID Inception weights at ``--inception_ckpt`` (the pytorch-fid
release) adds the FID of ``g_ema`` every ``--model_save_freq`` iterations,
overlapped with training; without the weights file it is skipped, as in the
JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def str2bool(v):
    """Boolean flags that parse "False" as false (the reference's
    ``type=bool`` does not; docs/PARITY.md)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "t", "yes", "y", "1"):
        return True
    if v.lower() in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def parse_args(argv=None):
    from .config import TrainConfig

    hp = TrainConfig()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", type=str, default=hp.data_folder)
    p.add_argument("--size", type=int, default=hp.generated_img_size)
    p.add_argument("--ckpt", type=str, default=hp.ckpt)
    p.add_argument("--channel_multiplier", type=int, default=hp.channel_multiplier)
    p.add_argument("--latent", type=int, default=hp.latent)
    p.add_argument("--n_mlp", type=int, default=hp.n_mlp)
    p.add_argument("--load_train_state", type=str2bool, default=hp.load_train_state)
    p.add_argument("--iter", type=int, default=hp.training_iters)
    p.add_argument("--batch_size", type=int, default=hp.batch_size)
    p.add_argument("--lr", type=float, default=hp.init_lr)
    p.add_argument("--r1", type=float, default=hp.discriminator_r1)
    p.add_argument("--path_regularize", type=float, default=hp.generator_path_reg_weight)
    p.add_argument("--path_batch_shrink", type=int, default=hp.path_reg_batch_shrink)
    p.add_argument("--d_reg_every", type=int, default=hp.d_reg_freq)
    p.add_argument("--g_reg_every", type=int, default=hp.g_reg_freq)
    p.add_argument("--mixing", type=float, default=hp.noise_mixing)
    p.add_argument("--n_sample", type=int, default=hp.val_sample_num)
    p.add_argument("--val_sample_freq", type=int, default=hp.val_sample_freq)
    p.add_argument("--model_save_freq", type=int, default=hp.model_save_freq)
    p.add_argument("--fid_n_sample", type=int, default=hp.fid_n_sample)
    p.add_argument("--fid_batch", type=int, default=hp.fid_batch)
    p.add_argument("--teacher_ckpt", type=str, default=hp.teacher)
    p.add_argument("--kd_l1_lambda", type=float, default=hp.kd_l1_lambda)
    p.add_argument("--kd_lpips_lambda", type=float, default=hp.kd_lpips_lambda)
    p.add_argument("--kd_mode", type=str, default=hp.kd_mode)
    p.add_argument("--content_aware_KD", type=str2bool, default=hp.content_aware_KD)
    p.add_argument("--seed", type=int, default=hp.seed)
    p.add_argument("--dtype", type=str, default=hp.compute_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--opt_state_dtype", type=str, default=hp.opt_state_dtype,
                   choices=["float32", "bfloat16"],
                   help="storage dtype for Adam's second moment (bfloat16 halves its "
                        "bytes; arithmetic stays f32 — deviates from reference numerics)")
    p.add_argument("--parsing_ckpt", type=str, default="./Model/face_parsing/79999_iter.pth")
    p.add_argument("--lpips_vgg_ckpt", type=str,
                   default="./Model/metrics/vgg16_torchvision.pth")
    p.add_argument("--lpips_lins_ckpt", type=str, default="./lpips/weights/v0.1/vgg.pth")
    p.add_argument("--inception_ckpt", type=str,
                   default="./Model/metrics/pt_inception-2015-12-05-6726825d.pth")
    p.add_argument("--real_stats", type=str, default=None)
    p.add_argument("--exp_root", type=str, default=".")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def config_from_args(args):
    """The TrainConfig of the flags."""
    from .config import TrainConfig

    cfg = TrainConfig(
        data_folder=args.path, generated_img_size=args.size, ckpt=args.ckpt,
        channel_multiplier=args.channel_multiplier, latent=args.latent, n_mlp=args.n_mlp,
        load_train_state=args.load_train_state, training_iters=args.iter,
        batch_size=args.batch_size, init_lr=args.lr, discriminator_r1=args.r1,
        generator_path_reg_weight=args.path_regularize,
        path_reg_batch_shrink=args.path_batch_shrink, d_reg_freq=args.d_reg_every,
        g_reg_freq=args.g_reg_every, noise_mixing=args.mixing, val_sample_num=args.n_sample,
        val_sample_freq=args.val_sample_freq, model_save_freq=args.model_save_freq,
        fid_n_sample=args.fid_n_sample, fid_batch=args.fid_batch, teacher=args.teacher_ckpt,
        kd_l1_lambda=args.kd_l1_lambda, kd_lpips_lambda=args.kd_lpips_lambda,
        kd_mode=args.kd_mode, content_aware_KD=args.content_aware_KD, seed=args.seed,
        compute_dtype=args.dtype, opt_state_dtype=args.opt_state_dtype)
    return cfg


def aux_nets_from_args(args, cfg):
    """(cfg, LPIPS or None, BiSeNet or None), loaded on the CPU from the
    flags' files where the objective needs them (the JAX CLI's
    train.py:146-166): without VGG16 weights the LPIPS term is dropped
    (``kd_lpips_lambda`` 0), without BiSeNet weights the KD mask; rank 0
    prints the warning."""
    from .. import parallel
    from ..models import load_bisenet, load_lpips

    lpips = parser = None
    if cfg.teacher and cfg.kd_lpips_lambda > 0:
        if os.path.exists(args.lpips_vgg_ckpt):
            lpips = load_lpips(args.lpips_vgg_ckpt, args.lpips_lins_ckpt, device="cpu")
        else:
            parallel.main_print(f"WARNING: no VGG weights at {args.lpips_vgg_ckpt}; "
                                "LPIPS KD disabled")
            cfg = dataclasses.replace(cfg, kd_lpips_lambda=0.0)
    if cfg.teacher and cfg.content_aware_KD:
        if os.path.exists(args.parsing_ckpt):
            parser = load_bisenet(args.parsing_ckpt, device="cpu")
        else:
            parallel.main_print(f"WARNING: no BiSeNet weights at {args.parsing_ckpt}; "
                                "content-aware KD masking disabled")
    return cfg, lpips, parser


def fid_from_args(args):
    """(InceptionV3 or None, real-stats path or None): the in-loop FID runs
    when ``--real_stats`` is given and ``--inception_ckpt`` exists, as in the
    JAX CLI (train.py:167-177)."""
    if not (args.real_stats and os.path.exists(args.inception_ckpt)):
        return None, None
    from ..models import load_fid_inception

    return load_fid_inception(args.inception_ckpt, device="cpu"), args.real_stats


def main(argv=None):
    args = parse_args(argv)
    from .. import parallel

    with parallel.process_group(args.device) as device:
        _train(args, device)


def _train(args, device):
    """The run of the flags on ``device``; rank 0 logs."""
    from .. import parallel
    from ..utils import ExperimentLogger, NullLogger
    from .loop import Trainer

    cfg, lpips, parser = aux_nets_from_args(args, config_from_args(args))
    inception, real_stats = fid_from_args(args)
    logger = ExperimentLogger(args.exp_root) if parallel.is_main() else NullLogger()
    trainer = Trainer(cfg, device=device, exp_root=args.exp_root, lpips_params=lpips,
                      parse_params=parser, inception_params=inception, real_stats=real_stats)
    status = (
        "\n--------------- Training Start ---------------\n\n"
        f"Params:\n\n  Model and Data:\n"
        f"    Data Folder: {cfg.data_folder}\n"
        f"    Multi-Layer Perceptron Num Layers: {cfg.n_mlp}\n"
        f"    Generator Num Layers: {trainer.g.config.n_latent}\n"
        f"    Latent Variable Dimension: {cfg.latent}\n"
        f"    Generated Image Size: {cfg.generated_img_size}\n"
        f"    Channel Multiplier: {cfg.channel_multiplier}\n"
        f"    Initial Checkpoint: {cfg.ckpt}\n"
        f"    Load Training State: {cfg.load_train_state}\n\n"
        f"  Device:\n"
        f"    {trainer.device}, {parallel.world_size()} process(es), global batch "
        f"{cfg.batch_size}\n"
        f"    Compute dtype: {cfg.compute_dtype}\n\n"
        f"  Training Params:\n"
        f"    Training Iterations: {cfg.training_iters}\n"
        f"    Batch Size: {cfg.batch_size}\n"
        f"    Learning Rate: {cfg.init_lr}\n"
        f"    Generator Path Regularization Frequency: {cfg.g_reg_freq}\n"
        f"    Path Regularization Weight: {cfg.generator_path_reg_weight}\n"
        f"    Path Batch Shrink Ratio: {cfg.path_reg_batch_shrink}\n"
        f"    Discriminator Regularization Frequency: {cfg.d_reg_freq}\n"
        f"    Discriminator Regularization Weight: {cfg.discriminator_r1}\n"
        f"    Noise Mixing: {cfg.noise_mixing}\n\n"
        f"  Knowledge Distillation Params:\n"
        f"    Teacher Checkpoint: {cfg.teacher}\n"
        f"    L1 Knowledge Distillation Weight: {cfg.kd_l1_lambda}\n"
        f"    L1 Knowledge Distillation Mode: {cfg.kd_mode}\n"
        f"    LPIPS Knowledge Distillation Weight: {cfg.kd_lpips_lambda}\n"
        f"    Content Aware: {cfg.content_aware_KD}\n\n")
    parallel.main_print(status)
    logger.write(status)
    t0 = time.time()
    trainer.run(logger=logger)
    logger.write(f"\nTotal training time: {round(time.time() - t0, 3)}")
    logger.close()
    parallel.main_print(f"logs, samples and checkpoints in {logger.exp_dir}")


if __name__ == "__main__":
    main()
