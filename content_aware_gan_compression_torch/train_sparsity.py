"""GAN-Slimming sparsity baseline CLI, with the flags and defaults of the JAX
package's ``train_sparsity.py`` (the reference's
Miscellaneous/train_sparsity.py and train_sparsity_hyperparams.py):

    python -m content_aware_gan_compression_torch.train_sparsity --path data.npy \\
        --ckpt full.npz --teacher_ckpt full.npz

Training images come from a uint8 cache (``--path`` a ``.npy``), as for
``train``, or from an image folder decoded per read into float batches, as
the JAX package's ``run_sparsity`` reads it. Boolean flags parse
with ``str2bool``. With a teacher and ``--kd_percept_lambda > 0`` the
percept term needs VGG16 weights (``--lpips_vgg_ckpt``, torchvision's
``features.N.*``; with ``--kd_percept_mode LPIPS`` also the heads,
``--lpips_lins_ckpt``); when the VGG16 file is absent the term is dropped
with a warning. ``--device`` (default ``cuda``) picks the card or the CPU.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    from .train.__main__ import str2bool

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", type=str, default="")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--load_train_state", type=str2bool, default=False)
    p.add_argument("--iter", type=int, default=200001)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--r1", type=float, default=10)
    p.add_argument("--path_regularize", type=float, default=2)
    p.add_argument("--path_batch_shrink", type=int, default=2)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--mixing", type=float, default=0.9)
    # sparsity (reference train_sparsity_hyperparams.py:30-36)
    p.add_argument("--sparsity_eta", type=float, default=1e-5)
    p.add_argument("--init_step", type=float, default=0)
    p.add_argument("--model_prune_freq", type=float, default=500000)
    p.add_argument("--lay_rmve_ratio", type=float, default=0.1)
    p.add_argument("--num_rmve_channel", type=float, default=588)
    p.add_argument("--prune_metric", type=str, default="l1-style")
    p.add_argument("--pruning_mode", type=str, default="Global_Number")
    # validation
    p.add_argument("--n_sample", type=int, default=9)
    p.add_argument("--val_sample_freq", type=int, default=1000)
    p.add_argument("--model_save_freq", type=int, default=10000)
    p.add_argument("--fid_n_sample", type=int, default=50000)
    p.add_argument("--fid_batch", type=int, default=64)
    # KD
    p.add_argument("--teacher_ckpt", type=str, default=None)
    p.add_argument("--kd_l1_lambda", type=float, default=0)
    p.add_argument("--kd_percept_lambda", type=float, default=3)
    p.add_argument("--kd_l1_mode", type=str, default="Intermediate")
    p.add_argument("--kd_percept_mode", type=str, default="VGG", choices=["LPIPS", "VGG"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lpips_vgg_ckpt", type=str, default="./Model/metrics/vgg16_torchvision.pth")
    p.add_argument("--lpips_lins_ckpt", type=str, default="./lpips/weights/v0.1/vgg.pth")
    p.add_argument("--exp_root", type=str, default=".")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .train import TrainConfig
    from .train.sparsity import SparsityTrainer
    from .utils import ExperimentLogger

    cfg = TrainConfig(
        data_folder=args.path, generated_img_size=args.size, ckpt=args.ckpt,
        channel_multiplier=args.channel_multiplier, latent=args.latent, n_mlp=args.n_mlp,
        load_train_state=args.load_train_state, training_iters=args.iter,
        batch_size=args.batch, init_lr=args.lr, discriminator_r1=args.r1,
        generator_path_reg_weight=args.path_regularize,
        path_reg_batch_shrink=args.path_batch_shrink, d_reg_freq=args.d_reg_every,
        g_reg_freq=args.g_reg_every, noise_mixing=args.mixing, val_sample_num=args.n_sample,
        val_sample_freq=args.val_sample_freq, model_save_freq=args.model_save_freq,
        fid_n_sample=args.fid_n_sample, fid_batch=args.fid_batch, teacher=args.teacher_ckpt,
        kd_l1_lambda=args.kd_l1_lambda, kd_lpips_lambda=args.kd_percept_lambda,
        kd_mode=args.kd_l1_mode, content_aware_KD=False, seed=args.seed)

    lpips = None
    if cfg.teacher and args.kd_percept_lambda > 0:
        if os.path.exists(args.lpips_vgg_ckpt):
            from .models import load_lpips

            lpips = load_lpips(args.lpips_vgg_ckpt, args.lpips_lins_ckpt, device="cpu")
        else:
            print(f"WARNING: no VGG weights at {args.lpips_vgg_ckpt}; percept KD disabled")

    trainer = SparsityTrainer(
        cfg, dict(sparsity_eta=args.sparsity_eta, model_prune_freq=args.model_prune_freq,
                  lay_rmve_ratio=args.lay_rmve_ratio, num_rmve_channel=args.num_rmve_channel,
                  prune_metric=args.prune_metric, pruning_mode=args.pruning_mode,
                  kd_percept_mode=args.kd_percept_mode),
        device=args.device, exp_root=args.exp_root, lpips_params=lpips)
    logger = ExperimentLogger(args.exp_root)
    trainer.run(logger=logger)
    logger.close()
    print(f"logs, samples and checkpoints in {logger.exp_dir}")
    return logger.exp_dir


if __name__ == "__main__":
    main()
