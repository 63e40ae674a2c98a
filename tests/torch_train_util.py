"""Shared fixtures of the port's training tests: a tiny student, teacher and
discriminator written by the JAX package, and the JAX steps' random draws
rebuilt from their keys so that both packages see the same draws."""

import numpy as np
import jax
import jax.numpy as jnp
import torch
from jax import random

from content_aware_gan_compression_tpu.models import (
    DiscriminatorConfig as JaxDiscriminatorConfig, GeneratorConfig as JaxGeneratorConfig,
    discriminator_init, generator_init, generator_make_noise)
from content_aware_gan_compression_tpu.train.steps import _mixing_latents
from content_aware_gan_compression_tpu.utils import save_checkpoint as jax_save_checkpoint

SIZE, STYLE, N_MLP, BATCH = 16, 16, 2, 4
STUDENT_SHAPE = (16, 12, 12, 8, 8, 6)  # narrow and non-uniform, like a pruned student
TEACHER_SHAPE = (16, 16, 16, 12, 12, 8)
D_CHANNEL_MAX = 16
G_CFG = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=STUDENT_SHAPE)
T_CFG = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=TEACHER_SHAPE)
D_CFG = JaxDiscriminatorConfig(size=SIZE, channel_max=D_CHANNEL_MAX)


def train_kw(**kw):
    """TrainConfig fields both packages share, for the tiny models: KD-L1
    only, as the CLIs run without BiSeNet and VGG weights."""
    base = dict(generated_img_size=SIZE, latent=STYLE, n_mlp=N_MLP, batch_size=BATCH,
                content_aware_KD=False, kd_lpips_lambda=0.0, seed=0)
    base.update(kw)
    return base


def jax_params():
    """(student, teacher, D) trees as numpy, with the zero-at-init noise
    weights and biases set so that every term of the epilogue counts."""
    g = jax.tree_util.tree_map(np.asarray, generator_init(random.PRNGKey(0), G_CFG))
    t = jax.tree_util.tree_map(np.asarray, generator_init(random.PRNGKey(1), T_CFG))
    d = jax.tree_util.tree_map(np.asarray, discriminator_init(random.PRNGKey(2), D_CFG))
    rng = np.random.RandomState(0)
    for tree in (g, t):
        for block in [tree["conv1"], *tree["convs"].values()]:
            block["noise"]["weight"] = 0.5 * rng.randn(1).astype(np.float32)
            block["activate"]["bias"] = 0.2 * rng.randn(
                *block["activate"]["bias"].shape).astype(np.float32)
    return g, t, d


def write_checkpoints(dirpath):
    """student.npz {'g', 'g_ema', 'd'} and teacher.npz {'g_ema'}, as the JAX
    package writes them."""
    g, t, d = jax_params()
    student, teacher = str(dirpath / "student.npz"), str(dirpath / "teacher.npz")
    jax_save_checkpoint(student, {"g": g, "g_ema": g, "d": d})
    jax_save_checkpoint(teacher, {"g_ema": t})
    return student, teacher


def reals(n, seed=3):
    return (np.random.RandomState(seed).rand(n, BATCH, SIZE, SIZE, 3) * 255).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mix(key, cfg, batch):
    zs, inject_index = _mixing_latents(key, batch, cfg, G_CFG.n_latent)
    return [_t(z) for z in zs], torch.tensor(int(inject_index))


def d_draws(key, cfg):
    """What the JAX d_step draws from its key."""
    k_mix, k_noise = random.split(key)
    zs, idx = _mix(k_mix, cfg, cfg.batch_size)
    return {"z": zs, "inject_index": idx,
            "noise": [_t(n) for n in generator_make_noise(k_noise, G_CFG, cfg.batch_size)]}


def g_draws(key, cfg):
    """What the JAX g_step draws from its key."""
    k_mix, k_noise, k_tnoise = random.split(key, 3)
    zs, idx = _mix(k_mix, cfg, cfg.batch_size)
    return {"z": zs, "inject_index": idx,
            "noise": [_t(n) for n in generator_make_noise(k_noise, G_CFG, cfg.batch_size)],
            "teacher_noise": [_t(n) for n in generator_make_noise(k_tnoise, T_CFG,
                                                                   cfg.batch_size)]}


def g_reg_draws(key, cfg):
    """What the JAX g_reg_step draws from its key, y unscaled."""
    batch = max(1, cfg.batch_size // cfg.path_reg_batch_shrink)
    k_mix, k_noise, k_ppl = random.split(key, 3)
    k_z, k_p, k_i = random.split(k_mix, 3)
    z = random.normal(k_z, (2, batch, cfg.latent))
    do_mix = random.uniform(k_p) < cfg.noise_mixing
    idx = jnp.where(do_mix, random.randint(k_i, (), 1, G_CFG.n_latent), G_CFG.n_latent)
    return {"z": [_t(z[0]), _t(z[1])], "inject_index": torch.tensor(int(idx)),
            "noise": [_t(n) for n in generator_make_noise(k_noise, G_CFG, batch)],
            "ppl_noise": _t(random.normal(k_ppl, (batch, SIZE, SIZE, 3)))}


def trainer_draws(jax_trainer, iter_idx):
    """The draws JAX's Trainer.step takes at ``iter_idx`` from its current
    key: on R1 iterations d_step and g_step get their keys directly, on the
    others the fused dg_step splits one key in two."""
    cfg = jax_trainer.cfg
    _, k_d, k_g, k_greg = random.split(jax_trainer.rng, 4)
    if iter_idx % cfg.d_reg_freq != 0:
        k_d, k_g = random.split(k_d)
    draws = {"d": d_draws(k_d, cfg), "g": g_draws(k_g, cfg)}
    if iter_idx % cfg.g_reg_freq == 0:
        draws["g_reg"] = g_reg_draws(k_greg, cfg)
    return draws
