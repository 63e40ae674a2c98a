"""The port's Trainer against the JAX package's with the reference's default
objective, on the CPU: content-aware KD (BiSeNet's parse of the teacher
masks both images) plus LPIPS, at 32px with width-scaled aux nets, for 3
iterations from a state the JAX Trainer saved. Also the rule that keeps the
aux nets: LPIPS with a teacher and kd_lpips_lambda > 0, the parser with a
teacher and content_aware_KD.

Tolerance of the metrics: 1e-4 relative and 1e-5 absolute, as the KD-L1
trajectory (test_torch_trainer.py). The port's steps run with oneDNN off,
which keeps the exact max-pool ties of the masked regions as JAX keeps them
(see test_torch_train_steps.py::test_g_step_matches).
"""

import numpy as np
import pytest
import jax
import torch

from content_aware_gan_compression_tpu.models import (
    DiscriminatorConfig as JaxDiscriminatorConfig, GeneratorConfig as JaxGeneratorConfig)
from content_aware_gan_compression_tpu.train import TrainConfig as JaxTrainConfig
from content_aware_gan_compression_tpu.train import Trainer as JaxTrainer
from content_aware_gan_compression_tpu.utils.logging import ExperimentLogger as JaxLogger
from content_aware_gan_compression_torch import train
from content_aware_gan_compression_torch.models import LPIPS, BiSeNet, bisenet_widths
from torch_train_util import (
    D_CHANNEL_MAX, N_MLP, STYLE, aux_trees, coi_share, jax_params, reals, train_kw,
    trainer_draws, write_checkpoints)
from torch_train_util import torch_threads  # noqa: F401

SIZE = 32
N_ITERS = 3
RTOL, ATOL = 1e-4, 1e-5
G32 = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                         net_shape=(16, 12, 12, 8, 8, 6, 6, 4))
T32 = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                         net_shape=(16, 16, 16, 12, 12, 8, 8, 8))
D32 = JaxDiscriminatorConfig(size=SIZE, channel_max=D_CHANNEL_MAX)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX Trainer with the full objective, saved at iteration 0 and run
    for N_ITERS iterations with the draws each one took recorded. R1 runs
    every iteration, so that JAX compiles the G step once (a fused D+G step
    takes the others)."""
    d = tmp_path_factory.mktemp("jax_full_kd")
    student, teacher = write_checkpoints(d, jax_params(G32, T32, D32))
    kw = train_kw(generated_img_size=SIZE, ckpt=student, teacher=teacher,
                  content_aware_KD=True, kd_lpips_lambda=3.0, d_reg_freq=1, g_reg_freq=2)
    lp_tree, parse_tree = aux_trees()
    jt = JaxTrainer(JaxTrainConfig(**kw, n_devices=1, steps_per_dispatch=1), exp_root=str(d),
                    lpips_params=lp_tree, parse_params=parse_tree)
    state0 = jt.save(JaxLogger(str(d), name="jax"), 0)
    batches = reals(N_ITERS, size=SIZE)
    mpl = jax.numpy.asarray(0.0, jax.numpy.float32)
    draws, metrics = [], []
    for it in range(N_ITERS):
        draws.append(trainer_draws(jt, it))
        m, mpl = jt.step(it, batches[it], mpl)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(kw=kw, state0=state0, batches=batches, draws=draws, metrics=metrics,
                mpl=float(mpl), aux=(lp_tree, parse_tree))


def test_full_objective_trajectory_matches_jax(jax_run):
    """Iterations 0-2: D, R1, G with the masked L1 and LPIPS, path length
    at 0 and 2, and EMA, metric for metric; the aux nets take no
    gradient and the mask keeps part of each image."""
    r = jax_run
    lp_tree, parse_tree = r["aux"]
    pt = train.Trainer(train.TrainConfig(**{**r["kw"], "ckpt": r["state0"]}), device="cpu",
                       lpips_params=lp_tree, parse_params=parse_tree)
    assert isinstance(pt.lpips, LPIPS) and isinstance(pt.parser, BiSeNet)
    mpl = torch.zeros(())
    with torch.backends.mkldnn.flags(enabled=False):
        for it in range(N_ITERS):
            m, mpl = pt.step(it, r["batches"][it], mpl, draws=r["draws"][it])
            got = {k: float(v) for k, v in m.items()}
            assert set(got) == set(r["metrics"][it]), it
            for k, want in r["metrics"][it].items():
                np.testing.assert_allclose(got[k], want, rtol=RTOL, atol=ATOL,
                                           err_msg=f"iteration {it} {k}")
            assert got["kd_lpips_loss"] > 0 and got["kd_l1_loss"] > 0
    np.testing.assert_allclose(float(mpl), r["mpl"], rtol=RTOL)
    for net in (pt.lpips, pt.parser):
        assert not net.training and all(p.grad is None and not p.requires_grad
                                        for p in net.parameters())
    g = r["draws"][0]["g"]
    with torch.no_grad():
        img = pt.teacher(g["z"], inject_index=g["inject_index"], noise=g["teacher_noise"],
                         output_format="NHWC")
    assert 0.0 < coi_share(pt.parser, img) < 1.0


def test_aux_nets_follow_the_jax_rule(jax_run):
    """LPIPS only with a teacher and kd_lpips_lambda > 0; the parser only
    with a teacher and content_aware_KD; modules are taken as they are,
    state dicts built."""
    r = jax_run
    lp_tree, _ = r["aux"]
    parser = BiSeNet(bisenet_widths(0.0625), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    base = {**r["kw"], "ckpt": r["state0"]}
    pt = train.Trainer(train.TrainConfig(**base), device="cpu", lpips_params=lp_tree,
                       parse_params=parser)
    assert pt.parser is parser and not parser.training
    assert all(not p.requires_grad for p in parser.parameters())
    off = train.Trainer(train.TrainConfig(**{**base, "kd_lpips_lambda": 0.0,
                                             "content_aware_KD": False}),
                        device="cpu", lpips_params=lp_tree, parse_params=parser)
    assert off.lpips is None and off.parser is None
    no_teacher = train.Trainer(train.TrainConfig(**{**base, "teacher": None}), device="cpu",
                               lpips_params=lp_tree, parse_params=parser)
    assert no_teacher.lpips is None and no_teacher.parser is None
