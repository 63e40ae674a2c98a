"""The port's Trainer on 2 gloo ranks with the reference's default objective
(content-aware KD masked by BiSeNet's parse of the teacher, plus LPIPS),
against the JAX Trainer on a 2-device CPU mesh fed the same draws: the
window of test_torch_data_parallel.py (iterations 0-4, R1 at 0, path length
at 0, 2 and 4, global batch 8) with the width-0.25 aux nets of
test_torch_full_kd_trainer.py, the port's steps with oneDNN off (for the
masked regions' exact max-pool ties). The ranks end with bit-equal weights.

Tolerance: 1e-3 relative and 1e-4 absolute, 10x test_torch_full_kd_trainer's
over its 3 iterations. Past iteration 2 the full objective's trajectory
drifts from JAX's in one process as much as on two ranks: at iteration 4 the
G loss is 7.2e-4 (one process) and 7.1e-4 (two ranks) from the JAX mesh's,
R1 3.2e-5 and 3.3e-5 absolute. The content mask is a threshold of an
argmax, so a pixel near a tie flips with the last bits of the teacher's
image (at iteration 2 one flips between a 4-row and an 8-row forward: the
KD-L1 moves 1.1e-4), and Adam's first steps, about lr * sign(g), carry such
differences into the weights.
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
from torch_dp_util import run_trainer, spawn
from torch_train_util import (
    D_CHANNEL_MAX, N_MLP, STYLE, aux_trees, jax_params, train_kw, trainer_draws,
    write_checkpoints)
from torch_train_util import torch_threads  # noqa: F401

SIZE = 32
N_ITERS = 5
GLOBAL_BATCH = 8
RTOL, ATOL = 1e-3, 1e-4  # see the module's docstring
G32 = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                         net_shape=(16, 12, 12, 8, 8, 6, 6, 4))
T32 = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                         net_shape=(16, 16, 16, 12, 12, 8, 8, 8))
D32 = JaxDiscriminatorConfig(size=SIZE, channel_max=D_CHANNEL_MAX)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_dp_full_kd")
    student, teacher = write_checkpoints(d, jax_params(G32, T32, D32))
    kw = train_kw(generated_img_size=SIZE, ckpt=student, teacher=teacher,
                  batch_size=GLOBAL_BATCH, content_aware_KD=True, kd_lpips_lambda=3.0,
                  d_reg_freq=4, g_reg_freq=2)
    aux = aux_trees()
    jt = JaxTrainer(JaxTrainConfig(**kw, n_devices=2, steps_per_dispatch=1), exp_root=str(d),
                    lpips_params=aux[0], parse_params=aux[1])
    assert jt.mesh.size == 2
    state0 = jt.save(JaxLogger(str(d), name="jax"), 0)
    batches = (np.random.RandomState(3).rand(N_ITERS, GLOBAL_BATCH, SIZE, SIZE, 3)
               * 255).astype(np.uint8)
    mpl = jax.numpy.asarray(0.0, jax.numpy.float32)
    draws, metrics = [], []
    for it in range(N_ITERS):
        draws.append(trainer_draws(jt, it))
        m, mpl = jt.step(it, batches[it], mpl)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(kw={**kw, "ckpt": state0}, batches=batches, draws=draws, metrics=metrics,
                mpl=float(mpl), aux=aux)


def test_two_ranks_full_objective_follow_the_jax_mesh(jax_run, tmp_path):
    r = jax_run
    ranks = spawn(run_trainer, 2, tmp_path, r["kw"], r["batches"], r["draws"], r["aux"], False)
    for it in range(N_ITERS):
        got, want = ranks[0]["metrics"][it], r["metrics"][it]
        assert set(got) == set(want), it
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"iteration {it} {k}")
        assert got["kd_lpips_loss"] > 0 and got["kd_l1_loss"] > 0
        assert ranks[1]["metrics"][it] == got
    np.testing.assert_allclose(ranks[0]["mpl"], r["mpl"], rtol=RTOL)
    for net in ("g", "d", "g_ema"):
        for k, v in ranks[0][net].items():
            assert torch.equal(v, ranks[1][net][k]), f"{net} {k}"
