"""The port's Trainer against the JAX package's, on the CPU, at a tiny size
(see torch_train_util.py): a 5-iteration trajectory from a state the JAX
Trainer saved, a JAX training checkpoint resumed in the port, the port's
checkpoint resumed in JAX, a reference torch checkpoint, and the data loader
and logger.

Tolerance of the trajectory's metrics: 1e-4 relative and 1e-5 absolute. One
iteration agrees to about 1e-6 (fp32 sums in another order), and five
iterations of Adam, whose steps are about lr * sign(g), let a few weights
whose gradient is near 0 move apart.
"""

import json

import numpy as np
import pytest
import jax
import torch

from content_aware_gan_compression_tpu.data import infinite_loader as jax_infinite_loader
from content_aware_gan_compression_tpu.data import open_dataset as jax_open_dataset
from content_aware_gan_compression_tpu.train import TrainConfig as JaxTrainConfig
from content_aware_gan_compression_tpu.train import Trainer as JaxTrainer
from content_aware_gan_compression_tpu.utils.logging import ExperimentLogger as JaxLogger
from content_aware_gan_compression_torch import train
from content_aware_gan_compression_torch.data import infinite_loader, open_dataset
from content_aware_gan_compression_torch.utils import (
    ExperimentLogger, save_checkpoint, state_dict_from_jax)
from torch_train_util import reals, train_kw, trainer_draws, write_checkpoints
from torch_train_util import torch_threads  # noqa: F401

N_ITERS = 5
RTOL, ATOL = 1e-4, 1e-5
# R1 at 0; path length at 0, 2 and 4: every phase runs in the window
CADENCE = dict(d_reg_freq=4, g_reg_freq=2)


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def _close(got, want, it):
    assert set(got) == set(want), it
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"iteration {it} {k}")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX Trainer saved at iteration 0, run for N_ITERS iterations with
    the draws each one took recorded, saved again, and stepped once more."""
    d = tmp_path_factory.mktemp("jax_run")
    student, teacher = write_checkpoints(d)
    kw = train_kw(ckpt=student, teacher=teacher, **CADENCE)
    jt = JaxTrainer(JaxTrainConfig(**kw, n_devices=1, steps_per_dispatch=1), exp_root=str(d))
    logger = JaxLogger(str(d), name="jax")
    state0 = jt.save(logger, 0)
    batches = reals(N_ITERS + 1)
    mpl = jax.numpy.asarray(0.0, jax.numpy.float32)
    draws, metrics = [], []
    for it in range(N_ITERS):
        draws.append(trainer_draws(jt, it))
        m, mpl = jt.step(it, batches[it], mpl)
        metrics.append(_metrics(m))
    state_last = jt.save(logger, N_ITERS - 1)
    last_draws = trainer_draws(jt, N_ITERS)
    m, next_mpl = jt.step(N_ITERS, batches[N_ITERS], mpl)
    return dict(kw=kw, state0=state0, state_last=state_last, batches=batches, draws=draws,
                metrics=metrics, mpl=float(mpl), last_draws=last_draws,
                last_metrics=_metrics(m), next_mpl=float(next_mpl))


def test_five_iteration_trajectory_matches_jax(jax_run):
    """Iterations 0-4 from the JAX Trainer's saved state: D, R1 at 0, G with
    KD-L1, path length at 0, 2 and 4, and EMA, metric for metric."""
    r = jax_run
    pt = train.Trainer(train.TrainConfig(**{**r["kw"], "ckpt": r["state0"]}), device="cpu")
    mpl = torch.zeros(())
    for it in range(N_ITERS):
        m, mpl = pt.step(it, r["batches"][it], mpl, draws=r["draws"][it])
        _close(_metrics(m), r["metrics"][it], it)
    np.testing.assert_allclose(float(mpl), r["mpl"], rtol=RTOL)


def test_jax_training_checkpoint_resumes_in_the_port(jax_run):
    """The JAX Trainer's checkpoint after iteration 4, with g_optim and
    d_optim, loads into the port with load_train_state: the port starts at
    iteration 5 with JAX's Adam state, and its iteration 5 matches JAX's."""
    r = jax_run
    cfg = train.TrainConfig(**{**r["kw"], "ckpt": r["state_last"], "load_train_state": True})
    pt = train.Trainer(cfg, device="cpu")
    assert pt.start_iter == N_ITERS
    trees = np.load(r["state_last"])
    count = int(trees["g_optim/[0].count"])
    assert pt.g_opt.param_groups[0]["step"] == count
    nu = trees["g_optim/[0].nu['conv1']['conv']['weight']"]
    np.testing.assert_array_equal(pt.g_opt.state[pt.g.conv1.conv.weight]["exp_avg_sq"].numpy(),
                                  nu)
    m, mpl = pt.step(N_ITERS, r["batches"][N_ITERS], torch.tensor(r["mpl"]),
                     draws=r["last_draws"])
    _close(_metrics(m), r["last_metrics"], N_ITERS)
    np.testing.assert_allclose(float(mpl), r["next_mpl"], rtol=RTOL)


def test_port_checkpoint_resumes_in_jax(tmp_path, jax_run):
    """The port's Trainer.save, after one iteration, loads into the JAX
    Trainer with load_train_state: the same weights, Adam state and start."""
    r = jax_run
    pt = train.Trainer(train.TrainConfig(**{**r["kw"], "ckpt": r["state0"]}), device="cpu")
    pt.step(0, r["batches"][0], torch.zeros(()), draws=r["draws"][0])
    path = pt.save(ExperimentLogger(str(tmp_path), name="port"), 0)
    jcfg = JaxTrainConfig(**{**r["kw"], "ckpt": path, "load_train_state": True},
                          n_devices=1, steps_per_dispatch=1)
    jt = JaxTrainer(jcfg, exp_root=str(tmp_path))
    assert jt.start_iter == 1
    for mine, theirs in ((pt.g, jt.g_params), (pt.d, jt.d_params), (pt.g_ema, jt.g_ema_params)):
        want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, theirs))
        got = mine.state_dict()
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    assert int(jt.g_opt_state[0].count) == pt.g_opt.param_groups[0]["step"] == 2  # G and path
    assert int(jt.d_opt_state[0].count) == pt.d_opt.param_groups[0]["step"] == 2  # D and R1
    np.testing.assert_array_equal(
        np.asarray(jt.d_opt_state[0].nu["final_linear"]["0"]["weight"]),
        pt.d_opt.state[pt.d.final_linear[0].weight]["exp_avg_sq"].numpy())


def test_reference_pt_checkpoint_with_torch_adam_state(tmp_path):
    """A reference-style .pt: {'g', 'd', 'g_ema', 'g_optim', 'd_optim'} with
    torch Adam state dicts. The b1 == 0 optimizer takes their second moment
    and step, and the iteration comes from the file name, as the reference
    parses it (train.py:541)."""
    student, _ = write_checkpoints(tmp_path)
    src = train.Trainer(train.TrainConfig(**train_kw(ckpt=student)), device="cpu")
    adams = {}
    for name, module in (("g_optim", src.g), ("d_optim", src.d)):
        opt = torch.optim.Adam(module.parameters(), lr=0.002, betas=(0.0, 0.99))
        for p in module.parameters():
            p.grad = torch.randn_like(p)
        opt.step()
        opt.step()
        adams[name] = opt.state_dict()
    path = str(tmp_path / "000123.pt")
    torch.save({"g": src.g.state_dict(), "d": src.d.state_dict(),
                "g_ema": src.g_ema.state_dict(), **adams}, path)
    pt = train.Trainer(train.TrainConfig(**train_kw(ckpt=path, load_train_state=True)),
                       device="cpu")
    assert pt.start_iter == 124
    assert pt.g_opt.param_groups[0]["step"] == 2
    first = next(iter(adams["g_optim"]["state"].values()))
    torch.testing.assert_close(pt.g_opt.state[next(pt.g.parameters())]["exp_avg_sq"],
                               first["exp_avg_sq"])


def test_fresh_trainer_without_checkpoints(tmp_path):
    """No ckpt: the student and D are drawn from the seed; the same seed
    gives the same weights. No teacher: the G step has no KD terms."""
    cfg = train.TrainConfig(generated_img_size=16, latent=16, n_mlp=1, batch_size=4,
                            channel_multiplier=1, seed=3)
    a, b = train.Trainer(cfg, device="cpu"), train.Trainer(cfg, device="cpu")
    for x, y in zip(a.d.parameters(), b.d.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    m, _ = a.step(1, reals(1)[0], torch.zeros(()))
    assert set(m) == {"d", "real_score", "fake_score", "g"}
    assert all(np.isfinite(float(v)) for v in m.values())


def test_loader_gives_the_jax_loaders_batches(tmp_path):
    cache = tmp_path / "uint8_cache_16.npy"
    np.save(cache, (np.random.RandomState(0).rand(10, 16, 16, 3) * 255).astype(np.uint8))
    mine = infinite_loader(open_dataset(str(tmp_path), 16), 4, seed=5, uint8_hwc=True)
    theirs = jax_infinite_loader(jax_open_dataset(str(tmp_path), 16), 4, seed=5,
                                 uint8_hwc=True)
    try:
        for _ in range(6):  # three epochs of two full batches
            np.testing.assert_array_equal(next(mine), next(theirs))
    finally:
        mine.close()
        theirs.close()
    with pytest.raises(FileNotFoundError, match="uint8 cache"):
        open_dataset(str(tmp_path / "missing"), 16)
    with pytest.raises(ValueError, match="16px"):
        open_dataset(str(cache), 32)


def test_logger_writes_the_jax_loggers_lines(tmp_path):
    m = {"d": 1.23456, "g": 0.5, "kd_l1_loss": 3.0, "kd_lpips_loss": 0.0, "r1": 0.01,
         "path": 0.2, "mean_path_avg": 0.123456}
    for cls, name in ((ExperimentLogger, "port"), (JaxLogger, "jax")):
        logger = cls(str(tmp_path), name=name)
        logger.log_iteration(7, 0.25, m)
        logger.close()
    lines = {}
    for name in ("port", "jax"):
        out = next((tmp_path / name).glob("*_training_log.out")).read_text()
        lines[name] = (out, (tmp_path / name / "metrics.jsonl").read_text())
    assert lines["port"] == lines["jax"]
    assert json.loads(lines["port"][1])["iter"] == 7


def test_trainer_refuses_unported_terms():
    """In-loop FID needs both Inception and real statistics, as in the JAX
    Trainer: either alone turns it off (it is ported and driven in
    test_torch_eval_cli.py, as the KD objective's aux nets are in
    test_torch_full_kd_trainer.py); a CUDA trainer without a card raises."""
    cfg = train.TrainConfig(generated_img_size=16, latent=16, n_mlp=1, channel_multiplier=1)
    from torch_eval_util import inception_tree

    for kw in ({"inception_params": inception_tree()}, {"real_stats": "stats.pkl"}):
        trainer = train.Trainer(cfg, device="cpu", **kw)
        assert trainer.inception is None and trainer.real_stats is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.Trainer(train.TrainConfig(generated_img_size=16, latent=16, n_mlp=1))


def test_save_checkpoint_keeps_optax_keys_whole(tmp_path):
    path = str(tmp_path / "o.npz")
    save_checkpoint(path, {"g_optim": {"[0].count": torch.tensor(3, dtype=torch.int32),
                                       "[0].nu['a']['b']": torch.ones(2)}})
    with np.load(path) as z:
        assert {"g_optim/[0].count", "g_optim/[0].nu['a']['b']"} <= set(z.files)
