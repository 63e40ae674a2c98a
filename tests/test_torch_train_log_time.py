"""The logged per-iteration time of the port's training loop
(``Trainer._run``), with stub steps on a fake clock: an iteration followed by
another logs the time from its start to the next one's (the JAX loop's
pass-boundary time, ``flush_window(pending_w, next_t0=t0)`` in
``content_aware_gan_compression_tpu/train/loop.py``), an iteration flushed at
once (before a sample grid, a checkpoint, an event, and the last one) the
time to that flush, and the sample, checkpoint or event falls in the next
iteration's span, so the times sum to the loop's wall. The JAX loop runs its
window path on the same clock and stub steps."""

import json
import os
import types

import numpy as np
import pytest
import torch
from jax import numpy as jnp
from jax import random

from content_aware_gan_compression_tpu.train import TrainConfig as JaxTrainConfig
from content_aware_gan_compression_tpu.train import loop as jax_loop
from content_aware_gan_compression_torch.train import TrainConfig
from content_aware_gan_compression_torch.train import loop as port_loop
from content_aware_gan_compression_torch.train.loop import Trainer
from content_aware_gan_compression_torch.train.sparsity import SparsityTrainer
from content_aware_gan_compression_torch.utils import ExperimentLogger
from torch_train_util import torch_threads  # noqa: F401

# seconds each stub step takes on the fake clock, iteration by iteration
STEP_SECONDS = [0.75, 0.25, 0.5, 0.125, 1.0, 0.375, 0.25, 0.625, 0.5]


class Clock:
    """``time.time`` of the loops under test: moves only where a stub says."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


class Recorder:
    """The logger interface the loops call, keeping (iteration, time)."""

    sample_dir = ckpt_dir = exp_dir = "unused"

    def __init__(self):
        self.times = []

    def log_iteration(self, iter_idx, train_time, m):
        self.times.append((iter_idx, train_time))

    def write(self, text):
        pass

    def log_fid(self, fid, iter_idx=None):
        pass

    def log_event(self, record):
        pass


def port_trainer(cls, clock, cfg, **attrs):
    """A ``cls`` with stub steps (each moves the clock by its iteration's
    ``STEP_SECONDS``) and only the state ``_run`` reads."""
    tr = object.__new__(cls)
    tr.cfg, tr.device, tr.start_iter, tr.inception = cfg, torch.device("cpu"), 0, None
    tr.gen = torch.Generator().manual_seed(0)

    def step(it, real, mpl, phase_hook=None):
        clock.now += STEP_SECONDS[it]
        return {"d": torch.tensor(float(it)), "g": torch.tensor(-float(it))}, mpl
    tr.step = step
    for k, v in attrs.items():
        setattr(tr, k, v)
    return tr


def run_port(monkeypatch, trainer, logger, clock, iters):
    monkeypatch.setattr(port_loop, "time", clock)
    start = clock.now
    trainer._run(iter([None] * iters), logger, None, None)
    return clock.now - start


def quiet_cfg(iters):
    """A sample grid at iteration 0 only, no checkpoint or FID."""
    return TrainConfig(training_iters=iters, val_sample_freq=10 ** 6, model_save_freq=10 ** 6,
                       val_sample_num=4, latent=8)


def test_every_iteration_logs_its_pass_boundary_time(monkeypatch):
    clock = Clock()
    n = len(STEP_SECONDS)
    rendered = []

    def g_ema(z, generator=None):  # the sample grid of iteration 0 takes 2 s
        clock.now += 2.0
        rendered.append(len(z[0]))
        return torch.zeros(len(z[0]), 3, 4, 4)
    logger = Recorder()
    tr = port_trainer(Trainer, clock, quiet_cfg(n), g_ema=g_ema)
    monkeypatch.setattr(port_loop, "save_image_grid", lambda *a, **k: None)
    wall = run_port(monkeypatch, tr, logger, clock, n)
    assert rendered == [4]
    its, times = zip(*logger.times)
    assert list(its) == list(range(n))
    # iteration 0 is flushed at once for its sample grid: its step's time;
    # iteration 1's span holds the 2 s grid; then t0(it+1) - t0(it), which
    # on this clock is the step's own time; the last one to its flush
    assert times[0] == STEP_SECONDS[0]
    assert times[1] == 2.0 + STEP_SECONDS[1]
    assert list(times[2:]) == STEP_SECONDS[2:]
    assert sum(times) == pytest.approx(wall, abs=1e-9)


def test_sample_checkpoint_and_event_fall_in_the_next_span(monkeypatch, tmp_path):
    """The sparsity trainer's records (its own ``log_iteration``, metrics.jsonl)
    through the same seam, with a prune event after iterations 2, 4 and 6
    (0.5 s each) and a sample grid at 0 and 6 (0.25 s each)."""
    clock = Clock()
    n = 8

    def g_ema(z, generator=None):
        clock.now += 0.25
        return torch.zeros(len(z[0]), 3, 4, 4)

    def prune_in_training():
        clock.now += 0.5
        return (8, 8), 50.0
    cfg = TrainConfig(training_iters=n, val_sample_freq=6, model_save_freq=10 ** 6,
                      val_sample_num=4, latent=8)
    tr = port_trainer(SparsityTrainer, clock, cfg, g_ema=g_ema,
                      opts={"model_prune_freq": 2}, prune_in_training=prune_in_training)
    monkeypatch.setattr(port_loop, "save_image_grid", lambda *a, **k: None)
    logger = ExperimentLogger(str(tmp_path))
    wall = run_port(monkeypatch, tr, logger, clock, n)
    logger.close()
    with open(os.path.join(logger.exp_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    times = {r["iter"]: r["train_time"] for r in recs if "train_time" in r}
    prunes = [r["iter"] for r in recs if "net_shape" in r]
    assert prunes == [2, 4, 6] and sorted(times) == list(range(n))
    # flushed at once: 0 (sample), 2, 4 (prune), 6 (sample and prune), 7
    # (last); the grid and prune times land in the iteration after each
    extra = {1: 0.25, 3: 0.5, 5: 0.5, 7: 0.25 + 0.5}
    assert [times[i] for i in range(n)] == [s + extra.get(i, 0.0)
                                            for i, s in enumerate(STEP_SECONDS[:n])]
    assert sum(times.values()) == pytest.approx(wall, abs=1e-9)
    assert all(r["d"] == r["iter"] for r in recs if "train_time" in r)


@pytest.mark.parametrize("k", [1, 4])
def test_the_jax_window_loop_logs_the_same_spans(monkeypatch, tmp_path, k):
    """The JAX loop's window path (``steps_per_dispatch`` K, no event inside
    the run: iterations 1-8, two windows at K = 4) on the same clock and step
    times: per iteration at K = 1, per window (K x its mean) at K = 4; the
    port logs each iteration's own."""
    n = len(STEP_SECONDS)
    cache = str(tmp_path / "cache.npy")
    np.save(cache, np.zeros((4, 8, 8, 3), np.uint8))
    jax_clock = Clock()
    monkeypatch.setattr(jax_loop, "time", types.SimpleNamespace(time=jax_clock.time))
    jt = object.__new__(jax_loop.Trainer)
    jt.cfg = JaxTrainConfig(data_folder=cache, generated_img_size=8, batch_size=2,
                            training_iters=n, val_sample_freq=10 ** 6, model_save_freq=10 ** 6,
                            val_sample_num=4, latent=8, steps_per_dispatch=k,
                            input_put="overlap")
    jt.rng, jt.start_iter, jt._multi_step = random.PRNGKey(0), 1, object()
    jt.inception_params = jt.real_stats = None

    def put_window(loader, n_steps):
        return [next(loader) for _ in range(n_steps)]

    def step_window(i0, window, mpl, last_reg):
        jax_clock.now += sum(STEP_SECONDS[i0:i0 + len(window)])
        its = jnp.arange(i0, i0 + len(window), dtype=jnp.float32)
        return {"d": its, "g": -its, "mean_path": 0.0 * its}, mpl, last_reg
    jt.put_window, jt.step_window = put_window, step_window
    jax_log = Recorder()
    start = jax_clock.now
    jt.run(logger=jax_log)
    jax_wall = jax_clock.now - start

    clock = Clock()
    port_log = Recorder()
    tr = port_trainer(Trainer, clock, quiet_cfg(n), start_iter=1)
    wall = run_port(monkeypatch, tr, port_log, clock, n - 1)
    jax_times = [t for _, t in jax_log.times]
    port_times = [t for _, t in port_log.times]
    assert [i for i, _ in jax_log.times] == [i for i, _ in port_log.times] == list(range(1, n))
    windows = lambda ts: [sum(ts[i:i + k]) for i in range(0, len(ts), k)]  # noqa: E731
    assert windows(jax_times) == pytest.approx(windows(STEP_SECONDS[1:]), abs=1e-9)
    assert windows(port_times) == pytest.approx(windows(jax_times), abs=1e-9)
    assert port_times == pytest.approx(STEP_SECONDS[1:], abs=1e-9)
    assert sum(jax_times) == pytest.approx(jax_wall, abs=1e-9)
    assert sum(port_times) == pytest.approx(wall, abs=1e-9)
