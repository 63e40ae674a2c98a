"""``correct`` comes out false when the timed path is broken, and the
control fails the limits, at a size the CPU holds.

Each test drives the rest of a run on the CPU (the harness's look for a card
is the one step left out): the driver's set-up, first iterations, window and
comparison with the reference, then ``run.result_line``'s verdict. The
limits are set, as a cell's are, above the sound run's readings (3 times
them here) and below what the control and each fault read."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.control import faults
from benchmark.lib import compare, manifest
from benchmark.lib.context import Context
from benchmark.reference.stylegan2 import channels, full_net_shape

SIZE = 32
TINY = {"size": SIZE, "style_dim": 512, "n_mlp": 8, "channel_multiplier": 2,
        "teacher_net_shape": list(full_net_shape(SIZE)),
        "student_net_shape": [64, 64, 48, 48, 32, 32, 16, 16],
        "discriminator_channels": {str(k): v for k, v in channels(2).items() if k <= SIZE}}
SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def context(cell_name, traffic, limits):
    cell = {**manifest.cell(cell_name), "limits": limits}
    return Context(name=cell_name, cell=cell, config=TINY, traffic=traffic, seed=SEED,
                   seconds=0.0, trace=False, device=torch.device("cpu"), t0=time.time())


def verdict(cell_name, traffic, limits, fault=None):
    """(correct, the numbers) of one run on the CPU, with ``fault`` planted."""
    ctx = context(cell_name, traffic, limits)
    args = bench_run.parse(["--workload", cell_name, "--seed", str(SEED), "--seconds", "0"])
    driver = manifest.driver(traffic["driver"])
    if fault is None:
        out = driver.run(ctx)
    else:
        with faults.plant(fault):
            out = driver.run(ctx)
    line = bench_run.result_line(args, manifest.cell(cell_name), ctx, out)
    assert not bench_run.forbidden_modules()
    return line["correct"], out["numbers"]


TRAIN = {**manifest.traffic("retrain-bf16-b16"), "compute_dtype": "float32", "batch": 4,
         "d_reg_every": 2, "g_reg_every": 2, "real_pool": 3}
FID = {**manifest.traffic("fid-b64-chunk4096"), "batch": 8, "chunk": 32, "check_rows": 8}


@pytest.fixture(scope="module")
def train_limits():
    _, numbers = verdict("retrain-256", TRAIN, {})
    return {k: 3 * v for k, v in numbers.items()}


@pytest.fixture(scope="module")
def fid_limits():
    _, numbers = verdict("eval-256", FID, {})
    return {k: 3 * v for k, v in numbers.items()}


def test_sound_runs_pass(train_limits, fid_limits):
    assert verdict("retrain-256", TRAIN, train_limits)[0]
    assert verdict("eval-256", FID, fid_limits)[0]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_faults_fail(train_limits, fault):
    correct, numbers = verdict("retrain-256", TRAIN, train_limits, fault)
    assert not correct, numbers


def test_altered_answer_fails(fid_limits):
    correct, numbers = verdict("eval-256", FID, fid_limits, "altered_answer")
    assert not correct, numbers


def test_training_control_fails(train_limits):
    """The reference in float8 in the system's place."""
    ts = manifest.driver("train_step")
    ctx = context("retrain-256", TRAIN, train_limits)
    prep = ts.prepare(ctx, TRAIN)
    ref = ts.reference_readings(ctx, TRAIN, prep["pool"], prep["parser_seed"])
    ctl = ts.reference_readings(ctx, TRAIN, prep["pool"], prep["parser_seed"], "float8")
    assert not compare.within(compare.training_numbers(ctl, ref), train_limits)


def test_fid_control_fails(fid_limits):
    """The reference in bfloat16 in the system's place."""
    fs = manifest.driver("fid_stream")
    ctx = context("eval-256", FID, fid_limits)
    rows = {0: fs.checked_rows(SEED, 0, FID["chunk"], FID["check_rows"])}
    gaps = fs.feature_gaps(fs.reference_features(ctx, rows, "bfloat16"),
                           fs.reference_features(ctx, rows))
    assert not compare.within({"features": float(gaps.max())}, fid_limits)
