"""The port's ``bench`` and ``train_time_profiler`` over 2 gloo ranks on the
CPU (``tests/torch_dp_util.py:spawn``, as torchrun's ranks run them: the
process group is up before ``main``), at 16px, global batch 4, without
the full objective: rank 0 alone prints, with ``world_size``; each rank
prepares its rows of the one seeded global batch; the replicas end
bit-equal; ``vs_baseline`` is scaled by the global batch and ``mfu`` and
``hw_flop_util`` divide by the two ranks' summed peak; the traces come one
per rank; the profiler's calls are one process's and its phase means the
slowest rank's. The line's keys hold every key of the JAX round's
``bench.py:_report``, read from its source."""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from content_aware_gan_compression_torch import bench
from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
from content_aware_gan_compression_torch.train import TrainConfig
from torch_dp_util import bench_and_profiler, spawn
from torch_train_util import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SIZE, GLOBAL_BATCH, WORLD = 16, 4, 2
PEAK = 1e-3  # TFLOP/s: a peak that makes a 16px CPU run's utilizations readable
REG_EVERY = 1  # bench's R1 and path length every iteration here: its traced cadence is 1
SLOW_EMA_S = 0.05
BENCH_ARGV = ["--device", "cpu", "--size", str(SIZE), "--batch_size", str(GLOBAL_BATCH),
              "--no-full_objective", "--warmup", "1", "--iters", "2", "--dtype", "float32"]
PROFILER_ARGV = ["--device", "cpu", "--size", str(SIZE), "--batch_size", str(GLOBAL_BATCH),
                 "--iters", "2", "--dtype", "float32"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 2-rank spawn: bench with ``--trace_dir``, its peak ``PEAK`` and
    its regularizers every ``REG_EVERY``, then the profiler with
    ``--trace_dir`` at the default cadences, rank 1's EMA slowed."""
    d = tmp_path_factory.mktemp("bench_world")
    return d, spawn(bench_and_profiler, WORLD, d,
                    BENCH_ARGV + ["--trace_dir", str(d / "bench_trace")],
                    PROFILER_ARGV + ["--trace_dir", str(d / "profile")], 1, SLOW_EMA_S, PEAK,
                    REG_EVERY)


def test_bench_prints_one_line_from_rank_zero(ranks):
    _, out = ranks
    lines = out[0]["bench_stdout"].strip().splitlines()
    assert len(lines) == 1 and out[1]["bench_stdout"] == ""
    line = json.loads(lines[0])
    assert line == out[0]["bench"]
    assert line["world_size"] == WORLD and line["metric"] == "retrain_iters_per_sec_16px"
    assert line["objective"] == "gan_l1" and line["value"] > 0
    assert line["peak_memory_gb"] is None


def test_bench_ranks_take_their_rows_and_stay_equal(ranks):
    _, out = ranks
    real = torch.randint(0, 256, (GLOBAL_BATCH, SIZE, SIZE, 3),
                         generator=torch.Generator().manual_seed(9), dtype=torch.uint8)
    k = GLOBAL_BATCH // WORLD
    for r in range(WORLD):
        assert torch.equal(out[r]["real"], real[r * k:(r + 1) * k])
    for net in ("g", "d", "g_ema"):
        for name, v in out[0][net].items():
            assert torch.equal(v, out[1][net][name]), (net, name)
    # and the window trained them: G is no longer its seeded start
    start = Generator(GeneratorConfig(size=SIZE, net_shape=bench.student_shape(SIZE, 0.7)),
                      device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    assert any(not torch.equal(v, start[k]) for k, v in out[0]["g"].items())


def test_bench_scales_by_the_global_batch_and_the_world_peak(ranks):
    d, out = ranks
    line = out[0]["bench"]
    ips = line["value"]
    # vs_baseline: images/s of the global batch over the reference's 16 a step
    assert line["vs_baseline"] == pytest.approx(
        ips * GLOBAL_BATCH / (bench.REFERENCE_ITERS_PER_SEC * 16), abs=2e-4)
    args = bench.parse_args(BENCH_ARGV)
    meta = {k: Generator(GeneratorConfig(size=SIZE, net_shape=ns), device="meta")
            for k, ns in (("g", bench.student_shape(SIZE, args.remove_ratio)), ("t", None))}
    cfg = TrainConfig(generated_img_size=SIZE, batch_size=GLOBAL_BATCH, d_reg_freq=REG_EVERY,
                      g_reg_freq=REG_EVERY)
    macs = bench.iteration_macs(args, cfg, meta["g"], meta["t"])
    world_peak = WORLD * PEAK * 1e12
    assert line["mfu"] == pytest.approx(macs * 2 * ips / world_peak, rel=2e-3, abs=1e-4)
    # the traced cadence: one file per rank, the world's FLOPs per iteration
    assert sorted(p.name for p in (d / "bench_trace").iterdir()) == [
        "bench_trace_rank0.json", "bench_trace_rank1.json"]
    flops = line["executed_tflop_per_iter"] * 1e12
    assert flops > 2 * macs * 0.5  # at least the model's MACs' share (R1, path length on top)
    assert line["hw_flop_util"] == pytest.approx(flops * ips / world_peak, rel=2e-3)


def test_profiler_over_two_ranks(ranks):
    d, out = ranks
    lines = out[0]["profiler_stdout"]
    assert out[1]["profiler_stdout"] == "" and json.loads(lines) == out[0]["profiler"]
    report = out[0]["profiler"]
    assert report == out[1]["profiler"] and report["world_size"] == WORLD
    calls = {k: v["calls"] for k, v in report.items() if isinstance(v, dict) and "calls" in v}
    # R1 and path length at iteration 0, as one process calls them
    assert calls == {"data": 2, "d_step": 2, "d_reg_step": 1, "g_step": 2, "g_reg_step": 1,
                     "ema": 2}
    # rank 1's slow EMA is the report's: the phase means are the slowest rank's
    assert report["ema"]["mean_ms"] >= 1000 * SLOW_EMA_S
    assert report["amortized_iter_ms"] == pytest.approx(sum(
        v["mean_ms"] * v["calls"] for k, v in report.items() if k in calls) / 2, abs=0.05)
    assert sorted(p.name for p in (d / "profile").iterdir()) == [
        "train_time_profile_rank0.json", "train_time_profile_rank1.json"]


def _jax_report_keys():
    """The keys the JAX round's ``bench.py:_report`` can print: its ``out``
    dict's and every ``out[...] =``, read from the source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    (fn,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "_report"]
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "out" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            target = node.targets[0]
            if isinstance(target.value, ast.Name) and target.value.id == "out":
                keys.add(target.slice.value)
    return keys


def test_bench_line_keys_hold_the_jax_report_keys(ranks):
    want = _jax_report_keys()
    assert {"executed_tflop_per_iter", "hw_flop_util", "mfu", "vs_baseline"} <= want
    line = ranks[1][0]["bench"]
    assert want <= set(line), want - set(line)
    assert all(math.isfinite(line[k]) for k in want if k not in ("metric", "unit", "objective"))
