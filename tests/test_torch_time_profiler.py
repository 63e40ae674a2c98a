"""The port's train_time_profiler on the CPU at 16px: the JAX script's JSON
keys, each phase called at its cadence (R1 every 16 iterations, path length
every 4: over 4 iterations d_reg_step 1, g_step 4, g_reg_step 1), the
profiler's Chrome trace, and ``--remat``."""

import json
import os

from content_aware_gan_compression_torch import train_time_profiler
from torch_train_util import record_train_configs
from torch_train_util import torch_threads  # noqa: F401


def test_prints_the_jax_keys_at_the_cadences(tmp_path, capsys, monkeypatch):
    """The report's keys and calls; ``--remat`` reaches the steps'
    ``TrainConfig``."""
    trace = tmp_path / "trace"
    made = record_train_configs(monkeypatch)
    report = train_time_profiler.main(["--device", "cpu", "--size", "16", "--batch_size", "2",
                                       "--iters", "4", "--dtype", "float32",
                                       "--trace_dir", str(trace), "--remat"])
    assert [c.remat for c in made] == [True]
    assert train_time_profiler.parse_args([]).remat is False
    assert json.loads(capsys.readouterr().out) == report
    assert list(report) == ["compile_s", "data", "d_step", "d_reg_step", "g_step", "g_reg_step",
                            "ema", "amortized_iter_ms"]
    assert list(report["compile_s"]) == ["d_step", "d_reg_step", "g_step", "g_reg_step", "ema"]
    calls = {k: v["calls"] for k, v in report.items() if isinstance(v, dict) and "calls" in v}
    assert calls == {"data": 4, "d_step": 4, "d_reg_step": 1, "g_step": 4, "g_reg_step": 1,
                     "ema": 4}
    assert all(report[k]["mean_ms"] >= 0 for k in calls)
    assert report["amortized_iter_ms"] > 0
    with open(os.path.join(trace, "train_time_profile.json")) as f:
        assert json.load(f)["traceEvents"]
