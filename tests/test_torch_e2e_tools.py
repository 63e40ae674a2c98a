"""The port's end-to-end checks (``tools/e2e_validation.py`` and
``tools/fid_descent_validation.py`` of the port) on the CPU at 16px, each
one pass with narrow nets and its CLIs' ``main`` in this process (``bench``
in a process of its own): every CLI exits cleanly and every rate, FID and
PPL is finite and positive. The
seeded files (``tools/fixtures.py``) load through the port's importers; the
steady-rate reader gives what the JAX round's ``tools/e2e_validation.py:
steady_rate`` gives on the same ``metrics.jsonl``, and the FID-series reader
what its ``fid_descent_validation.py`` reads; both kinds of real-statistics
pickle (the fixture's, ``calc_inception``'s) read in the JAX package's
``calc_fid`` schema."""

import json
import math
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from content_aware_gan_compression_tpu.evaluation import fid as jfid
from content_aware_gan_compression_torch.evaluation import calc_fid
from content_aware_gan_compression_torch.models import (
    BiSeNet, load_bisenet, load_fid_inception, load_lpips, pool3_dim)
from content_aware_gan_compression_torch.pruning import get_uniform_remove_list
from content_aware_gan_compression_torch.tools import e2e_validation, fid_descent_validation
from content_aware_gan_compression_torch.tools.fixtures import (
    mask_share, scaled_net_shape, teacher_images)
from content_aware_gan_compression_torch.utils import (
    build_discriminator_from_state_dict, load_checkpoint, load_generator)
from torch_dp_util import capped_children
from torch_train_util import TEST_THREADS, torch_threads  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import e2e_validation as jax_e2e  # noqa: E402  (the JAX round's tool; no JAX import)

SIZE, LATENT, N_MLP, WIDTH = 16, 16, 2, 1 / 32
NETS = ["--size", SIZE, "--latent", LATENT, "--n_mlp", N_MLP, "--width_scale", WIDTH,
        "--aux_width_scale", 0.125, "--inception_width_scale", 0.125, "--batch_size", 2,
        "--fid_batch", 4, "--in_process", "--device", "cpu"]


def _argv(args):
    return [str(a) for a in args]


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """One pass of the e2e tool: 4 iterations from a 32px PNG folder and from
    a 16px cache, R1 and path length every 2, steady from iteration 1 (one
    whole window of 2), the FID at 2; bench 1 + 1, in a process of its own
    that takes this module's thread cap."""
    work = tmp_path_factory.mktemp("e2e")
    with capped_children(TEST_THREADS):
        result = e2e_validation.main(_argv([
            "--workdir", work, "--iters", 4, "--skip", 1, "--n_images", 8, "--src_size", 32,
            "--fid_n_sample", 4, "--bench_warmup", 1, "--bench_iters", 1,
            "--no-bench_full_objective", "--d_reg_every", 2, "--g_reg_every", 2, *NETS]))
    return work, result


@pytest.fixture(scope="module")
def descent(tmp_path_factory):
    """One pass of the FID-descent tool: 8 teacher samples, 4 iterations,
    the FID every 2 over 8 samples, PPL over 2; in a folder that holds a
    file of the user's and an earlier run's outputs."""
    work = tmp_path_factory.mktemp("descent")
    (work / "notes.txt").write_text("the user's")
    (work / "exp" / "Exp_old").mkdir(parents=True)
    (work / "logs").mkdir()
    (work / "logs" / "old_step.log").write_text("an earlier run's")
    result = fid_descent_validation.main(_argv([
        "--workdir", work, "--iters", 4, "--fid_every", 2, "--n_images", 8,
        "--fid_n_sample", 8, "--prune_n_sample", 4, "--prune_batch", 2, "--ppl_n_sample", 2,
        "--no-require_descent", *NETS]))
    return work, result


def test_e2e_validation_runs_both_sources_and_bench(e2e):
    work, result = e2e
    bench = result["bench_iters_per_s"]
    assert bench > 0 and result["bench"]["objective"] == "gan_l1"
    for name, src in result["sources"].items():
        assert src["steady_iters"] == 3 and src["windows"] == 1
        for k in ("window_median_iters_per_s", "median_iters_per_s", "mean_iters_per_s",
                  "wall_s"):
            assert math.isfinite(src[k]) and src[k] > 0, (name, k, src[k])
        assert result["gap_vs_bench"][name] == pytest.approx(
            1 - src["mean_iters_per_s"] / bench)
        assert result["gap_vs_bench_window"][name] == pytest.approx(
            1 - src["window_median_iters_per_s"] / bench)
        assert [f["iter"] for f in src["fid"]] == [2] and src["fid"][0]["fid"] > 0
        with open(os.path.join(src["exp"], "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f if "train_time" in line]
        assert [r["iter"] for r in recs] == [0, 1, 2, 3]
        times = [r["train_time"] for r in recs]
        assert src["window_median_iters_per_s"] == pytest.approx(2 / (times[1] + times[2]))
        assert src["mean_iters_per_s"] == pytest.approx(3 / sum(times[1:]))
    # the loader each source took, from the CLI's own line
    assert "from folder" in result["sources"]["folder"]["loader"]
    assert "resize where not at 16px: Pillow bilinear" in result["sources"]["folder"]["loader"]
    assert "from cache" in result["sources"]["cache"]["loader"]
    assert result["sources"]["folder"]["image_size"] == 32 and result["pillow"]
    assert result["value"] == result["sources"]["cache"]["mean_iters_per_s"]


def test_fid_descent_runs_every_step(descent):
    work, result = descent
    assert set(result["seconds"]) == {
        "files", "dataset", "calc_inception", "prune", "get_fid_teacher", "get_fid_pruned",
        "train", "get_ppl_pruned_iter0", "get_ppl_retrained_final"}
    assert [s["iter"] for s in result["series"]] == [2, 4]
    for v in [result["teacher_fid_noise_floor"], result["student_fid_iter0"],
              result["ppl_pruned_iter0"], result["ppl_retrained_final"],
              *(s["fid"] for s in result["series"])]:
        assert math.isfinite(v) and v > 0
    assert result["descending"] == (result["series"][-1]["fid"] < result["student_fid_iter0"])
    assert result["ppl_final_ckpt"].endswith("000004.npz")
    with open(os.path.join(work, "fid_descent.json")) as f:
        assert json.load(f) == json.loads(json.dumps(result))
    # the user's file stays; the earlier run's outputs went
    assert (work / "notes.txt").read_text() == "the user's"
    assert not (work / "exp" / "Exp_old").exists()
    assert sorted(p.name for p in (work / "logs").iterdir()) == sorted(
        f"{step}.log" for step in set(result["seconds"]) - {"files", "dataset"})
    # the pruned student: the 0.7 uniform widths of the teacher's, D carried
    trees, _ = load_checkpoint(str(next((work / "pruned").glob("*.npz"))))
    full = scaled_net_shape(SIZE, WIDTH)
    want = tuple(c - r for c, r in zip(full, get_uniform_remove_list(list(full), 0.7)))
    g = load_generator(str(next((work / "pruned").glob("*.npz"))), SIZE, LATENT, N_MLP,
                       device="cpu")
    assert g.config.net_shape == want and "d" in trees


def test_fixture_files_load_through_the_importers(e2e):
    work, _ = e2e
    files = work / "files"
    full = scaled_net_shape(SIZE, WIDTH)
    want_student = tuple(c - r for c, r in zip(full, get_uniform_remove_list(list(full), 0.7)))
    for name, shape in (("student16.npz", want_student), ("teacher16.npz", full)):
        trees, meta = load_checkpoint(str(files / name))
        assert set(trees) == {"g", "g_ema", "d"} and meta["size"] == SIZE
        for tree in ("g", "g_ema"):
            g = load_generator(str(files / name), SIZE, LATENT, N_MLP, device="cpu", tree=tree)
            assert g.config.net_shape == shape
        d = build_discriminator_from_state_dict(trees["d"], SIZE, device="cpu")
        assert d(torch.zeros(2, SIZE, SIZE, 3)).shape == (2, 1)  # NHWC
    lpips = load_lpips(str(files / "vgg16.pth"), str(files / "lpips_lins.pth"), device="cpu")
    x = torch.rand(2, 3, SIZE, SIZE) * 2 - 1
    assert torch.isfinite(lpips(x, -x)).all()
    parser = load_bisenet(str(files / "79999_iter.pth"), device="cpu")
    assert isinstance(parser, BiSeNet)
    teacher = load_generator(str(files / "teacher16.npz"), SIZE, LATENT, N_MLP,
                             device="cpu").eval()
    # the picking rule: the parser's mask keeps 2-98% of the teacher's pixels
    assert 0.02 <= mask_share(parser.eval(), teacher_images(teacher, 2)) <= 0.98
    inc = load_fid_inception(str(files / "pt_inception.pth"), device="cpu")
    assert pool3_dim(inc) == 256
    with open(files / "real_stats.pkl", "rb") as f:
        stats = pickle.load(f)
    assert stats["mean"].shape == (256,) and stats["cov"].shape == (256, 256)


def _metrics(root, recs):
    exp = root / "Exp_2026-01-01_00:00:00"
    exp.mkdir(parents=True)
    with open(exp / "metrics.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(exp / "metrics.jsonl")


@pytest.mark.parametrize("skip", [0, 3, 5])
def test_readers_give_what_the_jax_tools_read(tmp_path, skip):
    """A run's records as the train CLI writes them: iteration lines with
    train_time, FID records carrying the iteration they scored (one
    mid-run, one at the end), and an event record without train_time."""
    rng = np.random.RandomState(skip)
    recs = [{"iter": i, "train_time": float(rng.uniform(0.2, 0.4)), "d": 1.0} for i in range(10)]
    recs.insert(6, {"fid": 123.5, "iter": 4})
    recs.insert(9, {"iter": 7, "net_shape": [8, 8], "flops_pct": 50.0})
    recs.append({"fid": 99.25, "iter": 9})
    path = _metrics(tmp_path, recs)
    got = e2e_validation.steady_rate(path, skip)
    want = jax_e2e.steady_rate(str(tmp_path), skip)
    assert got == pytest.approx(want, rel=1e-12)
    # whole windows of 4 from skip: the median window's rate
    times = [r["train_time"] for r in recs if "train_time" in r]
    sums = [sum(times[s:s + 4]) for s in range(skip, 10 - 3, 4)]
    assert e2e_validation.window_rate(path, skip, 4) == (4 / float(np.median(sums)), len(sums))
    # the JAX FID-descent tool's series: every record with "fid", its iter
    assert e2e_validation.fid_series(path) == [{"iter": 4, "fid": 123.5},
                                               {"iter": 9, "fid": 99.25}]


def test_real_stats_pickles_read_in_the_jax_schema(e2e, descent):
    """The fixture's random-feature pickle and calc_inception's: JAX's
    loader and regime check take them, and its calc_fid gives the port's."""
    pickles = [e2e[0] / "files" / "real_stats.pkl", descent[0] / "teacher_stats.pkl"]
    for path in pickles:
        stats = jfid.load_real_stats(str(path))
        jfid._check_regime(stats)
        mean, cov = np.asarray(stats["mean"]), np.asarray(stats["cov"])
        assert mean.dtype == cov.dtype == np.float64 and cov.shape == (len(mean),) * 2
        other_mean = mean + 0.1
        want = jfid.calc_fid(other_mean, 2 * cov, mean, cov)
        assert want > 0
        assert calc_fid(other_mean, 2 * cov, mean, cov) == pytest.approx(want, rel=1e-10)
