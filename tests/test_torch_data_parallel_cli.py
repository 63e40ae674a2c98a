"""The port's data parallel outside the steps, on the CPU (gloo ranks from
``torch_dp_util.spawn``, and torchrun for the CLI): the loader's shards, the
FID feature stream and the get_fid CLI, the sparsity trainer with a prune
event, and the train CLI under ``python -m torch.distributed.run``; each
against the same thing in one process. Also the helpers without a process
group, and the init's refusals.

Tolerances: the FID features within 1e-4 of the largest feature (the
evaluation tests' bound); the sparsity and CLI records at 1e-4 relative and
1e-5 absolute (the trajectory tests'); widths, shards and loader rows exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from content_aware_gan_compression_torch import parallel
from content_aware_gan_compression_torch.data import FFHQDataset, data_loader, open_dataset
from content_aware_gan_compression_torch.train.__main__ import main as train_main
from torch_dp_util import fid_streams, fid_streams_and_sparsity_run, sparsity_run, spawn
from torch_eval_util import inception_tree, write_fid_inception
from torch_train_util import N_MLP, SIZE, STYLE, train_kw, write_checkpoints
from torch_train_util import torch_threads  # noqa: F401

REPO = str(Path(__file__).resolve().parents[1])
RTOL, ATOL = 1e-4, 1e-5


def _close_records(got, want):
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k in ("train_time",):
                continue
            np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL, err_msg=f"{w['iter']} {k}")


# -- no process group --------------------------------------------------------------


def test_helpers_are_the_identity_without_a_process_group():
    x = torch.randn(6, 3, requires_grad=True)
    assert not parallel.active()
    assert (parallel.rank(), parallel.world_size(), parallel.is_main()) == (0, 1, True)
    assert parallel.shard_rows(x) is x and parallel.gather_rows(x) is x
    assert parallel.mean_over_ranks(x) is x and parallel.broadcast_object([3]) == [3]
    assert torch.equal(parallel.global_mean(x), x.mean())
    assert torch.equal(parallel.global_mean(x, dim=0), x.mean(0))
    x.sum().backward()
    before = x.grad.clone()
    parallel.all_reduce_grads([x])
    parallel.broadcast_module(torch.nn.Linear(2, 2))
    assert torch.equal(x.grad, before)
    assert parallel.initialize("cpu") == torch.device("cpu") and not parallel.active()


def test_draws_keep_the_one_process_stream():
    """Without a process group the path-length step's draws are the
    one-process stream in its order: the z pair, the mixing coin and index,
    the noise maps, then y's standard normal."""
    from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
    from content_aware_gan_compression_torch.train import TrainConfig, draw_g_reg

    g = Generator(GeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                                  net_shape=(16, 12, 12, 8, 8, 6)), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    cfg = TrainConfig(generated_img_size=SIZE, latent=STYLE, n_mlp=N_MLP, batch_size=4)
    got = draw_g_reg(torch.Generator().manual_seed(1), g, cfg)
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(2, 2, STYLE, generator=gen)
    torch.rand((), generator=gen)
    torch.randint(1, g.config.n_latent, (), generator=gen)
    noise = g.make_noise(2, gen)
    y = torch.randn(2, SIZE, SIZE, 3, generator=gen)
    assert torch.equal(got["z"][0], z[0]) and torch.equal(got["z"][1], z[1])
    assert all(torch.equal(a, b) for a, b in zip(got["noise"], noise))
    assert torch.equal(got["ppl_noise"], y)


def test_device_for_rank_and_the_init_refusals(monkeypatch, tmp_path):
    """``cuda:LOCAL_RANK`` for a bare cuda device, raising past the last
    card (never wrapping); an index or the CPU as given. A failed NCCL init
    raises and leaves no group: nothing falls back to gloo."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.device_for_rank("cuda") == torch.device("cuda", 1)
    assert parallel.device_for_rank("cuda:0") == torch.device("cuda", 0)
    assert parallel.device_for_rank("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1"):
        parallel.device_for_rank("cuda")
    with pytest.raises(Exception):
        parallel.initialize("cpu", backend="nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    assert not parallel.active()


# -- the loader's shards -----------------------------------------------------------


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    """A uint8 cache, a folder of 16px PNGs and a folder of 16px and 24px
    PNGs (float batches of mixed sizes take the per-image path)."""
    from PIL import Image

    d = tmp_path_factory.mktemp("dp_images")
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (20, SIZE, SIZE, 3), np.uint8)
    cache = str(d / "cache.npy")
    np.save(cache, images)
    (d / "png").mkdir()
    (d / "mixed").mkdir()
    for i, img in enumerate(images):
        Image.fromarray(img).save(d / "png" / f"{i:03d}.png")
        side = SIZE if i % 3 else 24
        Image.fromarray(rng.randint(0, 256, (side, side, 3), np.uint8)).save(
            d / "mixed" / f"{i:03d}.png")
    return {"cache": cache, "png": str(d / "png"), "mixed": str(d / "mixed")}


@pytest.mark.parametrize("source,uint8", [("cache", True), ("png", True), ("png", False),
                                          ("mixed", False)])
def test_sharded_loader_reads_its_rows_of_each_global_batch(image_dirs, source, uint8):
    """Each of 2 shards gives rows [r*4, (r+1)*4) of the one-process
    loader's batches of 8, over three epochs' worth of batches."""
    path = image_dirs[source]
    dataset = open_dataset(path, SIZE) if source == "cache" else FFHQDataset(path, SIZE)
    kw = dict(seed=5, uint8_hwc=uint8, num_workers=2)
    loaders = [data_loader(dataset, 8, **kw)] + [
        data_loader(dataset, 8, shard=(r, 2), **kw) for r in range(2)]
    try:
        for _ in range(6):
            whole, *shards = [next(loader) for loader in loaders]
            np.testing.assert_array_equal(np.concatenate(shards), whole)
    finally:
        for loader in loaders:
            loader.close()
    with pytest.raises(ValueError, match="does not split"):
        data_loader(dataset, 7, shard=(0, 2), **kw)


# -- FID ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fid_files(tmp_path_factory):
    from content_aware_gan_compression_torch.evaluation.fid import feature_stats
    from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
    from content_aware_gan_compression_torch.utils import save_checkpoint

    d = tmp_path_factory.mktemp("dp_fid")
    g = Generator(GeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                                  net_shape=(16, 12, 12, 8, 8, 8)), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    ckpt = str(d / "g.npz")
    save_checkpoint(ckpt, {"g": g.state_dict(), "g_ema": g.state_dict()})
    inception = write_fid_inception(d / "inception.pth", inception_tree())
    stats = str(d / "stats.pkl")
    import pickle

    feats = np.random.RandomState(1).randn(40, 256)
    with open(stats, "wb") as f:
        pickle.dump(feature_stats(feats), f)
    return ckpt, inception, stats


def test_fid_stream_on_two_ranks_equals_one_process(fid_files, two_rank_runs):
    """The feature stream at batch 4 (2 rows a rank, gathered) and at batch
    3 (the whole batch on every rank) equals one process's within 1e-4 of
    the largest feature on both ranks; the synchronous, overlapped and CLI
    scores agree with one process's and across ranks."""
    ckpt, inception, stats = fid_files
    one = fid_streams(ckpt, inception, SIZE, STYLE, N_MLP, stats)
    ranks = [r["fid"] for r in two_rank_runs]
    for r in ranks:
        for key in ("features_4", "features_3"):
            want = one[key]
            assert r[key].shape == want.shape == (10, 256)
            assert np.abs(r[key] - want).max() <= 1e-4 * np.abs(want).max(), key
        for key in ("fid", "overlapped", "cli"):
            np.testing.assert_allclose(r[key], one[key], rtol=1e-4, err_msg=key)
        assert r["overlapped"] == r["fid"] == r["cli"]
    for key in ("features_4", "features_3", "fid"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


# -- the sparsity trainer -----------------------------------------------------------------

SPARSITY_OPTS = dict(sparsity_eta=1e-2, model_prune_freq=2, num_rmve_channel=9,
                     pruning_mode="Global_Number", prune_metric="l1-style",
                     kd_percept_mode="VGG")


@pytest.fixture(scope="module")
def train_files(tmp_path_factory, fid_files):
    d = tmp_path_factory.mktemp("dp_train")
    student, teacher = write_checkpoints(d)
    cache = str(d / "cache.npy")
    np.save(cache, np.random.RandomState(2).randint(0, 256, (24, SIZE, SIZE, 3), np.uint8))
    _, inception, stats = fid_files
    return {"dir": d, "student": student, "teacher": teacher, "cache": cache,
            "inception": inception, "stats": stats}


def _sparsity_kw(train_files):
    return train_kw(ckpt=train_files["student"], teacher=train_files["teacher"],
                    data_folder=train_files["cache"], batch_size=8, kd_l1_lambda=1.0,
                    kd_lpips_lambda=0.0, kd_mode="Intermediate", g_reg_freq=2,
                    val_sample_num=4, val_sample_freq=2, model_save_freq=10000)


@pytest.fixture(scope="module")
def two_rank_runs(fid_files, train_files, tmp_path_factory):
    """One 2-rank spawn for the FID streams and the sparsity run: each
    rank's {"fid": fid_streams, "sparsity": sparsity_run}."""
    ckpt, inception, stats = fid_files
    d = tmp_path_factory.mktemp("two_rank_runs")
    return spawn(fid_streams_and_sparsity_run, 2, d,
                 (ckpt, inception, SIZE, STYLE, N_MLP, stats),
                 (_sparsity_kw(train_files), SPARSITY_OPTS, str(d / "two"), 3))


def test_sparsity_prune_event_on_two_ranks(train_files, two_rank_runs, tmp_path):
    """``SparsityTrainer.run`` over iterations 0-2 with the prune event
    after iteration 2, global batch 8 from a uint8 cache: both ranks cut to
    the one-process run's widths, rank 0 logs its records (the sparse
    penalty over the global batch) and the ranks end bit-equal."""
    one = sparsity_run(_sparsity_kw(train_files), SPARSITY_OPTS, str(tmp_path / "one"), 3)
    ranks = [r["sparsity"] for r in two_rank_runs]
    assert one["net_shape"] != (16, 12, 12, 8, 8, 6)
    assert ranks[0]["net_shape"] == ranks[1]["net_shape"] == one["net_shape"]
    assert ranks[1]["records"] == []
    _close_records(ranks[0]["records"], one["records"])
    assert any("net_shape" in r for r in ranks[0]["records"])
    for k, v in ranks[0]["g"].items():
        assert torch.equal(v, ranks[1]["g"][k]), k


# -- the train CLI under torchrun -------------------------------------------------------------


def test_train_cli_under_torchrun_writes_one_log_and_checkpoint(train_files, tmp_path):
    """``python -m torch.distributed.run --nproc_per_node=2`` runs the train
    CLI on the CPU for 2 iterations at a global batch of 8, with the in-loop
    FID after iteration 1 (8 samples, batch 4): rank 0 writes the one
    experiment folder (log, records, grids, the checkpoint of iteration 1),
    whose records, the FID's included, equal the one-process CLI's."""
    args = ["--path", train_files["cache"], "--size", str(SIZE), "--latent", str(STYLE),
            "--n_mlp", str(N_MLP), "--ckpt", train_files["student"], "--teacher_ckpt",
            train_files["teacher"], "--batch_size", "8", "--iter", "2", "--n_sample", "4",
            "--val_sample_freq", "1", "--model_save_freq", "1", "--content_aware_KD", "False",
            "--kd_lpips_lambda", "0", "--inception_ckpt", train_files["inception"],
            "--real_stats", train_files["stats"], "--fid_n_sample", "8", "--fid_batch", "4",
            "--device", "cpu"]
    two_root = tmp_path / "two"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "content_aware_gan_compression_torch.train", *args, "--exp_root",
         str(two_root)], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Training Start") == 1 and "2 process(es)" in proc.stdout
    (exp,) = [p for p in two_root.iterdir() if p.is_dir()]
    assert len(list(exp.glob("*_training_log.out"))) == 1
    assert sorted(os.listdir(exp / "ckpt")) == ["000001.npz"]
    assert sorted(os.listdir(exp / "sample")) == ["000000.png", "000001.png"]
    one_root = tmp_path / "one"
    train_main([*args, "--exp_root", str(one_root)])
    (one_exp,) = [p for p in one_root.iterdir() if p.is_dir()]
    records = [[json.loads(line) for line in open(e / "metrics.jsonl")] for e in (exp, one_exp)]
    assert [r["iter"] for r in records[0]] == [0, 1, 1]
    assert "fid" in records[0][-1] and np.isfinite(records[0][-1]["fid"])
    _close_records(*records)
