"""bfloat16 end to end on the CPU: the train CLI with ``--dtype bfloat16
--opt_state_dtype bfloat16`` at 16px, Adam's bfloat16 second moment through
save and resume in the ``.npz`` format (as uint16 bits with the manifest's
``dtypes`` entry, as the JAX package writes it) and in a reference-style
``.pt``, and ``python -m content_aware_gan_compression_torch.bench``'s one
JSON line, with ``bench.py``'s keys and MAC count."""

import json

import numpy as np
import pytest
import jax
import torch

from content_aware_gan_compression_tpu.models import GeneratorConfig as JaxGeneratorConfig
from content_aware_gan_compression_tpu.models import generator_init
from content_aware_gan_compression_tpu.utils import load_checkpoint as jax_load_checkpoint
from content_aware_gan_compression_tpu.utils.calculators import (
    bisenet_flops, discriminator_flops, stylegan2_flops, vgg16_lpips_flops)
from content_aware_gan_compression_torch import bench, train
from content_aware_gan_compression_torch.train.__main__ import main as train_main
from content_aware_gan_compression_torch.utils import load_checkpoint
from torch_train_util import (
    N_MLP, SIZE, STYLE, record_train_configs, train_kw, write_checkpoints)
from torch_train_util import torch_threads  # noqa: F401

BF = torch.bfloat16


def _args(tmp_path, teacher, *extra):
    cache = tmp_path / "data.npy"
    np.save(cache, (np.random.RandomState(0).rand(8, SIZE, SIZE, 3) * 255).astype(np.uint8))
    return ["--path", str(cache), "--size", str(SIZE), "--latent", str(STYLE),
            "--n_mlp", str(N_MLP), "--batch_size", "4", "--teacher_ckpt", teacher,
            "--n_sample", "4", "--val_sample_freq", "1", "--model_save_freq", "1",
            "--d_reg_every", "2", "--g_reg_every", "2", "--device", "cpu",
            "--dtype", "bfloat16", "--opt_state_dtype", "bfloat16", *extra]


def _exp(root):
    (exp,) = [p for p in root.iterdir() if p.name.startswith("Exp_")]
    return exp


def test_train_cli_bf16_saves_and_resumes_bf16_nu(tmp_path, capsys):
    """Two iterations, then a resume: the metrics are finite, the
    checkpoint holds every nu as bfloat16 bits that the JAX package reads
    back as bfloat16, and the resumed run starts at iteration 2 with those
    moments, still bfloat16."""
    student, teacher = write_checkpoints(tmp_path)
    train_main(_args(tmp_path, teacher, "--ckpt", student, "--iter", "2",
                     "--exp_root", str(tmp_path / "a"), "--remat"))
    out = capsys.readouterr().out
    assert "Compute dtype: bfloat16" in out and "Remat: True" in out
    exp = _exp(tmp_path / "a")
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [0, 1]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    ckpt = exp / "ckpt" / "000001.npz"
    trees, _ = load_checkpoint(str(ckpt))
    nus = {k: v for k, v in trees["g_optim"].items() if k.startswith("[0].nu")}
    assert nus and all(v.dtype == BF for v in nus.values())
    jax_trees, _ = jax_load_checkpoint(str(ckpt))
    key = next(iter(nus))
    assert jax_trees["g_optim"][key].dtype.name == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jax_trees["g_optim"][key], np.float32),
                                  nus[key].float().numpy())

    train_main(_args(tmp_path, teacher, "--ckpt", str(ckpt), "--load_train_state", "True",
                     "--iter", "3", "--exp_root", str(tmp_path / "b")))
    recs = [json.loads(line) for line in
            (_exp(tmp_path / "b") / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [2]
    for opt_state_dtype, want in (("bfloat16", BF), ("float32", torch.float32)):
        pt = train.Trainer(train.TrainConfig(**train_kw(
            ckpt=str(ckpt), load_train_state=True, compute_dtype="bfloat16",
            opt_state_dtype=opt_state_dtype)), device="cpu")
        assert pt.start_iter == 2
        assert pt.g_opt.param_groups[0]["step"] == int(trees["g_optim"]["[0].count"])
        nu = pt.g_opt.state[pt.g.conv1.conv.weight]["exp_avg_sq"]
        assert nu.dtype == want
        torch.testing.assert_close(nu.float(), nus["[0].nu['conv1']['conv']['weight']"].float(),
                                   rtol=0, atol=0)


def test_reference_pt_with_bf16_nu_keeps_the_configured_type(tmp_path):
    """A reference-style .pt whose Adam state holds a bfloat16 second
    moment: loaded into opt_state_dtype bfloat16 it stays bfloat16, into
    float32 it is widened, exactly either way."""
    student, _ = write_checkpoints(tmp_path)
    src = train.Trainer(train.TrainConfig(**train_kw(ckpt=student)), device="cpu")
    adams = {}
    for name, module in (("g_optim", src.g), ("d_optim", src.d)):
        opt = torch.optim.Adam(module.parameters(), lr=0.002, betas=(0.0, 0.99))
        for p in module.parameters():
            p.grad = torch.randn_like(p)
        opt.step()
        sd = opt.state_dict()
        for s in sd["state"].values():
            s["exp_avg_sq"] = s["exp_avg_sq"].to(BF)
        adams[name] = sd
    path = str(tmp_path / "000007.pt")
    torch.save({"g": src.g.state_dict(), "d": src.d.state_dict(),
                "g_ema": src.g_ema.state_dict(), **adams}, path)
    first = next(iter(adams["d_optim"]["state"].values()))["exp_avg_sq"]
    for opt_state_dtype, want in (("bfloat16", BF), ("float32", torch.float32)):
        pt = train.Trainer(train.TrainConfig(**train_kw(
            ckpt=path, load_train_state=True, opt_state_dtype=opt_state_dtype)), device="cpu")
        nu = pt.d_opt.state[next(pt.d.parameters())]["exp_avg_sq"]
        assert pt.start_iter == 8 and nu.dtype == want
        torch.testing.assert_close(nu.float(), first.float(), rtol=0, atol=0)


@pytest.mark.parametrize("metric", ["retrain", "generate"])
def test_bench_prints_one_json_line(capsys, monkeypatch, metric):
    """The bench on the CPU at 16px (bfloat16 by default): one JSON line
    with bench.py's keys; the retrain line with ``gan_l1`` here, as the
    full objective's full-width BiSeNet at 512px is too slow for the CPU,
    and with ``--remat``, which reaches the steps' ``TrainConfig`` and the
    line (peak memory is null on the CPU)."""
    made = record_train_configs(monkeypatch)
    bench.main(["--device", "cpu", "--size", "16", "--iters", "2", "--warmup", "1",
                "--batch_size", "2", "--no-full_objective", "--metric", metric, "--remat"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    if metric == "generate":
        assert set(out) == {"metric", "value", "unit", "vs_baseline"}
        assert out["metric"] == "generate_16px_images_per_sec_per_chip" and out["value"] > 0
        return
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "mfu", "objective", "remat",
                        "peak_memory_gb"}
    assert (out["metric"], out["unit"], out["objective"]) == (
        "retrain_iters_per_sec_16px", "iter/s", "gan_l1")
    assert out["value"] > 0 and out["mfu"] >= 0
    assert out["remat"] is True and out["peak_memory_gb"] is None
    assert [c.remat for c in made] == [True]
    assert bench.parse_args([]).dtype == "bfloat16" and bench.parse_args([]).remat is False


def test_bench_counts_bench_py_macs():
    """iteration_macs is bench.py's per-iteration MAC count, each term from
    the JAX package's calculators, at 32px with the full objective."""
    size = 32
    args = bench.parse_args(["--size", str(size)])
    shape = bench.student_shape(size, args.remove_ratio)
    jax_macs = {k: stylegan2_flops(jax.eval_shape(  # shapes only: no weights drawn
        lambda key: generator_init(key, JaxGeneratorConfig(size=size, net_shape=ns)),
        jax.random.PRNGKey(0))) for k, ns in (("g", shape), ("t", None))}
    from content_aware_gan_compression_torch.models import Generator, GeneratorConfig

    meta = {k: Generator(GeneratorConfig(size=size, net_shape=ns), device="meta")
            for k, ns in (("g", shape), ("t", None))}
    cfg = train.TrainConfig()
    b, d_macs = args.batch_size, discriminator_flops(size)
    want = (b * (jax_macs["g"] + 2 * 3 * d_macs) + b * (3 * jax_macs["g"] + 2 * d_macs
                                                        + jax_macs["t"])
            + b * (2 * 3 * d_macs) / cfg.d_reg_freq
            + (b // cfg.path_reg_batch_shrink) * (2 * 3 * jax_macs["g"]) / cfg.g_reg_freq
            + b * (3 * vgg16_lpips_flops(256) + bisenet_flops(512)))
    assert bench.iteration_macs(args, cfg, meta["g"], meta["t"]) == want
