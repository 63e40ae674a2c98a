"""The port's ``train_sparsity`` CLI in-process with ``main(argv)`` and
``--device cpu``, at 16px on checkpoints the JAX package wrote and a uint8
cache, against the JAX pipeline's rules:

- 4 iterations with a Layer_Uniform prune event at iteration 2: the logged
  shape is the JAX rule's (``int(c * ratio)`` off each of the model's own
  widths below 256px), its FLOPs % the JAX calculator's, the reference log
  block and line fields are written, iteration 3 trains the cut student,
  and the checkpoint saved after the prune loads in the JAX package at the
  new widths;
- without the VGG16 file the percept term is dropped with the JAX CLI's
  warning, and a teacher-less run keeps no LPIPS.
"""

import json
import os
import re

import numpy as np
import pytest

from content_aware_gan_compression_tpu.utils import load_checkpoint as jax_load_checkpoint
from content_aware_gan_compression_tpu.utils.calculators import (
    GENERATOR_FLOPS_256PX, styled_conv_flops)
from content_aware_gan_compression_tpu.utils.checkpoint import build_generator_from_pytree
from content_aware_gan_compression_torch import train_sparsity
from torch_eval_util import lpips_tree, write_lpips_files
from torch_train_util import BATCH, G_CFG, N_MLP, SIZE, STYLE, reals, write_checkpoints
from torch_train_util import torch_threads  # noqa: F401

RATIO = 0.25


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("sparsity_cli")
    student, teacher = write_checkpoints(root)
    cache = str(root / "cache.npy")
    np.save(cache, reals(2).reshape(-1, SIZE, SIZE, 3))
    vgg, lins = write_lpips_files(root, lpips_tree())
    return dict(root=root, student=student, teacher=teacher, cache=cache, vgg=vgg, lins=lins)


def _argv(files, exp_root, *extra):
    return ["--path", files["cache"], "--size", str(SIZE), "--latent", str(STYLE),
            "--n_mlp", str(N_MLP), "--ckpt", files["student"], "--batch", str(BATCH),
            "--n_sample", "4", "--exp_root", str(exp_root), "--device", "cpu", *extra]


def _log(exp_dir):
    (name,) = [f for f in os.listdir(exp_dir) if f.endswith(".out")]
    with open(os.path.join(exp_dir, name)) as f:
        return f.read()


def _records(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_prunes_as_the_jax_rule(files, tmp_path, capsys):
    exp = train_sparsity.main(_argv(
        files, tmp_path, "--teacher_ckpt", files["teacher"], "--iter", "4",
        "--model_prune_freq", "2", "--pruning_mode", "Layer_Uniform",
        "--lay_rmve_ratio", str(RATIO), "--kd_l1_lambda", "1", "--val_sample_freq", "2",
        "--model_save_freq", "3", "--lpips_vgg_ckpt", files["vgg"],
        "--lpips_lins_ckpt", files["lins"]))
    assert "WARNING" not in capsys.readouterr().out
    log = _log(exp)
    want_shape = [c - int(c * RATIO) for c in G_CFG.net_shape]
    want_pct = styled_conv_flops(tuple(want_shape), False) / GENERATOR_FLOPS_256PX * 100.0
    assert ("\n\n-------After pruning------\n"
            f"Shape: {want_shape}\nFLOPs %: {round(want_pct, 2)}\n\n") in log
    iters = re.findall(r"Iter #: (\d+) Train Time: \S+ D_Loss: \S+ G_Loss: \S+ Sparse_Loss: "
                       r"\S+ KD_L1_Loss: \S+ KD_Percept_Loss: (\S+) D_Reg: \S+ G_Reg: \S+ "
                       r"G_Mean_Path: \S+", log)
    assert [int(i) for i, _ in iters] == [0, 1, 2, 3]
    recs = _records(exp)
    steps = [r for r in recs if "d" in r]
    prune_recs = [r for r in recs if "net_shape" in r]
    assert [r["iter"] for r in steps] == [0, 1, 2, 3]
    assert all(np.isfinite(v) for r in steps for v in r.values())
    assert all(r["sparse"] > 0 and r["kd_percept_loss"] > 0 for r in steps)
    assert prune_recs == [{"iter": 2, "net_shape": want_shape, "flops_pct": want_pct}]
    assert sorted(os.listdir(os.path.join(exp, "sample"))) == ["000000.png", "000002.png"]
    # the checkpoint after the prune, read by the JAX package at the new widths
    trees, meta = jax_load_checkpoint(os.path.join(exp, "ckpt", "000003.npz"))
    assert meta["net_shape"] == want_shape and meta["iter"] == 3
    for key in ("g", "g_ema"):
        _, cfg = build_generator_from_pytree(trees[key], size=SIZE, style_dim=STYLE, n_mlp=N_MLP)
        assert list(cfg.net_shape) == want_shape


def test_cli_without_vgg_weights(files, tmp_path, capsys):
    """The JAX CLI's rule: LPIPS only with a teacher and a percept weight
    > 0; an absent VGG16 file drops the term with a warning."""
    exp = train_sparsity.main(_argv(
        files, tmp_path / "a", "--teacher_ckpt", files["teacher"], "--iter", "1",
        "--kd_percept_mode", "LPIPS", "--lpips_vgg_ckpt", str(tmp_path / "absent.pth")))
    out = capsys.readouterr().out
    assert "WARNING: no VGG weights at" in out and "percept KD disabled" in out
    (rec,) = _records(exp)
    assert rec["kd_percept_loss"] == 0.0 and rec["sparse"] > 0
    exp = train_sparsity.main(_argv(files, tmp_path / "b", "--iter", "1",
                                    "--lpips_vgg_ckpt", files["vgg"]))
    (rec,) = _records(exp)
    assert "kd_percept_loss" not in rec and "WARNING" not in capsys.readouterr().out
