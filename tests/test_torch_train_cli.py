"""``python -m content_aware_gan_compression_torch.train`` on the CPU (its
``main`` in this process): two
iterations on a tiny uint8 cache from JAX-written student and teacher
checkpoints write a checkpoint, metrics.jsonl and sample grids, and
``--load_train_state`` resumes at the next iteration; with seeded aux-net
files in the reference's schemas (torchvision's VGG16, the LPIPS heads, a
79999_iter.pth BiSeNet) the run trains the full objective. Also the CLI's
handling of absent and unreadable aux-net files."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from content_aware_gan_compression_torch.models import LPIPS, vgg16_widths
from content_aware_gan_compression_torch.train.__main__ import (
    aux_nets_from_args, config_from_args, main, parse_args)
from content_aware_gan_compression_torch.utils import build_bisenet_from_state_dict
from torch_train_util import N_MLP, SIZE, STYLE, aux_trees, write_checkpoints
from torch_train_util import torch_threads  # noqa: F401

@pytest.fixture
def cli(monkeypatch, capsys):
    """The CLI's ``main`` run from a working directory; its standard output."""
    def run(*args, cwd):
        monkeypatch.chdir(cwd)
        capsys.readouterr()
        main([str(a) for a in args])
        return capsys.readouterr().out
    return run


def _common(tmp_path, student, teacher):
    cache = tmp_path / "data.npy"
    np.save(cache, (np.random.RandomState(0).rand(12, SIZE, SIZE, 3) * 255).astype(np.uint8))
    return ["--path", str(cache), "--size", str(SIZE), "--latent", str(STYLE),
            "--n_mlp", str(N_MLP), "--batch_size", "4", "--teacher_ckpt", teacher,
            "--n_sample", "4", "--val_sample_freq", "1", "--model_save_freq", "1",
            "--d_reg_every", "2", "--g_reg_every", "2", "--device", "cpu"]


def _runs(exp_root):
    return sorted(p for p in Path(exp_root).iterdir() if p.name.startswith("Exp_"))


def test_cli_trains_saves_and_resumes(tmp_path, cli):
    student, teacher = write_checkpoints(tmp_path)
    common = _common(tmp_path, student, teacher)
    first_root, second_root = tmp_path / "first", tmp_path / "second"
    out = cli(*common, "--ckpt", student, "--iter", "2", "--exp_root", str(first_root),
              cwd=tmp_path)
    # no BiSeNet or VGG weights here: the JAX CLI's warnings, and both terms dropped
    assert "no VGG weights" in out and "no BiSeNet weights" in out
    (exp,) = _runs(first_root)
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [0, 1]
    assert {"d", "g", "kd_l1_loss", "r1", "path", "mean_path_avg"} <= set(recs[0])
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert recs[0]["kd_lpips_loss"] == 0.0
    assert "Iter #: 1 " in next(exp.glob("*_training_log.out")).read_text()
    for i in (0, 1):
        head = (exp / "sample" / f"00000{i}.png").read_bytes()[:8]
        assert head == b"\x89PNG\r\n\x1a\n"
    ckpt = exp / "ckpt" / "000001.npz"
    assert ckpt.exists() and not (exp / "ckpt" / "000000.npz").exists()

    cli(*common, "--ckpt", str(ckpt), "--load_train_state", "True", "--iter", "4",
        "--exp_root", str(second_root), cwd=tmp_path)
    (exp2,) = _runs(second_root)
    recs2 = [json.loads(line) for line in (exp2 / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs2] == [2, 3]
    assert (exp2 / "ckpt" / "000003.npz").exists()


def write_aux_files(dirpath):
    """Seeded aux nets (widths scaled 0.25) in the files the CLI reads:
    torchvision's VGG16 (``features.N.*``, with a classifier beside it), the
    reference's LPIPS heads (``lin{k}.model.1.weight``) and a BiSeNet as
    79999_iter.pth holds it (``num_batches_tracked`` in every batch norm)."""
    lpips = LPIPS(vgg16_widths(0.25), device="cpu", generator=torch.Generator().manual_seed(6))
    vgg = {f"features.{k}": v for k, v in lpips.vgg.state_dict().items()}
    vgg["classifier.0.weight"] = torch.zeros(2, 2)
    lins = {f"lin{k}.model.1.weight": lin.weight.detach()
            for k, lin in enumerate(lpips.lins)}
    bisenet = build_bisenet_from_state_dict(aux_trees()[1], device="cpu").state_dict()
    for k in [k for k in bisenet if k.endswith("running_var")]:
        bisenet[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(79999)
    paths = [str(dirpath / name) for name in ("vgg16.pth", "lins.pth", "79999_iter.pth")]
    for path, sd in zip(paths, (vgg, lins, bisenet)):
        torch.save(sd, path)
    return paths


def test_cli_trains_the_full_objective_from_aux_files(tmp_path, cli):
    student, teacher = write_checkpoints(tmp_path)
    vgg, lins, parsing = write_aux_files(tmp_path)
    out = cli(*_common(tmp_path, student, teacher), "--ckpt", student, "--iter", "2",
              "--lpips_vgg_ckpt", vgg, "--lpips_lins_ckpt", lins, "--parsing_ckpt", parsing,
              "--exp_root", str(tmp_path / "run"), cwd=tmp_path)
    assert "WARNING" not in out
    (exp,) = _runs(tmp_path / "run")
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs] == [0, 1]
    assert all(r["kd_lpips_loss"] > 0 and r["kd_l1_loss"] > 0 for r in recs)
    assert all(np.isfinite(v) for r in recs for v in r.values())
    log = next(exp.glob("*_training_log.out")).read_text()
    assert "KD_LPIPS_Loss: 0.0 " not in log and "Content Aware: True" in log


def test_cli_raises_where_aux_weights_exist(tmp_path):
    """Present aux files are loaded, so a file that is not a checkpoint
    raises instead of being dropped; absent ones drop their term with the
    JAX CLI's warning; without a teacher nothing is loaded."""
    (tmp_path / "bisenet.pth").write_bytes(b"")
    base = ["--teacher_ckpt", "t.npz", "--lpips_vgg_ckpt", str(tmp_path / "none.pth"),
            "--parsing_ckpt", str(tmp_path / "bisenet.pth")]
    args = parse_args(base)
    with pytest.raises(EOFError):
        aux_nets_from_args(args, config_from_args(args))
    args = parse_args([*base, "--content_aware_KD", "False"])
    cfg, lpips, parser = aux_nets_from_args(args, config_from_args(args))
    assert cfg.kd_lpips_lambda == 0.0 and not cfg.content_aware_KD
    assert lpips is None and parser is None
    args = parse_args(["--teacher_ckpt", "t.npz", "--lpips_vgg_ckpt",
                       str(tmp_path / "bisenet.pth")])
    with pytest.raises(EOFError):
        aux_nets_from_args(args, config_from_args(args))
    vgg, lins, parsing = write_aux_files(tmp_path)
    args = parse_args(["--teacher_ckpt", "t.npz", "--lpips_vgg_ckpt", vgg,
                       "--lpips_lins_ckpt", lins, "--parsing_ckpt", parsing])
    cfg, lpips, parser = aux_nets_from_args(args, config_from_args(args))
    assert cfg.kd_lpips_lambda == 3.0 and lpips is not None and parser is not None
    args = parse_args([])  # no teacher: no KD terms to load
    cfg, lpips, parser = aux_nets_from_args(args, config_from_args(args))
    assert cfg.kd_lpips_lambda == 3.0 and cfg.teacher is None and lpips is parser is None


def test_cli_refuses_cuda_without_a_card(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    student, teacher = write_checkpoints(tmp_path)
    common = [a for a in _common(tmp_path, student, teacher) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli(*common, "--ckpt", student, "--iter", "1", "--exp_root", str(tmp_path),
            cwd=tmp_path)
