"""``python -m content_aware_gan_compression_torch.train`` on the CPU: two
iterations on a tiny uint8 cache from JAX-written student and teacher
checkpoints write a checkpoint, metrics.jsonl and sample grids, and
``--load_train_state`` resumes at the next iteration. Also the CLI's handling
of the aux-net weight files it cannot use yet."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from content_aware_gan_compression_torch.train.__main__ import config_from_args, parse_args
from torch_train_util import N_MLP, SIZE, STYLE, write_checkpoints

REPO = Path(__file__).resolve().parents[1]


def _cli(*args, cwd):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "content_aware_gan_compression_torch.train",
                           *args], text=True, capture_output=True, timeout=300, cwd=cwd,
                          env=env)


def _common(tmp_path, student, teacher):
    cache = tmp_path / "data.npy"
    np.save(cache, (np.random.RandomState(0).rand(12, SIZE, SIZE, 3) * 255).astype(np.uint8))
    return ["--path", str(cache), "--size", str(SIZE), "--latent", str(STYLE),
            "--n_mlp", str(N_MLP), "--batch_size", "4", "--teacher_ckpt", teacher,
            "--n_sample", "4", "--val_sample_freq", "1", "--model_save_freq", "1",
            "--d_reg_every", "2", "--g_reg_every", "2", "--device", "cpu"]


def _runs(exp_root):
    return sorted(p for p in Path(exp_root).iterdir() if p.name.startswith("Exp_"))


def test_cli_trains_saves_and_resumes(tmp_path):
    student, teacher = write_checkpoints(tmp_path)
    common = _common(tmp_path, student, teacher)
    first_root, second_root = tmp_path / "first", tmp_path / "second"
    proc = _cli(*common, "--ckpt", student, "--iter", "2", "--exp_root", str(first_root),
                cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # no BiSeNet or VGG weights here: the JAX CLI's warnings, and both terms dropped
    assert "no VGG weights" in proc.stdout and "no BiSeNet weights" in proc.stdout
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

    proc = _cli(*common, "--ckpt", str(ckpt), "--load_train_state", "True", "--iter", "4",
                "--exp_root", str(second_root), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (exp2,) = _runs(second_root)
    recs2 = [json.loads(line) for line in (exp2 / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs2] == [2, 3]
    assert (exp2 / "ckpt" / "000003.npz").exists()


def test_cli_raises_where_aux_weights_exist(tmp_path):
    """A present BiSeNet or VGG file would make JAX's run differ from this
    one, so the CLI refuses it until those nets are ported."""
    (tmp_path / "bisenet.pth").write_bytes(b"")
    base = ["--teacher_ckpt", "t.npz", "--lpips_vgg_ckpt", str(tmp_path / "none.pth"),
            "--parsing_ckpt", str(tmp_path / "bisenet.pth")]
    with pytest.raises(NotImplementedError, match="BiSeNet"):
        config_from_args(parse_args(base))
    cfg = config_from_args(parse_args([*base, "--content_aware_KD", "False"]))
    assert cfg.kd_lpips_lambda == 0.0 and not cfg.content_aware_KD
    with pytest.raises(NotImplementedError, match="VGG"):
        config_from_args(parse_args(["--teacher_ckpt", "t.npz", "--lpips_vgg_ckpt",
                                     str(tmp_path / "bisenet.pth")]))
    cfg = config_from_args(parse_args([]))  # no teacher: no KD terms to check
    assert cfg.kd_lpips_lambda == 3.0 and cfg.teacher is None


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    student, teacher = write_checkpoints(tmp_path)
    common = [a for a in _common(tmp_path, student, teacher) if a not in ("--device", "cpu")]
    proc = _cli(*common, "--ckpt", student, "--iter", "1", "--exp_root", str(tmp_path),
                cwd=tmp_path)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
