"""The port's generate CLI and image grids, and the port's isolation from
JAX: the package and chip_smoke.py import neither jax nor the JAX package,
and entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch
from PIL import Image

from content_aware_gan_compression_tpu.models import (
    GeneratorConfig as JaxGeneratorConfig, generator_init)
from content_aware_gan_compression_tpu.utils import save_checkpoint as jax_save_checkpoint
from content_aware_gan_compression_tpu.utils.logging import (
    save_image_grid as jax_save_image_grid)
from content_aware_gan_compression_torch import generate
from content_aware_gan_compression_torch.generate import sample_images
from content_aware_gan_compression_torch.utils import load_generator, save_image_grid
from torch_train_util import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "content_aware_gan_compression_torch"
SIZE, STYLE_DIM, N_MLP = 32, 16, 1
NET_SHAPE = (24, 24, 16, 16, 12, 12, 8, 8)
FORBIDDEN = ("jax", "jaxlib", "content_aware_gan_compression_tpu")


@pytest.mark.parametrize("n,channels,nrow", [(4, 3, None), (6, 3, 3), (3, 1, 2)])
def test_save_image_grid_same_pixels_as_jax(tmp_path, n, channels, nrow):
    imgs = np.random.RandomState(n).uniform(-1.3, 1.3, (n, channels, 9, 7)).astype(np.float32)
    if channels == 1:  # PIL, which the JAX writer uses, takes grey as [H, W]
        ours = tmp_path / "ours.png"
        save_image_grid(torch.from_numpy(imgs), str(ours), nrow=nrow)
        got = np.asarray(Image.open(ours))
        rgb = tmp_path / "rgb.png"
        save_image_grid(torch.from_numpy(np.repeat(imgs, 3, 1)), str(rgb), nrow=nrow)
        np.testing.assert_array_equal(got, np.asarray(Image.open(rgb))[..., 0])
        return
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    save_image_grid(torch.from_numpy(imgs), str(ours), nrow=nrow)
    jax_save_image_grid(imgs, str(theirs), nrow=nrow)
    a, b = np.asarray(Image.open(ours)), np.asarray(Image.open(theirs))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _tiny_ckpt(tmp_path):
    cfg = JaxGeneratorConfig(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP, net_shape=NET_SHAPE)
    path = tmp_path / "tiny.npz"
    jax_save_checkpoint(str(path), {"g_ema": generator_init(jax.random.PRNGKey(0), cfg)})
    return path


def test_generate_cli_on_cpu_writes_the_grid(tmp_path):
    ckpt = _tiny_ckpt(tmp_path)
    out_dir = tmp_path / "out"
    generate.main(["--ckpt", str(ckpt), "--size", str(SIZE), "--latent", str(STYLE_DIM),
                   "--n_mlp", str(N_MLP), "--sample", "4", "--pics", "2", "--truncation", "0.7",
                   "--truncation_mean", "64", "--seed", "3", "--out_dir", str(out_dir),
                   "--device", "cpu"])
    grids = [np.asarray(Image.open(out_dir / f"00000{i}.png")) for i in range(2)]
    assert grids[0].shape == (2 + 2 * (SIZE + 2), 2 + 2 * (SIZE + 2), 3)
    assert not np.array_equal(grids[0], grids[1])
    # the CLI's draws: the mean latent's z, then per grid z and the noise
    g = load_generator(str(ckpt), SIZE, STYLE_DIM, N_MLP, device="cpu")
    gen = torch.Generator("cpu").manual_seed(3)
    with torch.inference_mode():
        mean = g.mean_latent(64, gen)
        images = sample_images(g, 4, 0.7, mean, gen)
    save_image_grid(images, str(tmp_path / "direct.png"), nrow=2)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "direct.png")), grids[0])


def test_generate_cli_refuses_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate.main(["--ckpt", str(_tiny_ckpt(tmp_path)), "--size", str(SIZE),
                       "--latent", str(STYLE_DIM), "--n_mlp", str(N_MLP)])


def test_port_imports_no_jax_at_run_time():
    code = ("import sys\n"
            "import content_aware_gan_compression_torch.generate\n"
            "import content_aware_gan_compression_torch.models, "
            "content_aware_gan_compression_torch.ops, content_aware_gan_compression_torch.utils\n"
            "import content_aware_gan_compression_torch.train, "
            "content_aware_gan_compression_torch.train.__main__, "
            "content_aware_gan_compression_torch.data\n"
            "import content_aware_gan_compression_torch.tools.e2e_validation, "
            "content_aware_gan_compression_torch.tools.fid_descent_validation, "
            "content_aware_gan_compression_torch.tools.fixtures\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], text=True, capture_output=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        [*PACKAGE.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_port_sources_import_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"
