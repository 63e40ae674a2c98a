"""The port's projector (projector/project.py) and its CLI against the JAX
package's, on the CPU at 16px with a width-0.25 LPIPS:

- ``image_projector`` with Adam (5 iterations) and with L-BFGS (3), the W+
  latent and the noise maps optimized, from JAX's draws (the mean-latent z
  and the initial noise, rebuilt from its key): the losses to 1e-4
  relative, the final latent and noise maps to 1e-4 of their largest value;
- ``psnr``, ``img_to_tensor`` and both mixing helpers;
- the PNG reader beside ``write_png``: a round trip and Pillow's decode;
- ``get_projected_image.main`` in-process with ``--device cpu``: the target
  read as the JAX CLI reads it (Pillow, and the no-Pillow reader), the
  printed scores, and the side-by-side PNG, whose right half is the
  projection ``image_projector`` gives on the CLI's own draws.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import random
from PIL import Image

from content_aware_gan_compression_tpu.models import (
    GeneratorConfig as JaxGeneratorConfig, generator_apply, generator_make_noise)
from content_aware_gan_compression_tpu.models.lpips import lpips_apply
from content_aware_gan_compression_tpu import projector as jax_projector
from content_aware_gan_compression_tpu.utils import save_checkpoint as jax_save_checkpoint
from content_aware_gan_compression_torch import get_projected_image, projector
from content_aware_gan_compression_torch.utils import (
    build_generator_from_state_dict, build_lpips_from_state_dict)
from content_aware_gan_compression_torch.utils.logging import _png_chunk, read_png, write_png
from torch_eval_util import generator_tree, lpips_tree, write_lpips_files
from torch_train_util import torch_threads  # noqa: F401

SIZE, STYLE, N_MLP, BATCH = 16, 32, 2, 2
CFG = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=(16, 16, 12, 12, 8, 8))
AVG_SAMPLES = 512
RTOL = 1e-4


def _np(t):
    return np.array(t)


@pytest.fixture(scope="module")
def setup():
    """The generator tree, LPIPS tree, the port's modules, and targets that
    are the generator's own samples (projectable)."""
    tree = generator_tree(0, CFG)
    lp = lpips_tree()
    rng = np.random.RandomState(1)
    z = rng.randn(BATCH, STYLE).astype(np.float32)
    noise = [rng.randn(BATCH, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1).astype(np.float32)
             for i in range(CFG.num_layers)]
    target = np.array(jax.jit(lambda p: generator_apply(p, CFG, [jnp.asarray(z)],
                                                         noise=[jnp.asarray(n) for n in noise]))(
        tree))
    g = build_generator_from_state_dict(tree, SIZE, STYLE, N_MLP, device="cpu")
    g.requires_grad_(False)
    lpips = build_lpips_from_state_dict(lp, device="cpu").requires_grad_(False)
    return dict(tree=tree, lp=lp, target=target, g=g, lpips=lpips)


@pytest.mark.parametrize("opt,iters", [("Adam", 5), ("LBFGS", 3)])
def test_image_projector_matches_jax(setup, opt, iters):
    s = setup
    key = random.PRNGKey(7)
    _, latent_j, noises_j, losses_j = jax_projector.image_projector(
        s["tree"], CFG, jnp.asarray(s["target"]), lpips_params=s["lp"], rng=key, opt=opt,
        num_iters=iters, avg_w_samples=AVG_SAMPLES, packed=False)
    k_avg, k_noise = random.split(key)
    avg_z = torch.from_numpy(_np(random.normal(k_avg, (AVG_SAMPLES, STYLE))))
    noise0 = [torch.from_numpy(_np(n)) for n in generator_make_noise(k_noise, CFG, BATCH)]
    info = {}
    out, latent, noises, losses = projector.image_projector(
        s["g"], torch.from_numpy(s["target"]), lpips=s["lpips"], avg_w_z=avg_z, noise=noise0,
        opt=opt, num_iters=iters, info=info)
    np.testing.assert_allclose(losses, np.asarray(losses_j), rtol=RTOL)
    assert losses[-1] < losses[0]
    for got, want in [(latent, latent_j), *zip(noises, noises_j)]:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())
    assert out.shape == (BATCH, 3, SIZE, SIZE)
    if opt == "Adam":
        assert info["evaluations"] == iters
    else:  # one evaluation of the start, then the line searches'
        assert info["evaluations"] >= iters + 1 and len(info["stepsizes"]) == iters


def test_projector_latent_only_and_plain_w(setup):
    """``optimize_noise=False`` keeps the initial noise; ``per_layer_w=False``
    optimizes one W per sample."""
    s = setup
    gen = torch.Generator().manual_seed(0)
    noise0 = s["g"].make_noise(BATCH, torch.Generator().manual_seed(1))
    _, latent, noises, losses = projector.image_projector(
        s["g"], torch.from_numpy(s["target"]), generator=gen, noise=noise0, per_layer_w=False,
        optimize_noise=False, opt="Adam", num_iters=3, avg_w_samples=64)
    assert latent.shape == (BATCH, STYLE) and losses.shape == (3,)
    assert all(torch.equal(a, b) for a, b in zip(noises, noise0))
    with pytest.raises(ValueError):
        projector.image_projector(s["g"], torch.from_numpy(s["target"]), generator=gen,
                                  opt="SGD", num_iters=1)


def test_helpers_match_jax():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (8, 8, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-9, 10, a.shape), 0, 255).astype(np.uint8)
    assert projector.psnr(a, b) == jax_projector.psnr(a, b)
    assert projector.psnr(a, a) == float("inf")
    np.testing.assert_array_equal(projector.img_to_tensor(a).numpy(),
                                  np.asarray(jax_projector.img_to_tensor(a)))
    lat = [rng.randn(2, 8, 4).astype(np.float32) for _ in range(2)]
    for k in (0, 3, 8):
        np.testing.assert_array_equal(
            projector.latent_style_mixing([torch.from_numpy(x) for x in lat], k).numpy(),
            np.asarray(jax_projector.latent_style_mixing([jnp.asarray(x) for x in lat], k)))
    noises = [list(range(7)), list(range(10, 17))]
    for k in (1, 4, 7):
        assert (projector.noise_style_mixing(noises, k)
                == jax_projector.noise_style_mixing(noises, k))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader(tmp_path, channels):
    """read_png inverts write_png and agrees with Pillow's decode, also on a
    PNG that Pillow wrote with its filters; it refuses 16-bit PNGs."""
    arr = np.random.RandomState(channels).randint(0, 256, (9, 13, channels), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, arr)
    np.testing.assert_array_equal(read_png(path), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)).reshape(arr.shape), arr)
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    smooth = (np.add.outer(np.arange(20), np.arange(30))[..., None] * np.arange(1, channels + 1)
              % 256).astype(np.uint8)
    Image.fromarray(smooth.squeeze(-1) if channels == 1 else smooth, mode).save(
        tmp_path / "pil.png", optimize=True)
    np.testing.assert_array_equal(read_png(str(tmp_path / "pil.png")), smooth)
    header = struct.pack(">IIBBBBB", 4, 4, 16, 0, 0, 0, 0)  # 16-bit grey
    with open(tmp_path / "deep.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(bytes(4 * 9))) + _png_chunk(b"IEND", b""))
    assert np.asarray(Image.open(tmp_path / "deep.png")).shape == (4, 4)
    with pytest.raises(ValueError, match="Pillow"):
        read_png(str(tmp_path / "deep.png"))


def test_projection_cli(setup, tmp_path, monkeypatch, capsys):
    """``main`` on a seeded .npz, LPIPS files and a target PNG, at the JAX
    CLI's flags: the target is read as the JAX CLI reads it, the printed
    scores are those of the saved projection, which is ``image_projector``'s
    on the CLI's draws (a torch.Generator seeded with --seed); without
    Pillow the zlib reader reads the same target, and refuses another size."""
    s = setup
    ckpt = str(tmp_path / "g.npz")
    jax_save_checkpoint(ckpt, {"g_ema": s["tree"]})
    vgg_file, lins_file = write_lpips_files(tmp_path, s["lp"])
    target_uint8 = ((s["target"][0].transpose(1, 2, 0) + 1) * 127.5).clip(0, 255).astype(np.uint8)
    image_file = str(tmp_path / "target.png")
    write_png(image_file, target_uint8)
    out = str(tmp_path / "side.png")
    argv = ["--ckpt", ckpt, "--image_file", image_file, "--generated_img_size", str(SIZE),
            "--latent", str(STYLE), "--n_mlp", str(N_MLP), "--num_iters", "3", "--seed", "4",
            "--lpips_vgg_ckpt", vgg_file, "--lpips_lins_ckpt", lins_file, "--out", out,
            "--device", "cpu"]
    result = get_projected_image.main(argv)
    printed = capsys.readouterr().out
    side = read_png(out)
    assert side.shape == (SIZE, 2 * SIZE, 3)
    # the target as the JAX CLI reads it: Pillow, convert('RGB'), resize
    jax_target = Image.open(image_file).convert("RGB").resize((SIZE, SIZE))
    np.testing.assert_array_equal(side[:, :SIZE], np.asarray(jax_target))
    np.testing.assert_array_equal(
        projector.img_to_tensor(side[:, :SIZE]).numpy(),
        np.asarray(jax_projector.img_to_tensor(jax_target)))
    # the projection: image_projector on the CLI's draws
    gen = torch.Generator().manual_seed(4)
    output, _, _, losses = projector.image_projector(
        s["g"], projector.img_to_tensor(target_uint8), lpips=s["lpips"], generator=gen,
        num_iters=3)
    np.testing.assert_array_equal(side[:, SIZE:], projector.to_uint8_image(output[0].numpy()))
    np.testing.assert_allclose(result["losses"], losses, rtol=1e-6)
    want_psnr = jax_projector.psnr(side[:, SIZE:], side[:, :SIZE])
    assert f"PSNR Score: {round(want_psnr, 4)}" in printed
    want_lpips = float(np.asarray(lpips_apply(s["lp"], jnp.asarray(output.numpy()),
                                              jnp.asarray(projector.img_to_tensor(
                                                  target_uint8).numpy()))).squeeze())
    np.testing.assert_allclose(result["lpips"], want_lpips, rtol=1e-4)
    assert "LPIPS Score:" in printed and "WARNING" not in printed

    monkeypatch.setitem(sys.modules, "PIL", None)  # the card's machine has no Pillow
    np.testing.assert_array_equal(get_projected_image.load_target_image(image_file, SIZE),
                                  target_uint8)
    with pytest.raises(ValueError, match="Pillow"):
        get_projected_image.load_target_image(image_file, 2 * SIZE)
