"""The port's ``prune`` CLI (``python -m content_aware_gan_compression_torch.prune``)
in-process with ``main(argv)`` on the CPU, on a 16px checkpoint the JAX
package wrote: its pruned ``.npz`` and ``.pth``, read by both packages, and
its pruned ``g_ema`` against the JAX package's prune.py pipeline composed
from the JAX functions (score, remove list, masks, surgery) on the same
checkpoint and the port's draws, rebuilt from the CLI's seed.

Tolerances: the pruned tensors are equal exactly. That needs the same
keep-masks, so the test first checks that the JAX scores' gap at every cut
exceeds 1e-5 of the layer's largest score (fp32 scores of the two packages
agree to about 1e-6, tests/test_torch_content_aware.py).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import DiscriminatorConfig, discriminator_init
from content_aware_gan_compression_tpu.pruning import content_aware as jca
from content_aware_gan_compression_tpu.pruning import schedule as jsch
from content_aware_gan_compression_tpu.pruning import mask_the_generator as jax_mask
from content_aware_gan_compression_tpu.utils import load_checkpoint as jax_load_checkpoint
from content_aware_gan_compression_tpu.utils import save_checkpoint as jax_save_checkpoint
from content_aware_gan_compression_torch import prune
from content_aware_gan_compression_torch.pruning import draw_scoring_batch
from content_aware_gan_compression_torch.utils import (
    load_checkpoint, load_generator, pytree_to_torch_state_dict)
from torch_prune_util import JCFG, NET_SHAPE, N_MLP, SIZE, STYLE, generator_pair, jax_batch_draws
from torch_train_util import PARSER_SEED, _jit_init, bisenet_tree
from torch_train_util import torch_threads  # noqa: F401

N_SAMPLE, BATCH, RATIO, SEED = 10, 4, 0.7, 5
GAP = 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX-written checkpoint {'g_ema', 'd'} and a seeded BiSeNet in the
    reference's 79999_iter.pth schema."""
    root = tmp_path_factory.mktemp("prune")
    tree, g = generator_pair(0)
    d = _jit_init(discriminator_init, 2, DiscriminatorConfig(size=SIZE, channel_max=16))
    ckpt = str(root / "g16.npz")
    jax_save_checkpoint(ckpt, {"g_ema": tree, "d": d}, metadata={"size": SIZE})
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          pytree_to_torch_state_dict(bisenet_tree(0.25, seed=PARSER_SEED)).items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(79999)
    parser = str(root / "79999_iter.pth")
    torch.save(sd, parser)
    return {"root": root, "ckpt": ckpt, "parser": parser, "tree": tree, "d": d, "g": g}


def run_cli(files, name, *extra):
    """(the .npz path, what the CLI printed)."""
    out_dir = str(files["root"] / name)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        path = prune.main(["--ckpt", files["ckpt"], "--generated_img_size", str(SIZE),
                           "--latent", str(STYLE), "--n_mlp", str(N_MLP), "--n_sample",
                           str(N_SAMPLE), "--batch_size", str(BATCH), "--remove_ratio",
                           str(RATIO), "--seed", str(SEED), "--out_dir", out_dir, "--device",
                           "cpu", *extra])
    printed = out.getvalue()
    assert "The content-aware metric scoring takes:" in printed
    assert os.path.dirname(path) == out_dir and os.path.exists(path[:-4] + ".pth")
    return path, printed


def check_outputs(files, path, metric, shape):
    """The .npz through both packages' readers, g == g_ema, D carried over,
    metadata, and the .pth with the same tensors."""
    trees, meta = jax_load_checkpoint(path)
    ours, ours_meta = load_checkpoint(path)
    assert meta == ours_meta == {"size": SIZE, "remove_ratio": RATIO, "metric": metric}
    assert set(trees) == {"g", "g_ema", "d"}
    g, g_ema, ours_g_ema = (pytree_to_torch_state_dict(tree) for tree in (
        trees["g"], trees["g_ema"], ours["g_ema"]))
    for k, v in g_ema.items():
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(ours_g_ema[k].numpy(), np.asarray(v), err_msg=k)
    for k, v in pytree_to_torch_state_dict(files["d"]).items():
        np.testing.assert_array_equal(np.asarray(pytree_to_torch_state_dict(trees["d"])[k]), v)
    pth = torch.load(path[:-4] + ".pth", weights_only=True)
    assert set(pth) == {"g", "g_ema", "d"}
    for k, v in g_ema.items():
        np.testing.assert_array_equal(pth["g_ema"][k].numpy(), np.asarray(v), err_msg=k)
    g_small = load_generator(path, SIZE, STYLE, N_MLP, device="cpu")
    assert g_small.config.net_shape == shape
    with torch.no_grad():
        img = g_small([torch.randn(2, STYLE)], randomize_noise=False)
    assert img.shape == (2, 3, SIZE, SIZE) and torch.isfinite(img).all()
    return g_ema


def jax_prune(tree, scores, keep_multiple=1):
    """JAX's prune.py after scoring; checks the scores' gaps first."""
    rmv = jsch.get_uniform_remove_list(NET_SHAPE, RATIO, keep_multiple=keep_multiple)
    for lay, (s, r) in enumerate(zip(scores, rmv)):
        cut = np.sort(np.asarray(s, np.float64))[r - 1:r + 1]
        assert cut[1] - cut[0] > GAP * np.abs(s).max(), f"layer {lay}: scores too close to cut"
    masks = jsch.generate_prune_mask_list(scores, NET_SHAPE, rmv)
    return pytree_to_torch_state_dict(jax_mask(tree, masks)), tuple(int(m.sum()) for m in masks)


def assert_same_generator(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def whole_image(files):
    """The content-aware run without a BiSeNet file."""
    return run_cli(files, "whole_image", "--parsing_ckpt", str(files["root"] / "absent.pth"))


def test_prune_cli_content_aware_matches_jax(files, whole_image):
    """No BiSeNet file: a warning, and the whole image counts as content.
    The JAX pipeline scores the CLI's draws (three batches, the last one
    padded) with _grad_scores."""
    path, printed = whole_image
    assert "WARNING: BiSeNet weights not found" in printed
    gen = torch.Generator().manual_seed(SEED)
    grad = jax.jit(lambda p, z, n, s, r: jca._grad_scores(p, JCFG, z, n, s, r))
    scores = [np.zeros(c) for c in NET_SHAPE]
    for idx in range(-(-N_SAMPLE // BATCH)):
        z, noise, sp, replace = jax_batch_draws(draw_scoring_batch(files["g"], BATCH, 0.05, gen))
        valid = jnp.arange(BATCH) < min(BATCH, N_SAMPLE - idx * BATCH)
        for i, s in enumerate(grad(files["tree"], z, noise, sp,
                                   replace * valid[:, None, None, None])):
            scores[i] = scores[i] + np.asarray(s)
    want, shape = jax_prune(files["tree"], scores)
    assert shape == (5, 5, 4, 4, 3, 3)
    assert_same_generator(check_outputs(files, path, "content-aware", shape), want)


def test_prune_cli_with_bisenet_file(files, whole_image):
    """With the seeded BiSeNet file the parse masks the noise: no warning,
    a pruned generator of the 0.7 widths, and other channels kept than
    with the whole image."""
    path, printed = run_cli(files, "bisenet", "--parsing_ckpt", files["parser"])
    assert "WARNING" not in printed
    g_ema = check_outputs(files, path, "content-aware", (5, 5, 4, 4, 3, 3))
    other = pytree_to_torch_state_dict(jax_load_checkpoint(whole_image[0])[0]["g_ema"])
    assert any(not np.array_equal(np.asarray(other[k]), np.asarray(v)) for k, v in g_ema.items())


def test_prune_cli_baseline_metric_matches_jax(files):
    """--metric l1-out with --keep_multiple 2: z is the CLI's first draw;
    JAX's get_network_score_list scores it."""
    path, _ = run_cli(files, "l1out", "--metric", "l1-out", "--keep_multiple", "2")
    z = torch.randn(N_SAMPLE, STYLE, generator=torch.Generator().manual_seed(SEED))
    scores = jsch.get_network_score_list(files["tree"], JCFG, jnp.asarray(z.numpy()), "l1-out")
    want, shape = jax_prune(files["tree"], scores, keep_multiple=2)
    assert shape == (6, 6, 4, 4, 4, 4)
    assert_same_generator(check_outputs(files, path, "l1-out", shape), want)
    with pytest.raises(SystemExit):
        prune.main(["--ckpt", files["ckpt"], "--metric", "l3", "--device", "cpu"])
