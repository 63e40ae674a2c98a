"""The port's convert_weight against the JAX package's root script, on fake
TF variables under the official names at 16px (tests/test_aux.py's recipe,
with ``dlatent_avg``): the generator's and the discriminator's trees equal
JAX's exactly, the CLI's ``.npz`` holds the JAX script's arrays, manifest
and metadata and loads in both packages, and the fixed-seed render matches
``generator_apply`` within 1e-4 of the largest value."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from content_aware_gan_compression_tpu.models import GeneratorConfig, generator_apply
from content_aware_gan_compression_tpu.utils import load_checkpoint as jax_load_checkpoint
from content_aware_gan_compression_torch import convert_weight
from content_aware_gan_compression_torch.utils import load_checkpoint, load_generator
from torch_train_util import torch_threads  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import convert_weight as jax_convert_weight  # noqa: E402  (the JAX package's root script)

SIZE, STYLE, N_MLP, CH = 16, 512, 8, 512


def tf_generator_vars(seed=0):
    """The official TF names and layouts of a 16px generator's variables."""
    rng = np.random.RandomState(seed)
    vars = {}
    for i in range(N_MLP):
        vars[f"G_mapping/Dense{i}/weight"] = rng.randn(STYLE, STYLE).astype("f")
        vars[f"G_mapping/Dense{i}/bias"] = rng.randn(STYLE).astype("f")
    vars["G_synthesis/4x4/Const/const"] = rng.randn(1, CH, 4, 4).astype("f")

    def conv_vars(name, cin, cout, k):
        vars[f"{name}/weight"] = rng.randn(k, k, cin, cout).astype("f")
        vars[f"{name}/mod_weight"] = rng.randn(STYLE, cin).astype("f")
        vars[f"{name}/mod_bias"] = rng.randn(cin).astype("f")
        vars[f"{name}/noise_strength"] = np.float32(0.1)
        vars[f"{name}/bias"] = rng.randn(cout).astype("f")

    def torgb_vars(name, cin):
        vars[f"{name}/weight"] = rng.randn(1, 1, cin, 3).astype("f")
        vars[f"{name}/mod_weight"] = rng.randn(STYLE, cin).astype("f")
        vars[f"{name}/mod_bias"] = rng.randn(cin).astype("f")
        vars[f"{name}/bias"] = rng.randn(3).astype("f")

    conv_vars("G_synthesis/4x4/Conv", CH, CH, 3)
    torgb_vars("G_synthesis/4x4/ToRGB", CH)
    for reso in (8, 16):
        conv_vars(f"G_synthesis/{reso}x{reso}/Conv0_up", CH, CH, 3)
        conv_vars(f"G_synthesis/{reso}x{reso}/Conv1", CH, CH, 3)
        torgb_vars(f"G_synthesis/{reso}x{reso}/ToRGB", CH)
    for i in range(5):
        res = 2 ** ((i + 5) // 2)
        vars[f"G_synthesis/noise{i}"] = rng.randn(1, 1, res, res).astype("f")
    vars["dlatent_avg"] = 0.1 * rng.randn(STYLE).astype("f")
    return vars


def tf_discriminator_vars(seed=1, ch=8):
    """The official TF names and layouts of a 16px discriminator's."""
    rng = np.random.RandomState(seed)
    vars = {f"{SIZE}x{SIZE}/FromRGB/weight": rng.randn(1, 1, 3, ch).astype("f"),
            f"{SIZE}x{SIZE}/FromRGB/bias": rng.randn(ch).astype("f")}
    for reso in (16, 8):
        vars[f"{reso}x{reso}/Conv0/weight"] = rng.randn(3, 3, ch, ch).astype("f")
        vars[f"{reso}x{reso}/Conv0/bias"] = rng.randn(ch).astype("f")
        vars[f"{reso}x{reso}/Conv1_down/weight"] = rng.randn(3, 3, ch, ch).astype("f")
        vars[f"{reso}x{reso}/Conv1_down/bias"] = rng.randn(ch).astype("f")
        vars[f"{reso}x{reso}/Skip/weight"] = rng.randn(1, 1, ch, ch).astype("f")
    vars["4x4/Conv/weight"] = rng.randn(3, 3, ch + 1, ch).astype("f")
    vars["4x4/Conv/bias"] = rng.randn(ch).astype("f")
    vars["4x4/Dense0/weight"] = rng.randn(ch * 16, ch).astype("f")
    vars["4x4/Dense0/bias"] = rng.randn(ch).astype("f")
    vars["Output/weight"] = rng.randn(ch, 1).astype("f")
    vars["Output/bias"] = rng.randn(1).astype("f")
    return vars


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def test_trees_equal_jax():
    g_vars, d_vars = tf_generator_vars(), tf_discriminator_vars()
    _assert_trees_equal(convert_weight.generator_tree_from_tf_vars(g_vars, SIZE),
                        jax_convert_weight.generator_tree_from_tf_vars(g_vars, SIZE))
    _assert_trees_equal(convert_weight.discriminator_tree_from_tf_vars(d_vars, SIZE),
                        jax_convert_weight.discriminator_tree_from_tf_vars(d_vars, SIZE))


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Both CLIs on the same files (with --gen and --disc), each in a
    directory of its own; the port's render returned."""
    root = tmp_path_factory.mktemp("convert")
    np.savez(root / "ffhq.npz", **tf_generator_vars())
    np.savez(root / "ffhq_g.npz", **tf_generator_vars(seed=2))
    np.savez(root / "ffhq_d.npz", **tf_discriminator_vars())
    cwd = os.getcwd()
    try:
        for name in ("port", "jax"):
            os.makedirs(root / name)
            os.chdir(root / name)
            args = ["--gen", "--disc", str(root / "ffhq.npz")]
            if name == "port":
                img = convert_weight.main([*args, "--device", "cpu"])
            else:
                argv = sys.argv
                sys.argv = ["convert_weight.py", *args]
                try:
                    jax_convert_weight.main()
                finally:
                    sys.argv = argv
    finally:
        os.chdir(cwd)
    return root, img


def test_npz_equals_the_jax_scripts_and_loads_in_both(converted):
    root, _ = converted
    mine, theirs = str(root / "port" / "ffhq.npz"), str(root / "jax" / "ffhq.npz")
    with np.load(mine) as a, np.load(theirs) as b:
        assert list(a.keys()) == list(b.keys())
        for key in b.keys():
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    port_trees, port_meta = load_checkpoint(mine)
    jax_trees, jax_meta = jax_load_checkpoint(mine)
    assert port_meta == jax_meta == {"size": SIZE}
    assert set(port_trees) == set(jax_trees) == {"g_ema", "g", "d", "latent_avg"}
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, port_trees),
                        jax.tree_util.tree_map(np.asarray, jax_trees))
    g = load_generator(mine, SIZE, device="cpu")
    assert g.config.net_shape == (CH,) * 6
    assert (root / "port" / "ffhq.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_render_matches_generator_apply(converted):
    _, img = converted
    vars = tf_generator_vars()
    tree = jax_convert_weight.generator_tree_from_tf_vars(vars, SIZE)
    cfg = GeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=(CH,) * 6)
    batch = convert_weight.render_batch(SIZE)
    z = np.random.RandomState(0).randn(batch, STYLE).astype("float32")
    want = np.asarray(jax.jit(lambda p, z, t: generator_apply(
        p, cfg, [z], truncation=0.5, truncation_latent=t, randomize_noise=False))(
        tree, jnp.asarray(z), jnp.asarray(vars["dlatent_avg"])[None]))
    assert img.shape == want.shape == (batch, 3, SIZE, SIZE)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=1e-4 * scale)
