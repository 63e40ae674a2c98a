"""The port's FLOPs calculators and log analysis (utils/calculators.py,
utils/analysis.py) against the JAX package's: every counter gives the JAX
integer exactly, from a net_shape, from a port ``Generator`` and from its
state dict (the JAX side reads ``jax.eval_shape`` trees, shapes only);
the full 256px and 1024px generators give the reference's constants; the
log extractors read the same numbers off the same log; and
``channel_activation_image`` matches JAX's on the same weights with JAX's
noise handed in (1e-4 absolute on a grid normalized to [0, 1])."""

import numpy as np
import pytest
import jax
import torch

from content_aware_gan_compression_tpu.models import (
    GeneratorConfig as JaxGeneratorConfig, generator_init, generator_make_noise)
from content_aware_gan_compression_tpu.models import stylegan2 as stylegan2_jax
from content_aware_gan_compression_tpu.utils import analysis as jax_analysis
from content_aware_gan_compression_tpu.utils import calculators as jax_calc
from content_aware_gan_compression_tpu.utils.logging import ExperimentLogger as JaxLogger
from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
from content_aware_gan_compression_torch.utils import analysis, calculators as calc
from content_aware_gan_compression_torch.utils import state_dict_from_jax
from torch_train_util import _jit_init
from torch_train_util import torch_threads  # noqa: F401

SHAPES = {
    "full256": dict(size=256),
    "full1024": dict(size=1024),
    "pruned256": dict(size=256, net_shape=(154,) * 10 + (77, 77, 39, 39)),
    "sparse256": dict(size=256, net_shape=(511, 500, 490, 512, 505, 512, 499, 512, 512, 300,
                                           256, 201, 128, 97)),
    "tiny32": dict(size=32, style_dim=16, n_mlp=2, net_shape=(16, 12, 12, 8, 8, 6, 6, 4)),
}


def _jax_shapes(cfg):
    return jax.eval_shape(lambda k: generator_init(k, cfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_generator_counters_match_jax(name):
    jcfg = JaxGeneratorConfig(**SHAPES[name])
    jtree = _jax_shapes(jcfg)
    shape = jcfg.net_shape
    for fn in ("styled_conv_flops", "to_rgb_flops"):
        for detail in (True, False):
            want = getattr(jax_calc, fn)(shape, detail)
            assert getattr(calc, fn)(shape, detail) == want, (fn, detail)
            assert getattr(calc, fn)(list(shape), detail) == want
    want = {fn: getattr(jax_calc, fn)(jtree) for fn in (
        "mapping_network_flops", "style_modulation_flops", "stylegan2_flops")}
    with torch.device("meta"):  # shapes only: no weights drawn
        g = Generator(GeneratorConfig(**SHAPES[name]), device="meta")
    for source in (g, g.state_dict()):
        assert calc.styled_conv_flops(source, False) == jax_calc.styled_conv_flops(jtree, False)
        for fn, value in want.items():
            assert getattr(calc, fn)(source) == value, (fn, type(source))
    if name == "full256":
        assert want["stylegan2_flops"] == calc.GENERATOR_FLOPS_256PX == 45_124_673_536
    if name == "full1024":
        assert want["stylegan2_flops"] == calc.GENERATOR_FLOPS_1024PX == 74_266_894_336


@pytest.mark.parametrize("size", [64, 224, 256, 512])
def test_aux_counters_match_jax(size):
    assert calc.vgg16_lpips_flops(size) == jax_calc.vgg16_lpips_flops(size)
    assert calc.bisenet_flops(size) == jax_calc.bisenet_flops(size)
    for cm, cmax in ((2, 512), (1, 256)) if size != 224 else ():
        assert (calc.discriminator_flops(size, cm, cmax)
                == jax_calc.discriminator_flops(size, cm, cmax))
    assert calc.MAP_SIZE == jax_calc.MAP_SIZE


def test_log_extractors_match_jax(tmp_path):
    """Both packages' extractors on one log: an iteration line, an FID, and
    a sparsity prune block."""
    logger = JaxLogger(str(tmp_path), name="exp")
    logger.log_iteration(0, 1.0, {"d": 0.5, "g": 1.25, "kd_l1_loss": 2.0,
                                  "kd_lpips_loss": 0.75, "r1": 0.1, "path": 0.2,
                                  "mean_path_avg": 0.3})
    logger.log_fid(12.34)
    logger.write("\n\n-------After pruning------\nShape: [5, 4]\nFLOPs %: 9.11\n\n")
    logger.close()
    exp = logger.exp_dir
    assert analysis.extract_training_log(exp) == jax_analysis.extract_training_log(exp) \
        == ([9.11], [12.34])
    assert analysis.extract_training_kd_loss(exp) == jax_analysis.extract_training_kd_loss(exp)
    for key in ("fid", "d"):
        assert (analysis.extract_metrics_jsonl(exp, key)
                == jax_analysis.extract_metrics_jsonl(exp, key))


# JAX's feature maps jitted once for the four layers (eagerly, every op
# compiles on its own); channel_activation_image imports it at each call
_jit_feature_maps = jax.jit(stylegan2_jax.generator_feature_maps, static_argnums=(1,))


@pytest.mark.parametrize("layer_id", [0, 1, 4, 7])
def test_channel_activation_image_matches_jax(layer_id, monkeypatch):
    jcfg = JaxGeneratorConfig(**SHAPES["tiny32"])
    params = _jit_init(generator_init, 0, jcfg)
    rng = np.random.RandomState(1)
    for block in [params["conv1"], *params["convs"].values()]:
        block["noise"]["weight"] = rng.randn(1).astype(np.float32)
    z = rng.randn(2, jcfg.style_dim).astype(np.float32)
    key = jax.random.PRNGKey(4)
    monkeypatch.setattr(stylegan2_jax, "generator_feature_maps", _jit_feature_maps)
    want = jax_analysis.channel_activation_image(params, jcfg, z, layer_id, rng=key, n_col=3)
    g = Generator(GeneratorConfig(**SHAPES["tiny32"]), device="cpu")
    g.load_state_dict(state_dict_from_jax(params))
    noise = [torch.from_numpy(np.array(n)) for n in generator_make_noise(key, jcfg, 2)]
    got = analysis.channel_activation_image(g, torch.from_numpy(z), layer_id, noise=noise,
                                            n_col=3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
