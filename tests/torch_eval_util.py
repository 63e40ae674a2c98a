"""Shared fixtures of the port's evaluation tests: a width-scaled Inception
tree in ``inception_init``'s shapes with non-trivial batch-norm statistics,
a tiny generator and LPIPS tree drawn by the JAX package, and writers of the
files the CLIs read (the pytorch-fid Inception release, torchvision's VGG16,
the LPIPS heads)."""

import numpy as np
import jax
import torch

from content_aware_gan_compression_tpu.models import GeneratorConfig as JaxGeneratorConfig
from content_aware_gan_compression_tpu.models import generator_init
from content_aware_gan_compression_tpu.models.inception import inception_init
from content_aware_gan_compression_tpu.models.lpips import lpips_init
from content_aware_gan_compression_torch.utils import state_dict_from_jax
from torch_train_util import _jit_init, randomize_batch_norms

INC_SCALE = 0.125  # divides every Inception width; pool3_dim 256
SIZE, STYLE, N_MLP = 16, 16, 1
G_CFG = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                           net_shape=(16, 12, 12, 8, 8, 8))


def inception_tree(seed=3, width_scale=INC_SCALE):
    """A tree of ``inception_init``'s structure and shapes (traced, not
    compiled) as numpy: He-normal convolutions drawn with numpy, batch norms
    randomized."""
    shapes = jax.eval_shape(lambda k: inception_init(k, width_scale=width_scale),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) == 4:  # [out, in, kh, kw]
            fan = int(np.prod(leaf.shape[1:]))
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / fan)).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)
    return randomize_batch_norms(jax.tree_util.tree_map(draw, shapes), seed)


def generator_tree(seed=0, cfg=G_CFG):
    """A ``generator_init`` tree as numpy, with the noise weights and
    activation biases (zero at init) set so every epilogue term counts."""
    tree = _jit_init(generator_init, seed, cfg)
    rng = np.random.RandomState(seed)
    for block in [tree["conv1"], *tree["convs"].values()]:
        block["noise"]["weight"] = 0.5 * rng.randn(1).astype(np.float32)
        block["activate"]["bias"] = 0.2 * rng.randn(
            *block["activate"]["bias"].shape).astype(np.float32)
    return tree


def lpips_tree(seed=5):
    return _jit_init(lpips_init, seed, width_scale=0.25)


def write_fid_inception(path, tree):
    """``tree`` in the pytorch-fid release's schema: with the classifier
    (``fc.*``), the aux head (``AuxLogits.*``) and ``num_batches_tracked`` in
    every batch norm, which the importers drop."""
    sd = state_dict_from_jax(tree)
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    sd["fc.weight"] = torch.zeros(1008, 8)
    sd["fc.bias"] = torch.zeros(1008)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(4, 4, 1, 1)
    sd["AuxLogits.conv0.bn.num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, path)
    return str(path)


def write_lpips_files(dirpath, tree):
    """(VGG16 file in torchvision's ``features.N.*`` schema, LPIPS heads in
    the reference's ``lin{k}.model.1.weight`` schema)."""
    vgg = {f"features.{k[len('vgg.'):]}": v for k, v in state_dict_from_jax(tree).items()
           if k.startswith("vgg.")}
    lins = {f"lin{k}.model.1.weight": torch.from_numpy(np.array(tree["lins"][str(k)]["weight"]))
            for k in range(5)}
    paths = str(dirpath / "vgg16.pth"), str(dirpath / "lpips_lins.pth")
    torch.save(vgg, paths[0])
    torch.save(lins, paths[1])
    return paths
