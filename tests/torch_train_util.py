"""Shared fixtures of the port's training tests: a tiny student, teacher and
discriminator written by the JAX package, and the JAX steps' random draws
rebuilt from their keys so that both packages see the same draws."""

import dataclasses
import hashlib
import os
import pickle
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import random

from content_aware_gan_compression_tpu.models import (
    DiscriminatorConfig as JaxDiscriminatorConfig, GeneratorConfig as JaxGeneratorConfig,
    discriminator_init, generator_init, generator_make_noise)
from content_aware_gan_compression_tpu.models.bisenet import bisenet_init
from content_aware_gan_compression_tpu.models.lpips import lpips_init
from content_aware_gan_compression_tpu.train.steps import _mixing_latents
from content_aware_gan_compression_tpu.utils import save_checkpoint as jax_save_checkpoint

# torch's intra-op threads in the port's test files: the tier-1 run keeps 6
# workers on 8 cores, and the JAX tests beside these need the cores more than
# the port's tiny tensors do
TEST_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Cap torch's intra-op threads for a test module (imported into it, it
    applies there), and restore the count after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(before)


SIZE, STYLE, N_MLP, BATCH = 16, 16, 2, 4
STUDENT_SHAPE = (16, 12, 12, 8, 8, 6)  # narrow and non-uniform, like a pruned student
TEACHER_SHAPE = (16, 16, 16, 12, 12, 8)
D_CHANNEL_MAX = 16
G_CFG = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=STUDENT_SHAPE)
T_CFG = JaxGeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=TEACHER_SHAPE)
D_CFG = JaxDiscriminatorConfig(size=SIZE, channel_max=D_CHANNEL_MAX)


def train_kw(**kw):
    """TrainConfig fields both packages share, for the tiny models: KD-L1
    only, as the CLIs run without BiSeNet and VGG weights."""
    base = dict(generated_img_size=SIZE, latent=STYLE, n_mlp=N_MLP, batch_size=BATCH,
                content_aware_KD=False, kd_lpips_lambda=0.0, seed=0)
    base.update(kw)
    return base


def _sources_digest():
    """A hash of every source the memo's values come from: this module and
    the JAX package, so that an edit to either starts a new memo."""
    import content_aware_gan_compression_tpu as jax_package

    root = os.path.dirname(jax_package.__file__)
    paths = [__file__] + sorted(
        os.path.join(d, f) for d, _, files in os.walk(root) for f in files if f.endswith(".py"))
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.relpath(path, root).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


# what ``_memo`` computed, shared by every test process of a run (and later
# runs on the same sources) through the temporary directory: XLA's compile of
# an init or of the JAX steps' draws takes seconds, and a dozen test modules
# make the same ones. The name holds jax's version and the sources' hash.
MEMO_DIR = os.path.join(tempfile.gettempdir(),
                        f"cagc_test_memo_jax{jax.__version__}_{_sources_digest()}")


def _memo(call, compute):
    """``compute()``, read back from MEMO_DIR when a process made it before
    for the same ``call`` (a repr of everything it depends on): the draws are
    deterministic. Each call returns fresh objects."""
    path = os.path.join(MEMO_DIR, hashlib.sha256(call.encode()).hexdigest()[:32] + ".pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    out = compute()
    os.makedirs(MEMO_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, path)  # atomic: a reader sees the whole file or none
    return out


def _jit_init(init, seed, *args, **kw):
    """``init(PRNGKey(seed), *args, **kw)`` as numpy, jitted: the same draws
    as eagerly, without compiling every op on its own (``_memo``'d)."""
    def compute():
        tree = jax.jit(lambda key: init(key, *args, **kw))(random.PRNGKey(seed))
        return jax.tree_util.tree_map(np.asarray, tree)
    return _memo(repr(("init", init.__module__, init.__qualname__, seed, args,
                       sorted(kw.items()))), compute)


def record_train_configs(monkeypatch):
    """The ``TrainConfig``s a CLI makes through the port's ``train``
    package, in a list that fills as it runs (``monkeypatch`` undoes the
    patch)."""
    from content_aware_gan_compression_torch import train

    made = []

    class Recorded(train.TrainConfig):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    monkeypatch.setattr(train, "TrainConfig", Recorded)
    return made


def jax_params(g_cfg=G_CFG, t_cfg=T_CFG, d_cfg=D_CFG):
    """(student, teacher, D) trees as numpy, with the zero-at-init noise
    weights and biases set so that every term of the epilogue counts."""
    g = _jit_init(generator_init, 0, g_cfg)
    t = _jit_init(generator_init, 1, t_cfg)
    d = _jit_init(discriminator_init, 2, d_cfg)
    rng = np.random.RandomState(0)
    for tree in (g, t):
        for block in [tree["conv1"], *tree["convs"].values()]:
            block["noise"]["weight"] = 0.5 * rng.randn(1).astype(np.float32)
            block["activate"]["bias"] = 0.2 * rng.randn(
                *block["activate"]["bias"].shape).astype(np.float32)
    return g, t, d


def randomize_batch_norms(tree, seed):
    """Random eval statistics and affine terms in every batch norm of a
    numpy tree, drawn from ``seed``, so that the folded scale and shift are
    not the identity."""
    rng = np.random.RandomState(seed)

    def visit(node):
        for child in node.values():
            if isinstance(child, dict) and "running_var" in child:
                c = child["running_var"].shape[0]
                child["running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                child["running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                child["weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
                child["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            elif isinstance(child, dict):
                visit(child)
    visit(tree)
    return tree


def bisenet_tree(width_scale, seed=0):
    """A ``bisenet_init`` tree as numpy, batch norms randomized."""
    return randomize_batch_norms(_jit_init(bisenet_init, seed, width_scale=width_scale), seed)


# a width-0.25 parser whose parse of the tiny generators' images is not one
# class (random parsers mostly parse every pixel as one class)
PARSER_SEED = 2


def aux_trees():
    """(LPIPS, BiSeNet) trees of the full objective's aux nets, widths
    scaled 0.25, as numpy."""
    lp = _jit_init(lpips_init, 5, width_scale=0.25)
    return lp, bisenet_tree(0.25, seed=PARSER_SEED)


def coi_share(parser, img_nhwc):
    """The share of pixels the mask keeps in ``img_nhwc``, parsed by the
    port's ``parser``."""
    from content_aware_gan_compression_torch.models import make_parse_fn
    from content_aware_gan_compression_torch.pruning import (
        batch_img_parsing, coi_mask_from_parsing)

    parse = batch_img_parsing(img_nhwc, make_parse_fn(parser, "NHWC"), "NHWC")
    return float(coi_mask_from_parsing(parse).float().mean())


def write_checkpoints(dirpath, params=None):
    """student.npz {'g', 'g_ema', 'd'} and teacher.npz {'g_ema'}, as the JAX
    package writes them, from ``params`` (default ``jax_params()``)."""
    g, t, d = params or jax_params()
    student, teacher = str(dirpath / "student.npz"), str(dirpath / "teacher.npz")
    jax_save_checkpoint(student, {"g": g, "g_ema": g, "d": d})
    jax_save_checkpoint(teacher, {"g_ema": t})
    return student, teacher


def reals(n, seed=3, size=SIZE):
    return (np.random.RandomState(seed).rand(n, BATCH, size, size, 3) * 255).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mix(key, cfg, batch, g_cfg=G_CFG):
    zs, inject_index = _mixing_latents(key, batch, cfg, g_cfg.n_latent)
    return [_t(z) for z in zs], torch.tensor(int(inject_index))


# TrainConfig's paths, which differ from run to run and no draw reads
_PATH_FIELDS = ("data_folder", "ckpt", "teacher")


def _draws_call(name, key, cfg, *net_configs):
    """The memo key of a draw: every field of ``cfg`` but its paths."""
    fields = sorted((k, v) for k, v in dataclasses.asdict(cfg).items() if k not in _PATH_FIELDS)
    return repr((name, np.asarray(key).tolist(), fields, *net_configs))


def d_draws(key, cfg, g_cfg=G_CFG):
    """What the JAX d_step draws from its key (``_memo``'d)."""
    def compute():
        k_mix, k_noise = random.split(key)
        zs, idx = _mix(k_mix, cfg, cfg.batch_size, g_cfg)
        return {"z": zs, "inject_index": idx,
                "noise": [_t(n) for n in generator_make_noise(k_noise, g_cfg, cfg.batch_size)]}
    return _memo(_draws_call("d", key, cfg, g_cfg), compute)


def g_draws(key, cfg, g_cfg=G_CFG, t_cfg=T_CFG):
    """What the JAX g_step draws from its key (``_memo``'d)."""
    def compute():
        k_mix, k_noise, k_tnoise = random.split(key, 3)
        zs, idx = _mix(k_mix, cfg, cfg.batch_size, g_cfg)
        return {"z": zs, "inject_index": idx,
                "noise": [_t(n) for n in generator_make_noise(k_noise, g_cfg, cfg.batch_size)],
                "teacher_noise": [_t(n) for n in generator_make_noise(k_tnoise, t_cfg,
                                                                       cfg.batch_size)]}
    return _memo(_draws_call("g", key, cfg, g_cfg, t_cfg), compute)


def g_reg_draws(key, cfg, g_cfg=G_CFG):
    """What the JAX g_reg_step draws from its key, y unscaled (``_memo``'d)."""
    def compute():
        batch = max(1, cfg.batch_size // cfg.path_reg_batch_shrink)
        k_mix, k_noise, k_ppl = random.split(key, 3)
        k_z, k_p, k_i = random.split(k_mix, 3)
        z = random.normal(k_z, (2, batch, cfg.latent))
        do_mix = random.uniform(k_p) < cfg.noise_mixing
        idx = jnp.where(do_mix, random.randint(k_i, (), 1, g_cfg.n_latent), g_cfg.n_latent)
        return {"z": [_t(z[0]), _t(z[1])], "inject_index": torch.tensor(int(idx)),
                "noise": [_t(n) for n in generator_make_noise(k_noise, g_cfg, batch)],
                "ppl_noise": _t(random.normal(k_ppl, (batch, g_cfg.size, g_cfg.size, 3)))}
    return _memo(_draws_call("g_reg", key, cfg, g_cfg), compute)


def trainer_draws(jax_trainer, iter_idx):
    """The draws JAX's Trainer.step takes at ``iter_idx`` from its current
    key: on R1 iterations d_step and g_step get their keys directly, on the
    others the fused dg_step splits one key in two."""
    cfg, g_cfg, t_cfg = jax_trainer.cfg, jax_trainer.g_config, jax_trainer.teacher_config
    _, k_d, k_g, k_greg = random.split(jax_trainer.rng, 4)
    if iter_idx % cfg.d_reg_freq != 0:
        k_d, k_g = random.split(k_d)
    draws = {"d": d_draws(k_d, cfg, g_cfg), "g": g_draws(k_g, cfg, g_cfg, t_cfg)}
    if iter_idx % cfg.g_reg_freq == 0:
        draws["g_reg"] = g_reg_draws(k_greg, cfg, g_cfg)
    return draws
