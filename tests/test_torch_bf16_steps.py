"""One bfloat16 step of each kind of the port (d, d_reg, g with the full
objective, g_reg) against the JAX package's ``make_train_steps(dtype=
jnp.bfloat16)``, and Adam's second moment stored in bfloat16 against
``_reg_ratio_adam(state_dtype="bfloat16")``, on the CPU at 16px (the tiny
student, teacher and D of ``torch_train_util``, width-0.25 aux nets).

Both packages take the same trees and draws. bfloat16 rounds at other
places in each, so neither is held to the other directly: each is held
against the port's step in float64 on the same inputs. The distance of a
step is that of its gradient: |a - b| / |b| over all parameters of the
trained network as one vector, b from float64. The port's must be at most
2x JAX's + 1e-3. Each loss's relative distance must be at most 2x JAX's +
2^-7, bfloat16's epsilon: a scalar like R1, a score's mean or the path
lengths' spread moves by 1-3% in either package, by chance more in one
than in the other. JAX's gradients are read off its step:
its optimizer here keeps the gradient as its state. lr is 0, so the port's
step leaves the weights as they are and its gradients in ``.grad``.

The port's steps run with oneDNN off: its bfloat16 convolution, PyTorch's
CPU default, takes R1's second order 18% from float64 where JAX and the
port with oneDNN off stay near 3% (the card runs cuDNN); off, it also keeps
VGG's max-pool ties (tests/test_torch_train_steps.py).

Two traps. The bfloat16 parse's argmax flips mask pixels, on other pixels
in each package, and a flipped pixel moves the KD losses by far more than
bfloat16 does. So the full objective first holds each package's bfloat16
class map to the float64 one (the port's disagreement at most 2x JAX's +
1e-3), and then every run masks with the float64 class map: the port's
through a parser that returns it, JAX's through ``bisenet_apply_nhwc``
replaced for the test. And the R1 and path-length gradients are grads of
grads, which float32 already rounds by up to 3% (ROADMAP Queue 3);
bfloat16 more so, in both packages alike."""

import copy
from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from jax import random

from content_aware_gan_compression_tpu.models import bisenet as jax_bisenet
from content_aware_gan_compression_tpu.models.bisenet import bisenet_apply_nhwc
from content_aware_gan_compression_tpu.train import TrainConfig as JaxTrainConfig
from content_aware_gan_compression_tpu.train import make_train_steps
from content_aware_gan_compression_tpu.train.steps import _reg_ratio_adam
from content_aware_gan_compression_tpu.pruning.content_aware import batch_img_parsing_nhwc
from content_aware_gan_compression_torch import train
from content_aware_gan_compression_torch.models import make_parse_fn
from content_aware_gan_compression_torch.pruning import batch_img_parsing
from content_aware_gan_compression_torch.utils import (
    build_bisenet_from_state_dict, build_discriminator_from_state_dict,
    build_generator_from_state_dict, build_lpips_from_state_dict, state_dict_from_jax)
from torch_train_util import (
    D_CFG, G_CFG, N_MLP, SIZE, STYLE, T_CFG, aux_trees, d_draws, g_draws, jax_params, reals,
    train_kw)
from torch_train_util import torch_threads  # noqa: F401

BF = torch.bfloat16
KW = train_kw(content_aware_KD=True, kd_lpips_lambda=3.0, init_lr=0.0)


def grad_keeper():
    """An optax transformation that moves nothing and keeps the gradient
    as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           grads))


@pytest.fixture(scope="module")
def setup():
    gp, tp, dp = jax_params()
    lp, parse = aux_trees()
    cfg = JaxTrainConfig(**KW)
    d_step, d_reg_step, g_step, g_reg_step, _ = make_train_steps(
        G_CFG, D_CFG, cfg, teacher_config=T_CFG, dtype=jnp.bfloat16)
    keep = grad_keeper()
    jitted = {"d": jax.jit(partial(d_step, d_opt=keep)),
              "d_reg": jax.jit(partial(d_reg_step, d_opt=keep)),
              "g": jax.jit(partial(g_step, g_opt=keep)),
              "g_reg": jax.jit(partial(g_reg_step, g_opt=keep))}
    nets = {"g": build_generator_from_state_dict(gp, SIZE, STYLE, N_MLP, device="cpu"),
            "t": build_generator_from_state_dict(tp, SIZE, STYLE, N_MLP, device="cpu"),
            "d": build_discriminator_from_state_dict(dp, SIZE, device="cpu"),
            "lpips": build_lpips_from_state_dict(lp, device="cpu"),
            "parser": build_bisenet_from_state_dict(parse, device="cpu")}
    for net in (nets["t"], nets["lpips"], nets["parser"]):
        net.requires_grad_(False).eval()
    nets64 = {k: copy.deepcopy(v).double() for k, v in nets.items()}
    real = reals(1)[0].astype(np.float32) / 127.5 - 1.0
    return dict(trees=(gp, tp, dp, lp, parse), jitted=jitted, keep=keep, nets=nets,
                nets64=nets64, real=real, cfg=train.TrainConfig(**KW), jcfg=cfg)


def _double(draws):
    return {k: ([t.double() for t in v] if isinstance(v, list)
                else v.double() if v.is_floating_point() else v) for k, v in draws.items()}


class FixedParse(torch.nn.Module):
    """Stands in for BiSeNet: head-0 logits one-hot in a given class map."""

    def __init__(self, class_map):
        super().__init__()
        self.register_buffer("one_hot", torch.nn.functional.one_hot(class_map, 19))

    def forward(self, x, data_format="NCHW", heads=1):
        return (self.one_hot.to(x.dtype),)


def _port(s, step, draws, trained, f64, parser=None):
    """The port's step in bfloat16 (f64 False) or float64: its metrics and
    the gradients of ``trained``."""
    nets = copy.deepcopy(s["nets64"] if f64 else s["nets"])
    g_opt, d_opt = train.make_optimizers(nets["g"], nets["d"], s["cfg"])
    real = torch.from_numpy(s["real"])
    dtype = None if f64 else BF
    if f64:
        real, draws = real.double(), draws and _double(draws)
    cfg = s["cfg"]
    with torch.backends.mkldnn.flags(enabled=False):
        return _run_step(nets, g_opt, d_opt, step, real, draws, cfg, dtype, trained, parser)


def _run_step(nets, g_opt, d_opt, step, real, draws, cfg, dtype, trained, parser):
    if step == "d":
        m = train.d_step(nets["g"], nets["d"], d_opt, real, draws, cfg, dtype)
    elif step == "d_reg":
        m = train.d_reg_step(nets["d"], d_opt, real, cfg, dtype)
    elif step == "g":
        m = train.g_step(nets["g"], g_opt, nets["d"], draws, cfg, nets["t"], nets["lpips"],
                         parser or nets["parser"], dtype)
    else:
        _, m = train.g_reg_step(nets["g"], g_opt, draws, torch.tensor(0.7).to(real.dtype), cfg,
                                dtype)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().double()
             for n, p in nets[trained].named_parameters()}
    return {k: float(v) for k, v in m.items()}, grads


def _distance(grads, f64):
    num = sum(float((grads[n] - w).square().sum()) for n, w in f64.items())
    return (num / sum(float(w.square().sum()) for w in f64.values())) ** 0.5


def _hold(port, jx, f64, what):
    """port and JAX (metrics, gradients) against float64, by the module's
    rule; returns the gradient distances."""
    assert set(port[0]) == set(jx[0]) == set(f64[0]), what
    for k, want in f64[0].items():
        dp, dj = (abs(run[0][k] - want) / abs(want) for run in (port, jx))
        assert dp <= 2 * dj + 2 ** -7, (what, k, dp, dj)
    dp, dj = _distance(port[1], f64[1]), _distance(jx[1], f64[1])
    assert dp <= 2 * dj + 1e-3, (what, dp, dj)
    return dp, dj


def _jax_grads(state, names):
    g = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state))
    return {n: g[n].double() for n in names}


def test_d_step_bf16(setup):
    s = setup
    gp, _, dp, _, _ = s["trees"]
    key = random.PRNGKey(21)
    draws = d_draws(key, s["jcfg"])
    _, state, m = s["jitted"]["d"](gp, dp, s["keep"].init(dp), jnp.asarray(s["real"]), key)
    f64 = _port(s, "d", draws, "d", True)
    jx = ({k: float(v) for k, v in m.items()}, _jax_grads(state, f64[1]))
    _hold(_port(s, "d", draws, "d", False), jx, f64, "d")


def test_d_reg_step_bf16(setup):
    s = setup
    _, _, dp, _, _ = s["trees"]
    _, state, m = s["jitted"]["d_reg"](dp, s["keep"].init(dp), jnp.asarray(s["real"]))
    f64 = _port(s, "d_reg", None, "d", True)
    jx = ({k: float(v) for k, v in m.items()}, _jax_grads(state, f64[1]))
    _hold(_port(s, "d_reg", None, "d", False), jx, f64, "d_reg")


def test_g_step_full_kd_bf16(setup, monkeypatch):
    """The full objective; first the class maps: the port's bfloat16 parse
    and JAX's, each against the float64 parse of the float64 teacher image;
    then the step, every run masking with the float64 class map."""
    s = setup
    gp, tp, dp, lp, parse = s["trees"]
    key = random.PRNGKey(22)
    draws = g_draws(key, s["jcfg"])
    t64 = s["nets64"]["t"]
    with torch.no_grad():
        img64 = t64(_double(draws)["z"], inject_index=draws["inject_index"],
                    noise=_double(draws)["teacher_noise"], output_format="NHWC")
        img = img64.float()
        maps = {"f64": batch_img_parsing(img64, make_parse_fn(s["nets64"]["parser"], "NHWC"),
                                         "NHWC"),
                "port": batch_img_parsing(img, make_parse_fn(s["nets"]["parser"], "NHWC", BF),
                                          "NHWC")}
    maps["jax"] = torch.from_numpy(np.array(jax.jit(lambda p, x: batch_img_parsing_nhwc(
        x, lambda y: bisenet_apply_nhwc(p, y.astype(jnp.bfloat16))[0].astype(jnp.float32)))(
            parse, jnp.asarray(img.numpy()))))
    share = {k: float((maps[k] != maps["f64"]).float().mean()) for k in ("port", "jax")}
    assert share["port"] <= 2 * share["jax"] + 1e-3, share
    class_map = maps["f64"]
    jax_map = jnp.asarray(class_map.numpy(), jnp.int32)
    # the map depends on x (times 0), so that XLA does not fold a
    # [4, 512, 512, 19] constant, which takes minutes
    monkeypatch.setattr(jax_bisenet, "bisenet_apply_nhwc", lambda p, x: (jax.nn.one_hot(
        jax_map + (x[..., 0] * 0).astype(jnp.int32), 19, dtype=x.dtype),))
    _, state, m = s["jitted"]["g"](gp, s["keep"].init(gp), dp, key, tp, lp, parse)
    f64 = _port(s, "g", draws, "g", True, FixedParse(class_map).double())
    jx = ({k: float(v) for k, v in m.items()}, _jax_grads(state, f64[1]))
    port = _port(s, "g", draws, "g", False, FixedParse(class_map))
    assert port[0]["kd_lpips_loss"] > 0 and port[0]["kd_l1_loss"] > 0
    _hold(port, jx, f64, "g")


def test_g_reg_step_bf16(setup):
    """JAX draws the path-length y in the image's type: bfloat16 normals."""
    s = setup
    gp = s["trees"][0]
    cfg = s["jcfg"]
    key = random.PRNGKey(23)
    batch = max(1, cfg.batch_size // cfg.path_reg_batch_shrink)
    k_mix, k_noise, k_ppl = random.split(key, 3)
    k_z, k_p, k_i = random.split(k_mix, 3)
    z = random.normal(k_z, (2, batch, cfg.latent))
    idx = jnp.where(random.uniform(k_p) < cfg.noise_mixing,
                    random.randint(k_i, (), 1, G_CFG.n_latent), G_CFG.n_latent)
    from content_aware_gan_compression_tpu.models import generator_make_noise

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    draws = {"z": [t(z[0]), t(z[1])], "inject_index": torch.tensor(int(idx)),
             "noise": [t(n) for n in generator_make_noise(k_noise, G_CFG, batch)],
             "ppl_noise": t(random.normal(k_ppl, (batch, SIZE, SIZE, 3), dtype=jnp.bfloat16))}
    _, state, _, m = s["jitted"]["g_reg"](gp, s["keep"].init(gp), key,
                                           jnp.asarray(0.7, jnp.float32))
    f64 = _port(s, "g_reg", draws, "g", True)
    jx = ({k: float(v) for k, v in m.items()}, _jax_grads(state, f64[1]))
    _hold(_port(s, "g_reg", draws, "g", False), jx, f64, "g_reg")


def test_adam_bf16_state_matches_the_jax_transform_for_three_steps():
    """nu stored in bfloat16: updated in the gradient's type from the
    stored value, the update divided by that unrounded nu, then rounded for
    storage, as ``scale_by_adam_no_mu(state_dtype=...)``. Tolerance 1e-6
    relative on the weights and bit for bit on the stored nu; a leaf
    without a gradient (None in the port, zero in JAX) decays and stays."""
    cfg = train.TrainConfig()
    jax_opt = _reg_ratio_adam(cfg.init_lr, cfg.g_reg_ratio, state_dtype="bfloat16")
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32),
              "c": rng.randn(2).astype(np.float32)}
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = train.reg_ratio_adam(tensors.values(), cfg.init_lr, cfg.g_reg_ratio, BF)
    jp, state = jax.tree_util.tree_map(jnp.asarray, params), jax_opt.init(params)
    for step in range(3):
        grads = {k: (rng.randn(*v.shape) * 10.0 ** -step).astype(np.float32)
                 for k, v in params.items()}
        grads["c"] = np.zeros_like(params["c"])
        updates, state = jax_opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tensors.items():
            p.grad = None if k == "c" else torch.from_numpy(grads[k])
        opt.step()
    assert opt.param_groups[0]["step"] == int(state[0].count) == 3
    for k, p in tensors.items():
        nu = opt.state[p]["exp_avg_sq"]
        assert nu.dtype == BF and state[0].nu[k].dtype == jnp.bfloat16
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(nu.float().numpy(),
                                      np.asarray(state[0].nu[k], np.float32))
