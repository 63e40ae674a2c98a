"""The port's training steps against the JAX package's, on the CPU, at a tiny
size (16px, a narrow non-uniform student, a wider teacher, a D with 16
channels, batch 4). Both start from the same JAX trees and take the same
draws: the port's steps take them as arguments, rebuilt from the keys the
JAX steps draw from.

Two comparisons for each step:
  * its loss values, and its gradients against jax.grad of the same loss
    built from the JAX package's public functions (1e-4 of each tensor's
    largest gradient: fp32 sums taken in another order, twice for R1 and the
    path length);
  * the whole step against the JAX step from make_train_steps: new weights,
    Adam's second moment and the running mean path length. Adam's first step
    is about lr * sign(g), so a weight whose gradient lies within rounding of
    0 may move the other way; updated weights are held to 1e-5 except where
    |g| < 1e-5 of the tensor's largest gradient.
"""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from content_aware_gan_compression_tpu.models import discriminator_apply, generator_apply
from content_aware_gan_compression_tpu.train import TrainConfig as JaxTrainConfig
from content_aware_gan_compression_tpu.train import ema_accumulate as jax_ema_accumulate
from content_aware_gan_compression_tpu.train import make_optimizers as jax_make_optimizers
from content_aware_gan_compression_tpu.train import make_train_steps
from content_aware_gan_compression_tpu.models.bisenet import bisenet_apply_nhwc
from content_aware_gan_compression_tpu.train.losses import (
    d_logistic_loss as jax_d_logistic_loss, g_nonsaturating_loss as jax_g_nonsaturating_loss)
from content_aware_gan_compression_tpu.train.losses import kd_loss as jax_kd_loss
from content_aware_gan_compression_torch import train
from content_aware_gan_compression_torch.utils import (
    build_bisenet_from_state_dict, build_discriminator_from_state_dict,
    build_generator_from_state_dict, build_lpips_from_state_dict, optimizer_state_to_jax,
    state_dict_from_jax)
from torch_train_util import (
    D_CFG, G_CFG, N_MLP, SIZE, STYLE, T_CFG, aux_trees, coi_share, d_draws, g_draws,
    g_reg_draws, jax_params, reals, train_kw)
from torch_train_util import torch_threads  # noqa: F401

GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    gp, tp, dp = jax_params()
    jcfg = JaxTrainConfig(**train_kw())
    steps = make_train_steps(G_CFG, D_CFG, jcfg, teacher_config=T_CFG)
    g_opt, d_opt = jax_make_optimizers(jcfg)
    real = reals(1)[0].astype(np.float32) / 127.5 - 1.0
    return dict(gp=gp, tp=tp, dp=dp, jcfg=jcfg, steps=steps, g_opt=g_opt, d_opt=d_opt,
                real=real, cfg=train.TrainConfig(**train_kw()))


def _port(s):
    g = build_generator_from_state_dict(s["gp"], SIZE, STYLE, N_MLP, device="cpu")
    t = build_generator_from_state_dict(s["tp"], SIZE, STYLE, N_MLP, device="cpu")
    d = build_discriminator_from_state_dict(s["dp"], SIZE, device="cpu")
    g_opt, d_opt = train.make_optimizers(g, d, s["cfg"])
    return g, t, d, g_opt, d_opt


def _j(tensors):
    return [jnp.asarray(t.numpy()) for t in tensors]


def _np(tree):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _grads_close(module, jax_grads):
    want = _np(jax_grads)
    for name, p in module.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = float(want[name].abs().max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def _step_close(module, opt, new_params, new_opt_state):
    """Weights after the step and Adam's state against the JAX step's."""
    want = _np(new_params)
    for name, p in module.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        off = (p.detach() - want[name]).abs() > 1e-5
        near_zero = g.abs() < 1e-5 * (float(g.abs().max()) or 1.0)
        assert not (off & ~near_zero).any(), name
    got_state = optimizer_state_to_jax(opt, module)
    nu, count = new_opt_state[0].nu, int(new_opt_state[0].count)
    assert int(got_state["[0].count"]) == count == 1
    for name, value in _np(nu).items():
        if name.startswith("noises."):  # buffers in the port: never updated
            continue
        got = got_state["[0].nu" + "".join(f"['{p}']" for p in name.split("."))]
        np.testing.assert_allclose(got.numpy(), value.numpy(), rtol=0,
                                   atol=2 * GRAD_RTOL * (float(value.abs().max()) or 1.0),
                                   err_msg=name)


def _fake_j(gp, draws, **kw):
    return generator_apply(gp, G_CFG, _j(draws["z"]),
                           inject_index=jnp.asarray(draws["inject_index"].numpy()),
                           noise=_j(draws["noise"]), output_format="NHWC", **kw)


def test_d_step_matches(setup):
    s = setup
    key = jax.random.PRNGKey(11)
    draws = d_draws(key, s["jcfg"])
    real = jnp.asarray(s["real"])
    fake = jax.jit(lambda gp: _fake_j(gp, draws))(s["gp"])  # one compile, not one per op

    def loss_j(dp):
        return jax_d_logistic_loss(discriminator_apply(dp, D_CFG, real, data_format="NHWC"),
                                   discriminator_apply(dp, D_CFG, fake, data_format="NHWC"))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_j))(s["dp"])
    step = jax.jit(partial(s["steps"][0], d_opt=s["d_opt"]))
    new_dp, new_state, m = step(s["gp"], s["dp"], s["d_opt"].init(s["dp"]), real, key)

    g, _, d, _, d_opt = _port(s)
    got = train.d_step(g, d, d_opt, torch.from_numpy(s["real"]), draws, s["cfg"])
    for k in ("d", "real_score", "fake_score"):
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got["d"]), float(want_loss), rtol=1e-5)
    _grads_close(d, want_grads)
    _step_close(d, d_opt, new_dp, new_state)
    assert all(p.grad is None for p in g.parameters())


def test_d_reg_step_matches(setup):
    s = setup
    real = jnp.asarray(s["real"])
    cfg = s["jcfg"]

    def loss_j(dp):
        grad = jax.grad(lambda im: discriminator_apply(dp, D_CFG, im, data_format="NHWC"
                                                       ).sum())(real)
        r1 = jnp.mean(jnp.sum(jnp.square(grad.reshape(grad.shape[0], -1)), axis=1))
        return cfg.discriminator_r1 / 2 * r1 * cfg.d_reg_freq, r1

    (_, want_r1), want_grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(s["dp"])
    step = jax.jit(partial(s["steps"][1], d_opt=s["d_opt"]))
    new_dp, new_state, m = step(s["dp"], s["d_opt"].init(s["dp"]), real)

    _, _, d, _, d_opt = _port(s)
    got = train.d_reg_step(d, d_opt, torch.from_numpy(s["real"]), s["cfg"])
    np.testing.assert_allclose(float(got["r1"]), float(want_r1), rtol=1e-5)
    np.testing.assert_allclose(float(got["r1"]), float(m["r1"]), rtol=1e-5)
    _grads_close(d, want_grads)
    _step_close(d, d_opt, new_dp, new_state)


@pytest.mark.parametrize("objective", ["kd_l1", "full_kd"])
def test_g_step_matches(setup, objective):
    """G GAN + KD, the teacher's image without gradient; D takes none. KD-L1
    alone, and the full objective: the BiSeNet parse of the teacher's image
    masks both images, and LPIPS adds its term (width-scaled aux nets, which
    take no gradient).

    The mask leaves constant regions, where VGG's max-pools meet exact ties;
    both packages send a tie's gradient to the window's first element, but
    oneDNN's fp32 convolution (PyTorch's CPU default) rounds equal windows
    at different positions differently and so breaks ties at random, which
    moves the noise weights' gradients past the tolerance. The port's step
    runs here with oneDNN off, which keeps the ties, as a float64 port
    does either way."""
    s = setup
    key = jax.random.PRNGKey(12)
    cfg, port_cfg, steps = s["jcfg"], s["cfg"], s["steps"]
    lpips = parser = lp_tree = parse_tree = None
    if objective == "full_kd":
        kw = train_kw(content_aware_KD=True, kd_lpips_lambda=3.0)
        cfg, port_cfg = JaxTrainConfig(**kw), train.TrainConfig(**kw)
        steps = make_train_steps(G_CFG, D_CFG, cfg, teacher_config=T_CFG)
        lp_tree, parse_tree = aux_trees()
        lpips = build_lpips_from_state_dict(lp_tree, device="cpu").requires_grad_(False).eval()
        parser = build_bisenet_from_state_dict(parse_tree, device="cpu")
        parser.requires_grad_(False).eval()
    draws = g_draws(key, cfg)
    teacher_img = jax.jit(lambda tp: generator_apply(
        tp, T_CFG, _j(draws["z"]), inject_index=jnp.asarray(draws["inject_index"].numpy()),
        noise=_j(draws["teacher_noise"]), output_format="NHWC"))(s["tp"])

    def loss_j(gp):
        fake = _fake_j(gp, draws)
        g_loss = jax_g_nonsaturating_loss(discriminator_apply(s["dp"], D_CFG, fake,
                                                              data_format="NHWC"))
        kd_l1, kd_lp = jax_kd_loss(
            fake, [fake], [teacher_img], kd_l1_lambda=cfg.kd_l1_lambda,
            kd_lpips_lambda=cfg.kd_lpips_lambda, kd_mode=cfg.kd_mode, size=SIZE,
            lpips_params=lp_tree, data_format="NHWC",
            parse_fn=None if parse_tree is None else (
                lambda x: bisenet_apply_nhwc(parse_tree, x)[0].astype(jnp.float32)))
        return g_loss + kd_l1 + kd_lp, (g_loss, kd_l1, kd_lp)

    (_, (want_g, want_kd, want_lp)), want_grads = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(s["gp"])
    step = jax.jit(partial(steps[2], g_opt=s["g_opt"]))
    new_gp, new_state, m = step(s["gp"], s["g_opt"].init(s["gp"]), s["dp"], key, s["tp"],
                                lp_tree, parse_tree)

    g, t, d, g_opt, _ = _port(s)
    with torch.backends.mkldnn.flags(enabled=objective == "kd_l1"):
        got = train.g_step(g, g_opt, d, draws, port_cfg, teacher=t, lpips=lpips, parser=parser)
    for k, want in (("g", want_g), ("kd_l1_loss", want_kd), ("kd_lpips_loss", want_lp)):
        np.testing.assert_allclose(float(got[k]), float(want), rtol=1e-5)
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=1e-5)
    assert (float(got["kd_lpips_loss"]) > 0) == (objective == "full_kd")
    _grads_close(g, want_grads)
    _step_close(g, g_opt, new_gp, new_state)
    assert all(p.grad is None for p in d.parameters())
    if objective == "full_kd":
        assert all(p.grad is None for net in (lpips, parser) for p in net.parameters())
        share = coi_share(parser, torch.from_numpy(np.array(teacher_img)))
        assert 0.0 < share < 1.0, share


def test_g_reg_step_matches(setup):
    """The path-length step from a running mean of 0.7: the loss, its
    gradient through the path lengths' grad of grad, and the new mean."""
    s = setup
    key = jax.random.PRNGKey(13)
    cfg = s["jcfg"]
    draws = g_reg_draws(key, cfg)
    mpl = 0.7
    _, _, k_ppl = jax.random.split(key, 3)

    def loss_j(gp):
        _, lengths = _fake_j(gp, draws, PPL_regularize=True, ppl_rng=k_ppl)
        path_mean = mpl + 0.01 * (lengths.mean() - mpl)
        path_loss = jnp.mean(jnp.square(lengths - path_mean))
        return cfg.generator_path_reg_weight * cfg.g_reg_freq * path_loss, path_loss

    (_, want_path), want_grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(s["gp"])
    step = jax.jit(partial(s["steps"][3], g_opt=s["g_opt"]))
    new_gp, new_state, new_mpl, m = step(s["gp"], s["g_opt"].init(s["gp"]), key,
                                         jnp.asarray(mpl, jnp.float32))

    g, _, _, g_opt, _ = _port(s)
    got_mpl, got = train.g_reg_step(g, g_opt, draws, torch.tensor(mpl), s["cfg"])
    np.testing.assert_allclose(float(got["path"]), float(want_path), rtol=1e-4)
    np.testing.assert_allclose(float(got["path"]), float(m["path"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["path_length"]), float(m["path_length"]), rtol=1e-5)
    np.testing.assert_allclose(float(got_mpl), float(new_mpl), rtol=1e-6)
    _grads_close(g, want_grads)
    _step_close(g, g_opt, new_gp, new_state)


@pytest.mark.parametrize("ratio_of", ["g", "d"])
def test_reg_ratio_adam_matches_the_jax_transform_for_three_steps(ratio_of):
    """Three updates with seeded gradients, one leaf without a gradient in
    the port (None) and a zero one in JAX: its second moment decays and it
    does not move, in both. Tolerance 1e-6 relative: one rounding order."""
    jcfg = JaxTrainConfig()
    jax_opt = jax_make_optimizers(jcfg)[0 if ratio_of == "g" else 1]
    cfg = train.TrainConfig()
    ratio = cfg.g_reg_ratio if ratio_of == "g" else cfg.d_reg_ratio
    rng = np.random.RandomState(1)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32),
              "c": rng.randn(2).astype(np.float32)}
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = train.reg_ratio_adam(tensors.values(), cfg.init_lr, ratio)
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
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(), np.asarray(state[0].nu[k]),
                                   rtol=1e-6, atol=1e-12)
    assert "exp_avg" not in opt.state[tensors["a"]]  # no first-moment buffer


def test_ema_matches(setup):
    g = build_generator_from_state_dict(setup["gp"], SIZE, STYLE, N_MLP, device="cpu")
    ema = build_generator_from_state_dict(setup["gp"], SIZE, STYLE, N_MLP, device="cpu")
    with torch.no_grad():
        for p in g.parameters():
            p.add_(0.1)
    want = jax_ema_accumulate(
        jax.tree_util.tree_map(jnp.asarray, {k: v.detach().numpy() for k, v in ema.named_parameters()}),
        {k: jnp.asarray(v.detach().numpy()) for k, v in g.named_parameters()}, train.EMA_ACCUM)
    train.ema_accumulate(ema, g)
    for k, v in ema.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]), rtol=1e-7, atol=1e-7)
    assert train.EMA_ACCUM == 0.5 ** (32 / (10 * 1000))


def test_config_mirrors_the_jax_config():
    port, ref = train.TrainConfig(), JaxTrainConfig()
    for field in port.__dataclass_fields__:
        assert getattr(port, field) == getattr(ref, field), field
    assert (port.g_reg_ratio, port.d_reg_ratio) == (ref.g_reg_ratio, ref.d_reg_ratio)
    with pytest.raises(ValueError):
        train.TrainConfig(kd_mode="output_only")


def test_kd_loss_modes_and_unported_terms():
    """The KD modes, and the terms that raised before this slice ported them:
    the teacher's parse masks both images, and LPIPS sees the final images,
    masked in Output_Only; in Intermediate the rgb-list L1 is unmasked and
    LPIPS sees the masked student and the unmasked teacher (the reference's
    quirks); above lpips_image_size both are resized to 256."""
    rng = np.random.RandomState(2)
    imgs = [torch.from_numpy(rng.randn(2, 4, 4, 3).astype(np.float32)) for _ in range(4)]
    kw = dict(kd_l1_lambda=3.0, kd_lpips_lambda=3.0, size=4, data_format="NHWC")
    l1, lp = train.kd_loss(imgs[1], imgs[:2], imgs[2:], kd_mode="Output_Only", **kw)
    torch.testing.assert_close(l1, 3.0 * (imgs[3] - imgs[1]).abs().mean())
    assert float(lp) == 0.0
    l1, _ = train.kd_loss(imgs[1], imgs[:2], imgs[2:], kd_mode="Intermediate", **kw)
    torch.testing.assert_close(l1, 3.0 * ((imgs[2] - imgs[0]).abs().mean()
                                          + (imgs[3] - imgs[1]).abs().mean()))

    # the content of interest is the top half of every image (class 1 over
    # background 0)
    class_map = torch.zeros(2, 512, 512, dtype=torch.long)
    class_map[:, :256] = 1
    one_hot = torch.nn.functional.one_hot(class_map, 19).float()
    top = torch.zeros(1, 4, 1, 1)
    top[:, :2] = 1.0
    seen = []

    def lpips(a, b, data_format):
        seen.append((a.detach(), b.detach()))
        return torch.full((a.shape[0], 1, 1, 1), 0.5)

    masked = dict(kw, parse_fn=lambda x: one_hot, lpips=lpips)
    l1, lp = train.kd_loss(imgs[1], imgs[:2], imgs[2:], kd_mode="Output_Only", **masked)
    torch.testing.assert_close(l1, 3.0 * ((imgs[3] - imgs[1]) * top).abs().mean())
    torch.testing.assert_close(lp, torch.tensor(1.5))
    torch.testing.assert_close(seen[-1][0], imgs[1] * top)
    torch.testing.assert_close(seen[-1][1], imgs[3] * top)
    l1, _ = train.kd_loss(imgs[1], imgs[:2], imgs[2:], kd_mode="Intermediate", **masked)
    torch.testing.assert_close(l1, 3.0 * ((imgs[2] - imgs[0]).abs().mean()
                                          + (imgs[3] - imgs[1]).abs().mean()))
    torch.testing.assert_close(seen[-1][0], imgs[1] * top)
    torch.testing.assert_close(seen[-1][1], imgs[3])
    train.kd_loss(imgs[1], imgs[:2], imgs[2:], kd_mode="Output_Only",
                  **dict(masked, lpips_image_size=2))
    assert seen[-1][0].shape == seen[-1][1].shape == (2, 256, 256, 3)
