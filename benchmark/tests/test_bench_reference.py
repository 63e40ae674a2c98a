"""The benchmark's plain reference against the system under test, on the CPU
at small sizes in float64, from the same drawn weights and inputs: each
network's forward, R1's and path length's gradients, and three iterations
of retraining."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark.lib import traffic as tf
from benchmark.lib import weights
from benchmark.reference import aux_nets as raux
from benchmark.reference import stylegan2 as rsg
from benchmark.reference import train as rtrain

SIZE = 32
STUDENT = (64, 64, 48, 48, 32, 32, 16, 16)


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def pair(build, rule, port, seed=1):
    """The reference module and the port's, both holding one drawn state,
    in float64."""
    ref, state = weights.materialize(build, rule, seed, "cpu")
    port.load_state_dict(state)
    return ref.double(), port.double()


# the port computes StyleGAN2's demodulation in float32 whatever the
# activations' type, so a float64 generator agrees to about 1e-7
G_TOL = 1e-6


def close(a, b, tol=1e-8):
    scale = b.abs().max().item()
    assert (a - b).abs().max().item() <= tol * max(scale, 1e-30), \
        ((a - b).abs().max().item(), scale)


def draws(batch=2, seed=3):
    cfg = {"size": SIZE, "style_dim": 512}
    t = {"batch": batch, "mixing": 0.9, "g_reg_every": 1, "path_batch_shrink": 1}
    d = tf.Draws(seed, t, cfg, "cpu").iteration(0)
    return {k: {n: (v.double() if torch.is_tensor(v) and v.is_floating_point() else
                    [x.double() for x in v] if isinstance(v, list) else v)
                for n, v in ph.items()} for k, ph in d.items()}


def test_generator_and_path_lengths():
    from content_aware_gan_compression_torch.models import Generator, GeneratorConfig

    ref, port = pair(lambda: rsg.Generator(SIZE, STUDENT), rsg.init_rule,
                     Generator(GeneratorConfig(size=SIZE, net_shape=STUDENT), device="cpu"))
    d = draws()["g_reg"]
    img = port(d["z"], inject_index=d["inject_index"], noise=d["noise"])
    close(ref(d["z"], d["inject_index"], d["noise"]), img, G_TOL)
    _, pl = port(d["z"], inject_index=d["inject_index"], noise=d["noise"], PPL_regularize=True,
                 ppl_noise=d["ppl_noise"])
    pl_ref = ref.path_lengths(d["z"], d["inject_index"], d["noise"], d["ppl_noise"])
    close(pl_ref, pl, G_TOL)
    gp = torch.autograd.grad(pl.square().sum(), list(port.parameters()), allow_unused=True)
    gr = torch.autograd.grad(pl_ref.square().sum(), list(ref.parameters()), allow_unused=True)
    for a, b in zip(gp, gr):
        if b is not None:
            close(a, b, 10 * G_TOL)


def test_discriminator_and_r1():
    from content_aware_gan_compression_torch.models import Discriminator, DiscriminatorConfig

    ref, port = pair(lambda: rsg.Discriminator(SIZE), rsg.init_rule,
                     Discriminator(DiscriminatorConfig(size=SIZE), device="cpu"))
    x = torch.randn(4, 3, SIZE, SIZE, dtype=torch.float64, requires_grad=True)
    xp = x.detach().permute(0, 2, 3, 1).requires_grad_(True)
    out_r, out_p = ref(x), port(xp)
    close(out_r, out_p)
    (gr,) = torch.autograd.grad(out_r.sum(), x, create_graph=True)
    (gp,) = torch.autograd.grad(out_p.sum(), xp, create_graph=True)
    close(gr, gp.permute(0, 3, 1, 2))
    wr = torch.autograd.grad(gr.square().sum(), list(ref.parameters()), allow_unused=True)
    wp = torch.autograd.grad(gp.square().sum(), list(port.parameters()), allow_unused=True)
    scale = max(b.abs().max().item() for b in wr if b is not None)
    for a, b, p in zip(wp, wr, ref.parameters()):
        a, b = (torch.zeros_like(p) if t is None else t for t in (a, b))
        assert (a - b).abs().max().item() <= 1e-8 * scale


def test_aux_nets():
    from content_aware_gan_compression_torch.models import LPIPS, BiSeNet, InceptionV3
    from content_aware_gan_compression_torch.pruning.content_aware import (
        batch_img_parsing, get_masked_tensor)
    from content_aware_gan_compression_torch.models.bisenet import make_parse_fn

    img = torch.rand(2, 3, SIZE, SIZE, dtype=torch.float64) * 2 - 1
    img2 = torch.rand(2, 3, SIZE, SIZE, dtype=torch.float64) * 2 - 1
    ref, port = pair(raux.LPIPS, raux.lpips_rule, LPIPS(device="cpu"))
    close(ref(img, img2), port(img, img2).reshape(-1))
    ref, port = pair(raux.InceptionV3, raux.inception_rule, InceptionV3(device="cpu"))
    close(ref(img), port(img, normalize_input=False))
    ref, port = pair(raux.BiSeNet, raux.bisenet_rule, BiSeNet(device="cpu"), seed=5)
    x = torch.randn(1, 3, 64, 64, dtype=torch.float64)
    close(ref(x), port(x, heads=1)[0])
    masked = get_masked_tensor(img, batch_img_parsing(img, make_parse_fn(port)))
    close(img * raux.coi_mask(ref, img), masked)


def test_three_iterations():
    """The reference's iterations 0-2 (every phase, then neither
    regularizer) against the port's steps, in float64."""
    from content_aware_gan_compression_torch.models import (
        LPIPS, BiSeNet, Discriminator, DiscriminatorConfig, Generator, GeneratorConfig)
    from content_aware_gan_compression_torch.train import TrainConfig
    from content_aware_gan_compression_torch.train import steps

    hp = rtrain.Hyper(d_reg_every=2, g_reg_every=2, path_batch_shrink=1)
    g_r, g_p = pair(lambda: rsg.Generator(SIZE, STUDENT), rsg.init_rule,
                    Generator(GeneratorConfig(size=SIZE, net_shape=STUDENT), device="cpu"))
    t_r, t_p = pair(lambda: rsg.Generator(SIZE), rsg.init_rule,
                    Generator(GeneratorConfig(size=SIZE), device="cpu"), seed=2)
    d_r, d_p = pair(lambda: rsg.Discriminator(SIZE), rsg.init_rule,
                    Discriminator(DiscriminatorConfig(size=SIZE), device="cpu"), seed=4)
    l_r, l_p = pair(raux.LPIPS, raux.lpips_rule, LPIPS(device="cpu"), seed=6)
    b_r, b_p = pair(raux.BiSeNet, raux.bisenet_rule, BiSeNet(device="cpu"), seed=8)
    e_r, e_p = copy.deepcopy(g_r), copy.deepcopy(g_p)
    cfg = TrainConfig(generated_img_size=SIZE, batch_size=2, d_reg_freq=2, g_reg_freq=2,
                      path_reg_batch_shrink=1)
    gopt, dopt = steps.make_optimizers(g_p, d_p, cfg)
    opts = rtrain.optimizers(g_r, d_r, hp)
    nets = (g_r, d_r, e_r, t_r, l_r, b_r)
    mp_r = mp_p = torch.zeros((), dtype=torch.float64)
    for i in range(3):
        real_u8 = torch.randint(0, 256, (2, SIZE, SIZE, 3), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(i))
        d = draws(seed=10 + i)
        if i % 2:
            d.pop("g_reg")
        losses, mp_r = rtrain.iteration(i, nets, opts, real_u8, d, mp_r, hp)
        real = steps.prepare_real(real_u8, "cpu").double()
        m = steps.d_step(g_p, d_p, dopt, real, d["d"], cfg)
        if i % 2 == 0:
            m.update(steps.d_reg_step(d_p, dopt, real, cfg))
        m.update(steps.g_step(g_p, gopt, d_p, d["g"], cfg, t_p, l_p, b_p))
        if i % 2 == 0:
            mp_p, mm = steps.g_reg_step(g_p, gopt, d["g_reg"], mp_p, cfg)
            m.update(mm)
        steps.ema_accumulate(e_p, g_p)
        for k, v in losses.items():
            key = {"kd_l1": "kd_l1_loss", "kd_lpips": "kd_lpips_loss"}.get(k, k)
            assert abs(m[key].item() - v) <= 10 * G_TOL * abs(v), (i, k, m[key].item(), v)
    for a, b in ((g_p, g_r), (d_p, d_r), (e_p, e_r)):
        for (k, pa), pb in zip(a.named_parameters(), b.parameters()):
            close(pa.detach(), pb.detach(), 10 * G_TOL)
