"""The four training steps (reference train.py:241-338; the JAX package's
train/steps.py), the reg-ratio Adam and the EMA.

Each step takes its random draws as arguments: the z pair, the mixing point
``inject_index`` (``n_latent`` means no mixing, as the JAX package's
``_mixing_latents``), the noise maps, the teacher's noise and the
path-length ``y``. ``draw_*`` make them from a ``torch.Generator``; a test
can hand both packages the same draws instead.

Each step differentiates only its own network: the other one runs without
gradients or is left out of ``backward(inputs=...)``, which is what the
reference's requires_grad toggling does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bisenet import make_parse_fn
from .config import LPIPS_IMAGE_SIZE
from .losses import d_logistic_loss, g_nonsaturating_loss, kd_loss, r1_penalty

EMA_ACCUM = 0.5 ** (32 / (10 * 1000))  # reference train.py:367


class AdamNoMu(torch.optim.Optimizer):
    """Adam with b1 == 0, the JAX package's ``scale_by_adam_no_mu`` then
    ``scale(-lr)``, in its order of operations.

    The reference's betas are (0**ratio, 0.99**ratio) (train.py:528-537), and
    with b1 == 0 the first moment is the gradient itself, so no buffer holds
    it: the update is ``-lr * g / (sqrt(nu / (1 - b2**t)) + eps)``. As in
    optax, the step count ``t`` is one per optimizer (``param_groups[0]
    ["step"]``), and a parameter without a gradient counts as a zero one: its
    ``nu`` decays and it does not move.
    """

    def __init__(self, params, lr: float, b2: float, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "b2": b2, "eps": eps, "step": 0})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamNoMu takes no closure")
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b2, t = group["b2"], group["step"] + 1
            group["step"] = t
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            nus = []
            for p in params:
                if "exp_avg_sq" not in self.state[p]:
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
                nus.append(self.state[p]["exp_avg_sq"])
            # nu = (1 - b2) * g^2 + b2 * nu
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            # bias correction in float32, as optax computes it
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(grads, denom)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)


def reg_ratio_adam(params, lr: float, ratio: float) -> AdamNoMu:
    """Adam at lr * ratio with betas (0, 0.99**ratio), eps 1e-8 (reference
    train.py:528-537): the lazy regularizers' step-size correction."""
    return AdamNoMu(params, lr * ratio, 0.99 ** ratio)


def make_optimizers(g, d, cfg):
    return (reg_ratio_adam(g.parameters(), cfg.init_lr, cfg.g_reg_ratio),
            reg_ratio_adam(d.parameters(), cfg.init_lr, cfg.d_reg_ratio))


@torch.no_grad()
def ema_accumulate(g_ema, g, decay: float = EMA_ACCUM) -> None:
    """g_ema = decay * g_ema + (1 - decay) * g over the parameters
    (reference accumulate, train.py:124-129). Buffers (the noise maps) get no
    update on either side and stay as they are."""
    ema, params = list(g_ema.parameters()), list(g.parameters())
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))


def prepare_real(batch, device) -> torch.Tensor:
    """A uint8 [B, H, W, 3] host batch -> float32 NHWC in [-1, 1] on
    ``device`` (the 4x smaller copy crosses the bus; the JAX package's
    ``_prep``). A float tensor passes through."""
    t = torch.as_tensor(batch)
    if t.dtype != torch.uint8:
        return t.to(device)
    return t.to(device, non_blocking=True).float() / 127.5 - 1.0


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


def draw_mixing(gen, batch: int, cfg, n_latent: int, device):
    """Two z draws and the mixing point (reference mixing_noise,
    train.py:218-237): ``inject_index`` is uniform in [1, n_latent) with
    probability ``noise_mixing`` and ``n_latent`` (no mixing) otherwise. It
    stays on the device, so no draw waits for the host."""
    z = torch.randn(2, batch, cfg.latent, generator=gen, device=device)
    do_mix = torch.rand((), generator=gen, device=device) < cfg.noise_mixing
    index = torch.randint(1, n_latent, (), generator=gen, device=device)
    return [z[0], z[1]], torch.where(do_mix, index, torch.full_like(index, n_latent))


def draw_d(gen, g, cfg) -> dict:
    """Draws of the D step: the fake batch's latents and noise."""
    zs, inject_index = draw_mixing(gen, cfg.batch_size, cfg, g.config.n_latent, g.device)
    return {"z": zs, "inject_index": inject_index,
            "noise": g.make_noise(cfg.batch_size, gen)}


def draw_g(gen, g, cfg, teacher=None) -> dict:
    """Draws of the G step: latents and noise, and the teacher's own noise."""
    out = draw_d(gen, g, cfg)
    if teacher is not None:
        out["teacher_noise"] = teacher.make_noise(cfg.batch_size, gen)
    return out


def draw_g_reg(gen, g, cfg) -> dict:
    """Draws of the path-length step, at the path batch: latents, noise and
    the standard normal ``ppl_noise`` that becomes ``y``."""
    batch = max(1, cfg.batch_size // cfg.path_reg_batch_shrink)
    zs, inject_index = draw_mixing(gen, batch, cfg, g.config.n_latent, g.device)
    size = g.config.size
    return {"z": zs, "inject_index": inject_index, "noise": g.make_noise(batch, gen),
            "ppl_noise": torch.randn(batch, size, size, 3, generator=gen, device=g.device)}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _f32_up(t):
    """``t`` in float32 at least: the losses run in float32, as in the JAX
    steps, and a float64 run stays in float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _fake(g, draws, **kw):
    return g(draws["z"], inject_index=draws["inject_index"], noise=draws["noise"],
             output_format="NHWC", **kw)


def d_step(g, d, d_opt, real, draws, cfg) -> dict:
    """D GAN step (reference D_Loss_BackProp): logistic loss on a fresh fake
    batch and the real batch, then one Adam step of D."""
    with torch.no_grad():
        fake = _fake(g, draws)
    fake_pred = d(fake)
    real_pred = d(real)
    loss = d_logistic_loss(real_pred.float(), fake_pred.float())
    d_opt.zero_grad(set_to_none=True)
    loss.backward()
    d_opt.step()
    return {"d": loss.detach(), "real_score": real_pred.detach().mean(),
            "fake_score": fake_pred.detach().mean()}


def d_reg_step(d, d_opt, real, cfg) -> dict:
    """D R1 step (reference D_Reg_BackProp): grad of grad through D."""
    r1 = r1_penalty(d, real)
    d_opt.zero_grad(set_to_none=True)
    (cfg.discriminator_r1 / 2 * r1 * cfg.d_reg_freq).backward()
    d_opt.step()
    return {"r1": r1.detach()}


def g_step(g, g_opt, d, draws, cfg, teacher=None, lpips=None, parser=None) -> dict:
    """G GAN + KD step (reference G_Loss_BackProp), against the D it is
    given, which the caller has already updated this iteration. ``lpips``
    (an ``LPIPS``) adds the LPIPS term and ``parser`` (a ``BiSeNet``) the
    content-aware mask: head 0 on the teacher's image, in float32. Both are
    frozen; only ``g`` takes gradients."""
    need_lists = cfg.kd_mode == "Intermediate"
    teacher_list = None
    if teacher is not None:
        with torch.no_grad():
            t_out = teacher(draws["z"], inject_index=draws["inject_index"],
                            noise=draws["teacher_noise"], output_format="NHWC",
                            return_rgb_list=need_lists)
        teacher_list = list(t_out) if need_lists else [t_out]
    g_out = _fake(g, draws, return_rgb_list=need_lists)
    fake_list = list(g_out) if need_lists else [g_out]
    fake_img = fake_list[-1]
    g_loss = g_nonsaturating_loss(d(fake_img).float())
    metrics = {"g": g_loss.detach()}
    total = g_loss
    if teacher_list is not None:
        kd_l1, kd_lpips = kd_loss(
            _f32_up(fake_img), [_f32_up(f) for f in fake_list],
            [_f32_up(t) for t in teacher_list], kd_l1_lambda=cfg.kd_l1_lambda,
            kd_lpips_lambda=cfg.kd_lpips_lambda, kd_mode=cfg.kd_mode,
            size=cfg.generated_img_size, lpips=lpips,
            parse_fn=None if parser is None else make_parse_fn(parser, "NHWC"),
            lpips_image_size=LPIPS_IMAGE_SIZE, data_format="NHWC")
        metrics["kd_l1_loss"] = kd_l1.detach()
        metrics["kd_lpips_loss"] = kd_lpips.detach()
        total = g_loss + kd_l1 + kd_lpips
    g_opt.zero_grad(set_to_none=True)
    total.backward(inputs=list(g.parameters()))
    g_opt.step()
    return metrics


def g_reg_step(g, g_opt, draws, mean_path_length, cfg):
    """G path-length step (reference G_Reg_BackProp): the path lengths'
    spread around their running mean, decayed by 0.01. Returns (the new
    running mean, metrics)."""
    _, path_lengths = g(draws["z"], inject_index=draws["inject_index"], noise=draws["noise"],
                        PPL_regularize=True, ppl_noise=draws["ppl_noise"])
    path_mean = mean_path_length + 0.01 * (path_lengths.mean() - mean_path_length)
    path_loss = torch.mean(torch.square(path_lengths - path_mean))
    g_opt.zero_grad(set_to_none=True)
    (cfg.generator_path_reg_weight * cfg.g_reg_freq * path_loss).backward(
        inputs=list(g.parameters()))
    g_opt.step()
    return path_mean.detach(), {"path": path_loss.detach(),
                                "path_length": path_lengths.detach().mean()}
