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

With a process group up (``parallel``), ``cfg.batch_size`` is the global
batch: ``draw_*`` draw it whole from the one stream on every rank and each
rank keeps its rows (the mixing point is shared), the real batch comes in as
the rank's rows, each step all-reduces its network's gradients before the
optimizer's step, and the path-length mean is the global batch's, as on the
JAX package's mesh. Without one they are the one-process steps.

``dtype`` is the compute type of the networks (the JAX package's
``make_train_steps(dtype=...)``; ``TrainConfig.compute_dtype``): the
generators, D and the aux nets run in it, D's logits and the losses in
float32. None keeps float32.

``cfg.remat`` checkpoints D's res-blocks in every D call and the student's
resolution blocks in ``g_step`` and ``g_reg_step``, the JAX package's call
sites; ``d_step``'s fake, made without gradients, and the frozen teacher
run without it. The draws stay outside, so the random stream is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import parallel
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

    ``state_dtype`` (e.g. torch.bfloat16) is the type ``nu`` is stored in,
    the parameter's if None. In the JAX order: ``nu`` is updated in the
    gradient's type from the stored value, the update divides by that
    unrounded ``nu``, and only then is ``nu`` rounded for storage.
    """

    def __init__(self, params, lr: float, b2: float, eps: float = 1e-8, state_dtype=None):
        super().__init__(params, {"lr": lr, "b2": b2, "eps": eps, "step": 0})
        self.state_dtype = state_dtype

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
            stored = []
            for p in params:
                if "exp_avg_sq" not in self.state[p]:
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(p, dtype=self.state_dtype)
                stored.append(self.state[p]["exp_avg_sq"])
            # nu in the gradient's type: the stored tensors themselves when
            # they have it, else widened copies written back after the update
            nus = [v if v.dtype == g.dtype else v.to(g.dtype) for v, g in zip(stored, grads)]
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
            for v, nu in zip(stored, nus):
                if v is not nu:
                    v.copy_(nu)  # rounds to the storage type


def reg_ratio_adam(params, lr: float, ratio: float, state_dtype=None) -> AdamNoMu:
    """Adam at lr * ratio with betas (0, 0.99**ratio), eps 1e-8 (reference
    train.py:528-537): the lazy regularizers' step-size correction.
    ``state_dtype``: the type ``nu`` is stored in (the parameters' if None)."""
    return AdamNoMu(params, lr * ratio, 0.99 ** ratio, state_dtype=state_dtype)


def torch_dtype(name: str | None):
    """``TrainConfig``'s type names as a compute or storage type: None for
    "float32" (keep the parameters' type), torch.bfloat16 for "bfloat16"."""
    return {None: None, "float32": None, "bfloat16": torch.bfloat16}[name]


def make_optimizers(g, d, cfg):
    """The reg-ratio Adam pair, ``nu`` stored in ``cfg.opt_state_dtype``."""
    sd = torch_dtype(cfg.opt_state_dtype)
    return (reg_ratio_adam(g.parameters(), cfg.init_lr, cfg.g_reg_ratio, sd),
            reg_ratio_adam(d.parameters(), cfg.init_lr, cfg.d_reg_ratio, sd))


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
    ``_prep``). A float batch passes through in NHWC; a 3-channel NCHW one
    (the float loader's) is made NHWC on ``device``, as the JAX steps'
    ``_as_nhwc_image`` does."""
    t = torch.as_tensor(batch)
    if t.dtype == torch.uint8:
        return t.to(device, non_blocking=True).float() / 127.5 - 1.0
    t = t.to(device)
    if t.shape[1] == 3 and t.shape[-1] != 3:
        t = t.permute(0, 2, 3, 1).contiguous()
    return t


# ---------------------------------------------------------------------------
# random draws
# ---------------------------------------------------------------------------


def draw_mixing(gen, batch: int, cfg, n_latent: int, device):
    """Two z draws of the global ``batch`` and the mixing point (reference
    mixing_noise, train.py:218-237): ``inject_index`` is uniform in [1,
    n_latent) with probability ``noise_mixing`` and ``n_latent`` (no mixing)
    otherwise. It stays on the device, so no draw waits for the host. Each
    rank keeps its rows of z."""
    z = torch.randn(2, batch, cfg.latent, generator=gen, device=device)
    do_mix = torch.rand((), generator=gen, device=device) < cfg.noise_mixing
    index = torch.randint(1, n_latent, (), generator=gen, device=device)
    return ([parallel.shard_rows(z[0]), parallel.shard_rows(z[1])],
            torch.where(do_mix, index, torch.full_like(index, n_latent)))


def _noise(net, batch, gen):
    """``net``'s noise maps for the global ``batch``; the rank's rows."""
    return [parallel.shard_rows(n) for n in net.make_noise(batch, gen)]


def draw_d(gen, g, cfg) -> dict:
    """Draws of the D step: the fake batch's latents and noise."""
    zs, inject_index = draw_mixing(gen, cfg.batch_size, cfg, g.config.n_latent, g.device)
    return {"z": zs, "inject_index": inject_index, "noise": _noise(g, cfg.batch_size, gen)}


def draw_g(gen, g, cfg, teacher=None) -> dict:
    """Draws of the G step: latents and noise, and the teacher's own noise."""
    out = draw_d(gen, g, cfg)
    if teacher is not None:
        out["teacher_noise"] = _noise(teacher, cfg.batch_size, gen)
    return out


def draw_g_reg(gen, g, cfg) -> dict:
    """Draws of the path-length step, at the path batch: latents, noise and
    the standard normal ``ppl_noise`` that becomes ``y``."""
    batch = max(1, cfg.batch_size // cfg.path_reg_batch_shrink)
    zs, inject_index = draw_mixing(gen, batch, cfg, g.config.n_latent, g.device)
    size = g.config.size
    noise = _noise(g, batch, gen)  # before ppl_noise: the stream's order
    ppl_noise = torch.randn(batch, size, size, 3, generator=gen, device=g.device)
    return {"z": zs, "inject_index": inject_index, "noise": noise,
            "ppl_noise": parallel.shard_rows(ppl_noise)}


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


def d_step(g, d, d_opt, real, draws, cfg, dtype=None) -> dict:
    """D GAN step (reference D_Loss_BackProp): logistic loss on a fresh fake
    batch and the real batch, then one Adam step of D."""
    with torch.no_grad():
        fake = _fake(g, draws, dtype=dtype)
    fake_pred = d(fake, dtype, cfg.remat)
    real_pred = d(real, dtype, cfg.remat)
    loss = d_logistic_loss(real_pred.float(), fake_pred.float())
    d_opt.zero_grad(set_to_none=True)
    loss.backward()
    parallel.all_reduce_grads(d.parameters())
    d_opt.step()
    return {"d": loss.detach(), "real_score": real_pred.detach().mean(),
            "fake_score": fake_pred.detach().mean()}


def d_reg_step(d, d_opt, real, cfg, dtype=None) -> dict:
    """D R1 step (reference D_Reg_BackProp): grad of grad through D, the
    image's gradient in the real batch's type."""
    r1 = r1_penalty(d, real, dtype, cfg.remat)
    d_opt.zero_grad(set_to_none=True)
    (cfg.discriminator_r1 / 2 * r1 * cfg.d_reg_freq).backward()
    parallel.all_reduce_grads(d.parameters())
    d_opt.step()
    return {"r1": r1.detach()}


def g_step(g, g_opt, d, draws, cfg, teacher=None, lpips=None, parser=None,
           dtype=None) -> dict:
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
                            return_rgb_list=need_lists, dtype=dtype)
        teacher_list = list(t_out) if need_lists else [t_out]
    g_out = _fake(g, draws, return_rgb_list=need_lists, dtype=dtype, remat=cfg.remat)
    fake_list = list(g_out) if need_lists else [g_out]
    fake_img = fake_list[-1]
    g_loss = g_nonsaturating_loss(d(fake_img, dtype, cfg.remat).float())
    metrics = {"g": g_loss.detach()}
    total = g_loss
    if teacher_list is not None:
        kd_l1, kd_lpips = kd_loss(
            _f32_up(fake_img), [_f32_up(f) for f in fake_list],
            [_f32_up(t) for t in teacher_list], kd_l1_lambda=cfg.kd_l1_lambda,
            kd_lpips_lambda=cfg.kd_lpips_lambda, kd_mode=cfg.kd_mode,
            size=cfg.generated_img_size, lpips=lpips,
            parse_fn=None if parser is None else make_parse_fn(parser, "NHWC", dtype),
            lpips_image_size=LPIPS_IMAGE_SIZE, data_format="NHWC", aux_dtype=dtype)
        metrics["kd_l1_loss"] = kd_l1.detach()
        metrics["kd_lpips_loss"] = kd_lpips.detach()
        total = g_loss + kd_l1 + kd_lpips
    g_opt.zero_grad(set_to_none=True)
    total.backward(inputs=list(g.parameters()))
    parallel.all_reduce_grads(g.parameters())
    g_opt.step()
    return metrics


def g_reg_step(g, g_opt, draws, mean_path_length, cfg, dtype=None):
    """G path-length step (reference G_Reg_BackProp): the path lengths'
    spread around their running mean, decayed by 0.01. The batch mean inside
    the loss is the global batch's (``parallel.global_mean``), differentiated
    as the JAX package differentiates it. Returns (the new running mean,
    metrics)."""
    _, path_lengths = g(draws["z"], inject_index=draws["inject_index"], noise=draws["noise"],
                        PPL_regularize=True, ppl_noise=draws["ppl_noise"], dtype=dtype,
                        remat=cfg.remat)
    path_mean = mean_path_length + 0.01 * (parallel.global_mean(path_lengths)
                                           - mean_path_length)
    path_loss = torch.mean(torch.square(path_lengths - path_mean))
    g_opt.zero_grad(set_to_none=True)
    (cfg.generator_path_reg_weight * cfg.g_reg_freq * path_loss).backward(
        inputs=list(g.parameters()))
    parallel.all_reduce_grads(g.parameters())
    g_opt.step()
    return path_mean.detach(), {"path": path_loss.detach(),
                                "path_length": path_lengths.detach().mean()}
