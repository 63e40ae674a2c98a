"""One iteration of content-aware distillation retraining (Liu et al.,
CVPR 2021, arXiv:2104.02244: lychenyoko/content-aware-gan-compression
train.py, on rosinality's StyleGAN2 training loop), in plain PyTorch.

Per iteration: the D logistic step, R1 every ``d_reg_every``, the G step
(non-saturating loss plus the KD loss: L1 and LPIPS between the student's
and the teacher's images, both masked by the BiSeNet parse of the teacher's),
path length every ``g_reg_every``, and the EMA of the student. Adam has
b1 = 0 and the lazy regularizers' ratio (lr * r, b2 = 0.99 ** r). The
random draws come in as tensors, NHWC where they are maps, as the benchmark
draws them. A run split over ranks is followed over its whole batch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import ops
from .aux_nets import coi_mask

EMA_DECAY = 0.5 ** (32 / (10 * 1000))


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The reference's train_hyperparams.py."""
    lr: float = 0.002
    r1: float = 10.0
    path_weight: float = 2.0
    path_batch_shrink: int = 2
    d_reg_every: int = 16
    g_reg_every: int = 4
    kd_l1_lambda: float = 3.0
    kd_lpips_lambda: float = 3.0


class AdamNoMu:
    """Adam with b1 = 0: the update is -lr * g / (sqrt(nu / (1 - b2^t)) +
    eps), one step count per optimizer; a parameter without a gradient
    counts as a zero one."""

    def __init__(self, params, lr, b2, eps=1e-8):
        self.params, self.lr, self.b2, self.eps, self.t = list(params), lr, b2, eps, 0
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        self.t += 1
        bc = float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** self.t)
        for p, nu in zip(self.params, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            nu.mul_(self.b2).add_((1 - self.b2) * g * g)
            p.add_(-self.lr * g / (torch.sqrt(nu / bc) + self.eps))
            p.grad = None


def optimizers(g, d, hp: Hyper):
    rg, rd = hp.g_reg_every / (hp.g_reg_every + 1), hp.d_reg_every / (hp.d_reg_every + 1)
    return (AdamNoMu(g.parameters(), hp.lr * rg, 0.99 ** rg),
            AdamNoMu(d.parameters(), hp.lr * rd, 0.99 ** rd))


def real_images(u8_nhwc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> NCHW in [-1, 1]."""
    return (u8_nhwc.to(dtype) / 127.5 - 1.0).permute(0, 3, 1, 2)


def kd_terms(student_img, teacher_img, lpips, parser, hp: Hyper):
    """(KD L1, KD LPIPS) of the reference's ``KD_loss`` for Output_Only with
    the content-aware mask; LPIPS sees 256px images."""
    mask = coi_mask(parser, teacher_img)
    s, t = student_img * mask, teacher_img * mask
    l1 = hp.kd_l1_lambda * torch.mean(torch.abs(t - s))
    if s.shape[-1] > 256:
        s, t = ops.resize(s, (256, 256)), ops.resize(t, (256, 256))
    return l1, hp.kd_lpips_lambda * torch.mean(lpips(s, t))


def iteration(i, nets, opts, real_u8, draws, mean_path, hp: Hyper, first_grads=None):
    """Iteration ``i`` over the whole batch. ``nets``: g, d, g_ema, teacher,
    lpips, parser; ``opts``: (g_opt, d_opt). ``first_grads``, a dict, takes
    each network's gradient norms the first time its optimizer steps.
    Returns (losses, the new mean path length)."""
    g, d, g_ema, teacher, lpips, parser = nets
    g_opt, d_opt = opts
    real = real_images(real_u8, next(d.parameters()).dtype)
    losses = {}

    def record(name, net, opt):
        if first_grads is not None and name not in first_grads:
            first_grads[name] = {k: 0.0 if p.grad is None else p.grad.norm().item()
                                 for k, p in net.named_parameters()}
        opt.step()

    dd = draws["d"]
    with torch.no_grad():
        fake = g(dd["z"], dd["inject_index"], dd["noise"])
    loss = F.softplus(-d(real)).mean() + F.softplus(d(fake)).mean()
    loss.backward()
    losses["d"] = loss.item()
    record("d", d, d_opt)

    if i % hp.d_reg_every == 0:
        x = real.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(d(x).sum(), x, create_graph=True)
        r1 = grad.reshape(grad.shape[0], -1).square().sum(1).mean()
        (hp.r1 / 2 * r1 * hp.d_reg_every).backward()
        losses["r1"] = r1.item()
        d_opt.step()

    dg = draws["g"]
    with torch.no_grad():
        t_img = teacher(dg["z"], dg["inject_index"], dg["teacher_noise"])
    s_img = g(dg["z"], dg["inject_index"], dg["noise"])
    g_loss = F.softplus(-d(s_img)).mean()
    l1, lp = kd_terms(s_img, t_img, lpips, parser, hp)
    (g_loss + l1 + lp).backward(inputs=list(g.parameters()))
    losses.update(g=g_loss.item(), kd_l1=l1.item(), kd_lpips=lp.item())
    record("g", g, g_opt)

    if i % hp.g_reg_every == 0:
        dr = draws["g_reg"]
        pl = g.path_lengths(dr["z"], dr["inject_index"], dr["noise"], dr["ppl_noise"])
        path_mean = mean_path + 0.01 * (pl.mean() - mean_path)
        path_loss = torch.mean((pl - path_mean) ** 2)
        (hp.path_weight * hp.g_reg_every * path_loss).backward(inputs=list(g.parameters()))
        losses["path"] = path_loss.item()
        mean_path = path_mean.detach()
        g_opt.step()

    with torch.no_grad():
        for pe, p in zip(g_ema.parameters(), g.parameters()):
            pe.mul_(EMA_DECAY).add_((1 - EMA_DECAY) * p)
    return losses, mean_path
