"""Benchmark of distillation retraining on one card, the counterpart of the
JAX package's ``bench.py``:

    python -m content_aware_gan_compression_torch.bench

It times the reference's iteration (D GAN step and G GAN + KD step every
iteration, R1 every 16, path length every 4, EMA every iteration) on the
11x student (``int(c * remove_ratio)`` channels removed from every layer)
with the full-width teacher and D, at ``--size``, in ``--dtype`` (bfloat16
by default, as ``bench.py``). The default objective is the reference's:
content-aware KD masked by BiSeNet's parse of the teacher's images, plus the
LPIPS-VGG16 term; ``--no-full_objective`` leaves both out. Every weight is
drawn from a seed (the same FLOPs as trained weights). ``--metric
generate`` times the student's forward instead.

Prints ONE JSON line with ``bench.py``'s keys:
  {"metric": "retrain_iters_per_sec", "value": N, "unit": "iter/s",
   "vs_baseline": ..., "mfu": ..., "objective": "full_kd" or "gan_l1",
   "remat": true or false, "peak_memory_gb": ...}

Timing: the host clock over ``--iters`` iterations after ``--warmup``, each
end of the window after ``torch.cuda.synchronize()``. ``vs_baseline`` is the
rate over the reference's 2x V100 (450k iterations in 131 h), scaled by
batch / 16. ``mfu`` counts the model's MACs per iteration (``bench.py``'s
formula, from ``utils/calculators.py``) against the card's dense peak for
the compute type: with ``--remat`` it still counts the model's MACs, not the
checkpointed blocks' replays, as ``bench.py`` does. ``peak_memory_gb`` is
``torch.cuda.max_memory_allocated`` over the run (null on the CPU). No
target is stated. PyTorch's defaults hold: cuDNN may use TF32 for float32
convolutions, float32 matmuls do not. ``--remat`` checkpoints the
student's synthesis blocks and D's res-blocks (``TrainConfig.remat``), as
the JAX flag does; on the H100 it lowers no peak, which R1's grad of grad
sets (PERF.md). The JAX bench's TPU-only flags (``--packed*``,
``--trace_dir``, ``--per_iter_fetch``, ``--steps_per_dispatch``) have no
counterpart.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

REFERENCE_ITERS_PER_SEC = 450000 / (131 * 3600)  # 2x V100, reference README.md:110-115
REFERENCE_ITERS_PER_SEC_1024 = 450000 / (251 * 3600)  # 4x V100, the same table
# The card's dense peak (no sparsity) in TFLOP/s by compute type: NVIDIA H100
# SXM5 datasheet, bf16 tensor cores 989.4; float32 convolutions run on the
# TF32 tensor cores (494.7) when cuDNN may use TF32, else on the float32
# units (66.9).
PEAK_TFLOPS = {"bfloat16": 989.4, "tf32": 494.7, "float32": 66.9}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=64)
    p.add_argument("--warmup", type=int, default=33)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--opt_state_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="Adam second-moment storage dtype (bf16 halves its bytes; "
                        "off-reference numerics)")
    p.add_argument("--remove_ratio", type=float, default=0.7)
    p.add_argument("--keep_multiple", type=int, default=1,
                   help="round kept student widths UP to this multiple")
    p.add_argument("--remat", action="store_true", default=False,
                   help="checkpoint synthesis blocks (1024px memory)")
    p.add_argument("--full_objective", action=argparse.BooleanOptionalAction, default=True,
                   help="the reference's default objective: content-aware KD (BiSeNet "
                        "parse of the teacher batch) + LPIPS-KD every G step; "
                        "--no-full_objective = GAN + unmasked L1 only")
    p.add_argument("--metric", type=str, default="retrain", choices=["retrain", "generate"],
                   help="retrain iters/s (default) or generation images/s/chip for the "
                        "pruned student")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def student_shape(size, remove_ratio, keep_multiple=1):
    """The student's net_shape: ``get_uniform_remove_list`` of the full
    generator's."""
    from .models import default_net_shape
    from .pruning import get_uniform_remove_list

    full = default_net_shape(size)
    return tuple(c - r for c, r in zip(full, get_uniform_remove_list(
        full, remove_ratio, keep_multiple=keep_multiple)))


def bench_generate(args, g, dtype, device):
    """images/s of the student's forward at ``--batch_size``, the line of
    ``bench.py``'s generate metric."""
    gen = torch.Generator(device).manual_seed(1)
    z = torch.randn(args.batch_size, g.config.style_dim, generator=gen, device=device)
    with torch.inference_mode():
        g([z], generator=gen, dtype=dtype)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            g([z], generator=gen, dtype=dtype)
        _sync(device)
    ips = args.batch_size * args.iters / (time.perf_counter() - t0)
    return {"metric": f"generate_{args.size}px_images_per_sec_per_chip",
            "value": round(ips, 1), "unit": "img/s", "vs_baseline": None}


def iteration_macs(args, cfg, g, teacher):
    """Model MACs of one iteration, ``bench.py``'s count: per-image MACs of
    the student, the teacher, D and the aux nets, with 1x forward and 3x
    forward + backward multipliers."""
    from .utils.calculators import (
        bisenet_flops, discriminator_flops, stylegan2_flops, vgg16_lpips_flops)

    g_macs, t_macs = stylegan2_flops(g), stylegan2_flops(teacher)
    d_macs = discriminator_flops(args.size)
    b = args.batch_size
    macs = (b * (g_macs + 2 * 3 * d_macs)  # d phase: student forward, D fwd+bwd twice
            + b * (3 * g_macs + 2 * d_macs + t_macs)  # g phase
            + b * (2 * 3 * d_macs) / cfg.d_reg_freq  # R1: grad of grad
            + (b // cfg.path_reg_batch_shrink) * (2 * 3 * g_macs) / cfg.g_reg_freq)
    if args.full_objective:
        # LPIPS at 256px on both images (the student's with its input
        # gradient), the parse of the teacher's images at 512px
        macs += b * (3 * vgg16_lpips_flops(256) + bisenet_flops(512))
    return macs


def main(argv=None):
    args = parse_args(argv)
    from .models import (
        BiSeNet, Discriminator, DiscriminatorConfig, Generator, GeneratorConfig, LPIPS)
    from .train import TrainConfig
    from .train.steps import (
        d_reg_step, d_step, draw_d, draw_g, draw_g_reg, ema_accumulate, g_reg_step, g_step,
        make_optimizers, prepare_real, torch_dtype)
    from .utils.runtime import resolve_device

    device = resolve_device(args.device)
    cfg = TrainConfig(generated_img_size=args.size, batch_size=args.batch_size,
                      compute_dtype=args.dtype, opt_state_dtype=args.opt_state_dtype,
                      content_aware_KD=args.full_objective,
                      kd_lpips_lambda=3.0 if args.full_objective else 0.0, remat=args.remat)
    dtype = torch_dtype(args.dtype)
    seeded = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    g = Generator(GeneratorConfig(
        size=args.size, net_shape=student_shape(args.size, args.remove_ratio,
                                                args.keep_multiple)),
        device=device, generator=seeded(0))
    if args.metric == "generate":
        print(json.dumps(bench_generate(args, g.eval(), dtype, device)))
        return
    teacher = Generator(GeneratorConfig(size=args.size), device=device,
                        generator=seeded(1)).requires_grad_(False)
    d = Discriminator(DiscriminatorConfig(size=args.size), device=device, generator=seeded(2))
    g_ema = Generator(g.config, device=device).requires_grad_(False)
    g_ema.load_state_dict(g.state_dict())
    lpips = parser = None
    if args.full_objective:
        lpips = LPIPS(device=device, generator=seeded(5)).requires_grad_(False).eval()
        parser = BiSeNet(device=device, generator=seeded(3)).requires_grad_(False).eval()
    g_opt, d_opt = make_optimizers(g, d, cfg)
    gen = torch.Generator(device).manual_seed(0)
    real = prepare_real(torch.randint(0, 256, (args.batch_size, args.size, args.size, 3),
                                      generator=seeded(9), dtype=torch.uint8), device)
    state = {"mpl": torch.zeros((), device=device)}

    def one_iter(i):
        """Trainer.step's phases in the reference's order."""
        d_step(g, d, d_opt, real, draw_d(gen, g, cfg), cfg, dtype)
        if i % cfg.d_reg_freq == 0:
            d_reg_step(d, d_opt, real, cfg, dtype)
        m = g_step(g, g_opt, d, draw_g(gen, g, cfg, teacher), cfg, teacher, lpips, parser,
                   dtype)
        if i % cfg.g_reg_freq == 0:
            state["mpl"], _ = g_reg_step(g, g_opt, draw_g_reg(gen, g, cfg), state["mpl"], cfg,
                                         dtype)
        ema_accumulate(g_ema, g)
        return m

    for i in range(args.warmup):
        one_iter(i)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(args.iters):
        m = one_iter(args.warmup + i)
    _sync(device)
    iters_per_sec = args.iters / (time.perf_counter() - t0)
    if not torch.isfinite(m["g"]).item():
        raise RuntimeError(f"the G loss is not finite: {m}")

    if args.dtype == "bfloat16":
        peak = PEAK_TFLOPS["bfloat16"]
    else:
        peak = PEAK_TFLOPS["tf32" if torch.backends.cudnn.allow_tf32 else "float32"]
    mfu = iteration_macs(args, cfg, g, teacher) * 2 * iters_per_sec / (peak * 1e12)
    ref_rate = REFERENCE_ITERS_PER_SEC_1024 if args.size == 1024 else REFERENCE_ITERS_PER_SEC
    print(json.dumps({
        "metric": ("retrain_iters_per_sec" if args.size == 256
                   else f"retrain_iters_per_sec_{args.size}px"),
        "value": round(iters_per_sec, 4), "unit": "iter/s",
        "vs_baseline": round(iters_per_sec * args.batch_size / (ref_rate * 16), 4),
        "mfu": round(mfu, 4),
        "objective": "full_kd" if args.full_objective else "gan_l1",
        "remat": args.remat,
        "peak_memory_gb": (round(torch.cuda.max_memory_allocated(device) / 1e9, 3)
                           if device.type == "cuda" else None)}))


if __name__ == "__main__":
    main()
