"""Per-phase training-time profiler (the JAX package's root
train_time_profiler.py, itself the reference's
Miscellaneous/train_time_profiler.py):

    python -m content_aware_gan_compression_torch.train_time_profiler

Times each phase of the distillation loop (``data``, ``d_step``,
``d_reg_step``, ``g_step``, ``g_reg_step``, ``ema``) over ``--iters``
iterations, R1 every ``d_reg_freq`` and path length every ``g_reg_freq``
iterations as training runs them. Each phase is timed on the host clock
between two ``torch.cuda.synchronize`` fences, so its time is the device's
too. The student (``--remove_ratio`` of every layer's channels removed, the
11x student at 0.7), the full-width teacher and D are drawn from seeds, and
the real batch is a seeded uint8 one on the device, so ``data`` times only
its fence, as in the JAX script; no dataset is needed. The objective is
GAN + KD-L1 without the aux nets, as the JAX script's.

``compile_s`` holds each phase's first call, outside the timed iterations.
JAX compiles there; PyTorch runs eagerly, and its first call pays the
warm-up instead: cuDNN's choice of algorithms, the CUDA kernels' builds and
the allocator's first requests.

``--trace_dir`` writes a ``torch.profiler`` Chrome trace of the timed
iterations there. ``--dtype`` is bfloat16 by default, as in the JAX script.
``--remat`` checkpoints the student's synthesis blocks and D's res-blocks
(``TrainConfig.remat``), as the JAX script's flag does. Prints one
JSON object: ``compile_s``, then each phase's ``mean_ms`` and ``calls``,
then ``amortized_iter_ms``. Runs on ``cuda`` unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--remove_ratio", type=float, default=0.7)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true", default=False,
                   help="checkpoint synthesis/D blocks (1024px memory)")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace here")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Prints and returns the report."""
    args = parse_args(argv)
    import torch

    from .bench import student_shape
    from .models import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig
    from .train import TrainConfig
    from .train.steps import (
        d_reg_step, d_step, draw_d, draw_g, draw_g_reg, ema_accumulate, g_reg_step, g_step,
        make_optimizers, prepare_real, torch_dtype)
    from .utils.runtime import resolve_device

    device = resolve_device(args.device)
    cfg = TrainConfig(generated_img_size=args.size, batch_size=args.batch_size,
                      compute_dtype=args.dtype, content_aware_KD=False, kd_lpips_lambda=0.0,
                      remat=args.remat)
    dtype = torch_dtype(args.dtype)
    seeded = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    g = Generator(GeneratorConfig(size=args.size,
                                  net_shape=student_shape(args.size, args.remove_ratio)),
                  device=device, generator=seeded(0))
    teacher = Generator(GeneratorConfig(size=args.size), device=device,
                        generator=seeded(1)).requires_grad_(False)
    d = Discriminator(DiscriminatorConfig(size=args.size), device=device, generator=seeded(2))
    g_ema = Generator(g.config, device=device).requires_grad_(False)
    g_ema.load_state_dict(g.state_dict())
    g_opt, d_opt = make_optimizers(g, d, cfg)
    gen = torch.Generator(device).manual_seed(0)
    real = prepare_real(torch.randint(0, 256, (args.batch_size, args.size, args.size, 3),
                                      generator=seeded(7), dtype=torch.uint8), device)
    state = {"mpl": torch.zeros((), device=device)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    phases = {
        "data": lambda: None,
        "d_step": lambda: d_step(g, d, d_opt, real, draw_d(gen, g, cfg), cfg, dtype),
        "d_reg_step": lambda: d_reg_step(d, d_opt, real, cfg, dtype),
        "g_step": lambda: g_step(g, g_opt, d, draw_g(gen, g, cfg, teacher), cfg, teacher,
                                 None, None, dtype),
        "g_reg_step": lambda: state.update(mpl=g_reg_step(
            g, g_opt, draw_g_reg(gen, g, cfg), state["mpl"], cfg, dtype)[0]),
        "ema": lambda: ema_accumulate(g_ema, g),
    }

    def timed(name):
        sync()
        t0 = time.perf_counter()
        phases[name]()
        sync()
        return time.perf_counter() - t0

    compile_s = {name: timed(name) for name in phases if name != "data"}

    times = {name: [] for name in phases}
    trace = None
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        trace = profile(activities=activities)
        trace.__enter__()
    try:
        for i in range(args.iters):
            due = {"d_reg_step": i % cfg.d_reg_freq == 0, "g_reg_step": i % cfg.g_reg_freq == 0}
            for name in phases:
                if due.get(name, True):
                    times[name].append(timed(name))
    finally:
        if trace is not None:
            trace.__exit__(None, None, None)
    if trace is not None:
        os.makedirs(args.trace_dir, exist_ok=True)
        trace.export_chrome_trace(os.path.join(args.trace_dir, "train_time_profile.json"))

    report = {"compile_s": {k: round(v, 2) for k, v in compile_s.items()}}
    for name, ts in times.items():
        if ts:
            report[name] = {"mean_ms": round(1000 * sum(ts) / len(ts), 2), "calls": len(ts)}
    report["amortized_iter_ms"] = round(
        1000 * sum(sum(ts) for ts in times.values()) / args.iters, 2)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
