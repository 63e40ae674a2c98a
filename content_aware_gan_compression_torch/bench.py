"""Benchmark of distillation retraining, on one card or data parallel over
cards, the counterpart of the JAX package's ``bench.py``:

    python -m content_aware_gan_compression_torch.bench
    torchrun --nproc_per_node=N -m content_aware_gan_compression_torch.bench

It times the reference's iteration (D GAN step and G GAN + KD step every
iteration, R1 every 16, path length every 4, EMA every iteration) on the
11x student (``int(c * remove_ratio)`` channels removed from every layer)
with the full-width teacher and D, at ``--size``, in ``--dtype`` (bfloat16
by default, as ``bench.py``). The default objective is the reference's:
content-aware KD masked by BiSeNet's parse of the teacher's images, plus the
LPIPS-VGG16 term; ``--no-full_objective`` leaves both out. Every weight is
drawn from a seed (the same FLOPs as trained weights). ``--metric
generate`` times the student's forward instead.

Under torchrun (``parallel.process_group``, NCCL on the cards) each process
is one rank on its card, as the JAX bench's mesh over every local device:
``--batch_size`` is the global batch, each rank's real rows are
``parallel.shard_rows`` of the one seeded global batch, the draws split as
in the ``Trainer`` (``train/steps.py:draw_*``), and the weights, built from
the same seeds on every rank, are checked equal (``broadcast_module``).
Without torchrun it is one process.

Rank 0 prints ONE JSON line with ``bench.py``'s keys, and every other rank
prints nothing on stdout:
  {"metric": "retrain_iters_per_sec", "value": N, "unit": "iter/s",
   "vs_baseline": ..., "mfu": ..., "objective": "full_kd" or "gan_l1",
   "remat": true or false, "peak_memory_gb": ...}
Under torchrun it adds ``world_size``; without it the line is as above.

Timing: the host clock over ``--iters`` iterations after ``--warmup``; each
end of the window is fenced on every rank (a barrier, then
``torch.cuda.synchronize()``), so the rate is the slowest rank's, as a JAX
fence waits for every device. ``vs_baseline`` is the rate over the
reference's 2x V100 (450k iterations in 131 h), scaled by the global batch
/ 16. ``mfu`` counts the model's MACs per iteration of the global batch
(``bench.py``'s formula, from ``utils/calculators.py``) against the summed
dense peak of the world's cards for the compute type, so world size 1 gives
the one card's figure; the JAX ``_report`` divides by one chip's peak
whatever the mesh, which on a mesh is no utilization. With ``--remat`` it
still counts the model's MACs, not the checkpointed blocks' replays, as
``bench.py`` does. ``peak_memory_gb`` is ``torch.cuda.max_memory_allocated``
over the run, the largest over the ranks (null on the CPU). No target is
stated. PyTorch's defaults hold: cuDNN may use TF32 for float32
convolutions, float32 matmuls do not. ``--remat`` checkpoints the
student's synthesis blocks and D's res-blocks (``TrainConfig.remat``), as
the JAX flag does; on the H100 it lowers no peak, which R1's grad of grad
sets (PERF.md).

``--per_iter_fetch`` fetches the G loss to the host every iteration, as the
JAX flag does, and writes the iterations' ms to stderr (rank 0): the window
then pays one fence per iteration.

``--trace_dir``: after the timed window, one more whole cadence of R1 (16
iterations: R1 once, path length 4 times) runs under ``torch.profiler``
with ``record_shapes=True``, and its Chrome trace goes to ``--trace_dir``,
one file per rank (``bench_trace_rank<r>.json``). The window and the trace
are separate because the profiler slows the window it records. The line
then adds ``executed_tflop_per_iter``, the world's executed TFLOPs per
iteration counted from the traces' op shapes
(``tools/trace_op_time.py``: every convolution, forward, backward and
double backward, and every matrix product, checkpointed replays included),
and ``hw_flop_util``: those FLOPs x it/s over the world's summed peak, as
``bench.py`` reports them.

``--metric generate`` times each rank's share of the global batch and
reports images/s summed over the ranks (under the JAX metric's name).

Left out, as TPU-only: ``--packed*`` (the space-to-depth trunk) and
``--steps_per_dispatch`` (the K-step ``lax.scan``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch
import torch.distributed as dist

from . import parallel

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
    p.add_argument("--per_iter_fetch", action="store_true", default=False,
                   help="fetch the G loss every iteration and write each iteration's ms to "
                        "stderr (the window then pays a fence per iteration)")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="after the window, trace one more cadence of 16 iterations with "
                        "torch.profiler into this folder (one Chrome trace per rank) and add "
                        "executed_tflop_per_iter and hw_flop_util to the line")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fence(device):
    """Every rank's work done: a barrier over the ranks (a process group's
    collective waits for every rank's queue), then this card's."""
    if parallel.active():
        dist.barrier()
    _sync(device)


def _over_ranks(value, op, device):
    """``value`` reduced over the ranks (a float64 tensor on the rank's
    device, as NCCL wants); ``value`` itself in one process."""
    if not parallel.active():
        return value
    t = torch.tensor(value, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op)
    return t.item()


def student_shape(size, remove_ratio, keep_multiple=1):
    """The student's net_shape: ``get_uniform_remove_list`` of the full
    generator's."""
    from .models import default_net_shape
    from .pruning import get_uniform_remove_list

    full = default_net_shape(size)
    return tuple(c - r for c, r in zip(full, get_uniform_remove_list(
        full, remove_ratio, keep_multiple=keep_multiple)))


def bench_generate(args, g, dtype, device):
    """images/s of the student's forward at the global ``--batch_size``,
    each rank on its share, summed over the ranks: the line of
    ``bench.py``'s generate metric."""
    gen = torch.Generator(device).manual_seed(1)
    z = parallel.shard_rows(torch.randn(args.batch_size, g.config.style_dim, generator=gen,
                                        device=device))
    with torch.inference_mode():
        g([z], generator=gen, dtype=dtype)
        _fence(device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            g([z], generator=gen, dtype=dtype)
        _fence(device)
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


def trace_cadence(args, one_iter, start, cadence, device):
    """``cadence`` more iterations from ``start`` under ``torch.profiler``
    (``record_shapes``), written to ``--trace_dir`` as this rank's Chrome
    trace; returns the world's executed FLOPs per iteration, counted from
    every rank's trace."""
    from torch.profiler import ProfilerActivity, profile

    from .tools.trace_op_time import executed_flops, load_events

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _fence(device)
    with profile(activities=activities, record_shapes=True) as prof:
        for i in range(cadence):
            one_iter(start + i)
        _sync(device)
    os.makedirs(args.trace_dir, exist_ok=True)
    path = os.path.join(args.trace_dir, f"bench_trace_rank{parallel.rank()}.json")
    prof.export_chrome_trace(path)
    flops = executed_flops(load_events(path, log=lambda *a: print(*a, file=sys.stderr)))
    return _over_ranks(flops, dist.ReduceOp.SUM, device) / cadence


def main(argv=None):
    """Prints the line on rank 0; returns it on every rank."""
    args = parse_args(argv)
    with parallel.process_group(args.device) as device:
        line = run(args, device)
    return line


def run(args, device):
    from .models import (
        BiSeNet, Discriminator, DiscriminatorConfig, Generator, GeneratorConfig, LPIPS)
    from .train import TrainConfig
    from .train.steps import (
        d_reg_step, d_step, draw_d, draw_g, draw_g_reg, ema_accumulate, g_reg_step, g_step,
        make_optimizers, prepare_real, torch_dtype)

    world = parallel.world_size()
    cfg = TrainConfig(generated_img_size=args.size, batch_size=args.batch_size,
                      compute_dtype=args.dtype, opt_state_dtype=args.opt_state_dtype,
                      content_aware_KD=args.full_objective,
                      kd_lpips_lambda=3.0 if args.full_objective else 0.0, remat=args.remat)
    path_batch = max(1, args.batch_size // cfg.path_reg_batch_shrink)
    if args.batch_size % world or (args.metric == "retrain" and path_batch % world):
        raise ValueError(f"batch {args.batch_size} (path batch {path_batch}) does not split "
                         f"over {world} ranks")
    dtype = torch_dtype(args.dtype)
    seeded = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    g = Generator(GeneratorConfig(
        size=args.size, net_shape=student_shape(args.size, args.remove_ratio,
                                                args.keep_multiple)),
        device=device, generator=seeded(0))
    parallel.broadcast_module(g)
    if args.metric == "generate":
        line = bench_generate(args, g.eval(), dtype, device)
        if parallel.active():
            line["world_size"] = world
        parallel.main_print(json.dumps(line))
        return line
    teacher = Generator(GeneratorConfig(size=args.size), device=device,
                        generator=seeded(1)).requires_grad_(False)
    d = Discriminator(DiscriminatorConfig(size=args.size), device=device, generator=seeded(2))
    g_ema = Generator(g.config, device=device).requires_grad_(False)
    g_ema.load_state_dict(g.state_dict())
    lpips = parser = None
    if args.full_objective:
        lpips = LPIPS(device=device, generator=seeded(5)).requires_grad_(False).eval()
        parser = BiSeNet(device=device, generator=seeded(3)).requires_grad_(False).eval()
    for net in (teacher, d, g_ema, lpips, parser):
        if net is not None:
            parallel.broadcast_module(net)
    g_opt, d_opt = make_optimizers(g, d, cfg)
    gen = torch.Generator(device).manual_seed(0)
    real = prepare_real(parallel.shard_rows(torch.randint(
        0, 256, (args.batch_size, args.size, args.size, 3), generator=seeded(9),
        dtype=torch.uint8)), device)
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
    per_iter = []
    _fence(device)
    t0 = time.perf_counter()
    for i in range(args.iters):
        t1 = time.perf_counter()
        m = one_iter(args.warmup + i)
        if args.per_iter_fetch:
            m["g"].item()
            per_iter.append(time.perf_counter() - t1)
    _fence(device)
    iters_per_sec = args.iters / (time.perf_counter() - t0)
    if per_iter and parallel.is_main():
        print("per-iter ms:", [round(t * 1000, 3) for t in per_iter], file=sys.stderr)
    if not torch.isfinite(m["g"]).item():
        raise RuntimeError(f"the G loss is not finite: {m}")
    exec_flops = None
    if args.trace_dir:
        exec_flops = trace_cadence(args, one_iter, args.warmup + args.iters,
                                   math.lcm(cfg.d_reg_freq, cfg.g_reg_freq), device)

    if args.dtype == "bfloat16":
        peak = PEAK_TFLOPS["bfloat16"]
    else:
        peak = PEAK_TFLOPS["tf32" if torch.backends.cudnn.allow_tf32 else "float32"]
    world_peak = world * peak * 1e12
    mfu = iteration_macs(args, cfg, g, teacher) * 2 * iters_per_sec / world_peak
    ref_rate = REFERENCE_ITERS_PER_SEC_1024 if args.size == 1024 else REFERENCE_ITERS_PER_SEC
    peak_gb = None
    if device.type == "cuda":
        peak_gb = round(_over_ranks(torch.cuda.max_memory_allocated(device) / 1e9,
                                    dist.ReduceOp.MAX, device), 3)
    line = {
        "metric": ("retrain_iters_per_sec" if args.size == 256
                   else f"retrain_iters_per_sec_{args.size}px"),
        "value": round(iters_per_sec, 4), "unit": "iter/s",
        "vs_baseline": round(iters_per_sec * args.batch_size / (ref_rate * 16), 4),
        "mfu": round(mfu, 4),
        "objective": "full_kd" if args.full_objective else "gan_l1",
        "remat": args.remat,
        "peak_memory_gb": peak_gb}
    if parallel.active():
        line["world_size"] = world
    if exec_flops is not None:
        line["executed_tflop_per_iter"] = exec_flops / 1e12
        line["hw_flop_util"] = exec_flops * iters_per_sec / world_peak
    parallel.main_print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
