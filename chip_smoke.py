#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card (nvidia-smi) and build the CUDA kernels from csrc/;
  2. hold each kernel against its plain PyTorch version on the card, at every
     shape the 256px generator gives it and at ragged shapes (blur4 also at
     every up-blur of the 11x student at batch 16 and path batch 8, and on a
     view that is not 16-byte aligned); the same for masked_scale (the
     epilogue's backward) at every epilogue shape of the 11x student at
     batch 16 and path batch 8;
  3. drive the generate path (mean latent, truncation 0.5, batch 16) of the
     full-width 256px generator, weights drawn from seed 0, and check that it
     launched blur4 6 times, all with float4 lanes, and the fused epilogue
     13 times; then hold a batch of 2 on the card against the same module on
     the CPU;
  4. run ``python -m content_aware_gan_compression_torch.generate`` on a
     seeded .npz checkpoint and check the PNG grid;
  5. hold the first and second derivatives through each autograd Function on
     the card (blur4 at the student's up-blurs at batch 16 and 8, the
     discriminator's shapes and pads and a misaligned view, the epilogue at
     the student's shapes) against the same function built from the plain
     versions;
  6. drive the retraining path: the port's Trainer with the 11x student, the
     full-width teacher and D at 256px, batch 16, iterations 0-4 (R1 at 0,
     path length at 0 and 4), and check every loss is finite and each phase
     launched each kernel, forward and backward, as often as the shapes
     require (train_phase_launches);
  7. one iteration at 64px, batch 4, TF32 off, on the card and on the CPU,
     each against the CPU in float64: losses and parameter gradients of
     each phase;
  8. run ``python -m content_aware_gan_compression_torch.train`` for 2
     iterations at 256px on a seeded uint8 cache, then resume it;
  9. time the kernels against their bounds, their plain versions and one
     PyTorch library call each (blur4 at the generator's, the
     discriminator's and the student's largest shapes), the generator's
     images/s, and the training iterations/s over one cadence window of 16
     iterations, with its peak memory and where its device time goes.
The last lines are a {"kernels": [...]} JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}. Needs a CUDA card; without one it
exits non-zero and prints no result.
"""

import contextlib
import json
import os
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 16
SIZE = 256
PATH_BATCH = 8
# the 11x student: int(c * 0.7) channels removed from every layer of the
# 256px generator's default net_shape (the JAX package's pruning rule)
STUDENT_SHAPE = (154,) * 10 + (77, 77, 39, 39)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def detail(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def profile_forward(fn, iters=3, top=10, inference=True):
    """Where a window's device time goes: torch.profiler over ``iters``
    calls of ``fn(i)``; each kernel's share of the summed kernel time, the
    hand-written kernels' shares, and the device's busy share of the window
    (host clock). ``fn`` is called once before the window."""
    from torch.profiler import ProfilerActivity, profile

    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode:
        fn(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(t for _, t in kernels)
    if total == 0:
        return "not measured: the profiler recorded no device time"
    kernels.sort(key=lambda kt: -kt[1])
    share = lambda word: sum(t for k, t in kernels if word in k) / total  # noqa: E731
    return {"kernel_ms_per_call": total / iters / 1e3,
            "busy_share": total / window_us,
            "blur4_share": share("blur4"), "epilogue_share": share("fnbl_"),
            "masked_scale_share": share("masked_scale"),
            "top": [[k[:80], round(t / total, 4)] for k, t in kernels[:top]]}


def generator_layer_shapes():
    """(blur4 input shapes, fused-epilogue shapes) of the 256px generator."""
    from content_aware_gan_compression_torch.models import GeneratorConfig

    ns = GeneratorConfig(size=SIZE).net_shape
    blur = [(BATCH, 2 ** r + 1, 2 ** r + 1, ns[2 * (r - 2)])
            for r in range(3, int(np.log2(SIZE)) + 1)]
    fused = [(BATCH, 4, 4, ns[1])] + [
        (BATCH, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), ns[i + 1]) for i in range(1, len(ns) - 1)]
    return blur, fused


def train_phase_launches(log_size):
    """Kernel launches of each training phase at a resolution of 2**log_size.
    k = log_size - 2 is both the generator's number of up-blurs and the
    discriminator's number of ResBlocks (two blurs each); e = 2*log_size - 3
    is the generator's number of epilogues. PERF.md derives each entry."""
    k, e = log_size - 2, 2 * log_size - 3
    zero = {"blur4": 0, "blur4_backward": 0, "blur4_vector": 0, "fused_noise_bias_lrelu": 0,
            "masked_scale": 0}
    # blur4_vector: the launches with float4 lanes, forward and backward. The
    # teacher's and D's widths are multiples of 4; the 11x student's (154,
    # 77, 39) are not, so its blurs take scalar lanes.
    return {
        # student forward without grad; D forward on fake and on real, and back
        "d": {**zero, "blur4": k + 4 * k, "blur4_backward": 4 * k, "blur4_vector": 8 * k,
              "fused_noise_bias_lrelu": e},
        # D forward on real; R1's backward; its backward, which also runs
        # back through the forward (the minibatch stddev is not linear)
        "d_reg": {**zero, "blur4": 2 * k, "blur4_backward": 6 * k, "blur4_vector": 8 * k},
        # teacher and student forward, D forward; back through D and student
        "g": {"blur4": 4 * k, "blur4_backward": 3 * k, "blur4_vector": k + 2 * k + 2 * k,
              "fused_noise_bias_lrelu": 2 * e, "masked_scale": e},
        # student forward; the path-length grad; its backward, and back
        # through the forward
        "g_reg": {**zero, "blur4": k, "blur4_backward": 3 * k, "fused_noise_bias_lrelu": e,
                  "masked_scale": 3 * e},
        "ema": zero,
    }


def to_device(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_device(v, dev) for v in obj]
    return obj


def student_epilogue_shapes(batch, net_shape=STUDENT_SHAPE):
    return [(batch, 4, 4, net_shape[1])] + [
        (batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), net_shape[i + 1])
        for i in range(1, len(net_shape) - 1)]


def student_blur_shapes(batch, net_shape=STUDENT_SHAPE):
    """blur4 input shapes of the student's up-blurs (C = 154, ..., 77, 39)."""
    return [(batch, 2 ** r + 1, 2 ** r + 1, net_shape[2 * (r - 2)])
            for r in range(3, int(np.log2(SIZE)) + 1)]


def misaligned(x):
    """``x`` as a contiguous view 4 bytes into its storage, so not 16-byte
    aligned; differentiable."""
    return torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)


def discriminator_blur_cases():
    """(input shape, pad) of every blur of the 256px D: each ResBlock blurs
    its input with pad (1,1) for the skip and its conv1 output with (2,2)."""
    from content_aware_gan_compression_torch.models import DiscriminatorConfig

    ch = DiscriminatorConfig(size=SIZE).channels()
    return [((BATCH, SIZE >> i, SIZE >> i, ch[SIZE >> i]), pad)
            for i in range(int(np.log2(SIZE)) - 2) for pad in ((2, 2), (1, 1))]


def write_train_checkpoints(work, size):
    """Seeded student.npz {'g', 'g_ema'} (the int(c*0.7) rule) and
    teacher.npz {'g_ema'} (full width) at ``size``."""
    from content_aware_gan_compression_torch.models import (
        Generator, GeneratorConfig, default_net_shape)
    from content_aware_gan_compression_torch.utils import save_checkpoint

    student_shape = tuple(c - int(c * 0.7) for c in default_net_shape(size))
    student = Generator(GeneratorConfig(size=size, net_shape=student_shape), device="cpu",
                        generator=torch.Generator().manual_seed(0)).state_dict()
    teacher = Generator(GeneratorConfig(size=size), device="cpu",
                        generator=torch.Generator().manual_seed(1)).state_dict()
    paths = (os.path.join(work, f"student{size}.npz"), os.path.join(work, f"teacher{size}.npz"))
    save_checkpoint(paths[0], {"g": student, "g_ema": student},
                    metadata={"size": size, "seed": 0})
    save_checkpoint(paths[1], {"g_ema": teacher}, metadata={"size": size, "seed": 1})
    return paths


def train_config(size, batch, student, teacher, **kw):
    """The retraining configuration: TrainConfig defaults with the KD terms
    the CLI keeps when no BiSeNet and VGG weights are present (KD-L1)."""
    from content_aware_gan_compression_torch.train import TrainConfig

    return TrainConfig(generated_img_size=size, batch_size=batch, ckpt=student,
                       teacher=teacher, content_aware_KD=False, kd_lpips_lambda=0.0, **kw)


def phase_counter(store):
    """A Trainer phase hook: the launch counts of each phase, then reset."""
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts

    def hook(name):
        store.append((name, counts()))
        reset_counts()
    return hook


def max_rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from content_aware_gan_compression_torch.bench_blur4 import blur4_bound, bound, time_ms
    from content_aware_gan_compression_torch.generate import sample_images
    from content_aware_gan_compression_torch.models import Generator, GeneratorConfig, stylegan2
    from content_aware_gan_compression_torch.ops import make_kernel
    from content_aware_gan_compression_torch.ops.cuda import (
        blur4, blur4_plain, build, correlation_taps, counts, fused_noise_bias_lrelu,
        fused_noise_bias_lrelu_plain, masked_scale, masked_scale_plain, reset_counts)
    from content_aware_gan_compression_torch.train import Trainer
    from content_aware_gan_compression_torch.utils import save_checkpoint

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 1. build -------------------------------------------------------------
    t0 = time.time()
    build.build()
    detail("build", seconds=round(time.time() - t0, 3),
           ptxas=[ln.strip() for name in build.SOURCES for ln in build.build_log(name).splitlines()
                  if "registers" in ln or "spill" in ln])

    # -- 2. kernels against their plain versions on the card ------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = torch.Generator(dev).manual_seed(0)
    k4 = make_kernel([1, 3, 3, 1])
    blur_shapes, fused_shapes = generator_layer_shapes()
    # (shape, pad, gain, misaligned view)
    blur_cases = [(s, (1, 1), 4.0, False) for s in blur_shapes + student_blur_shapes(BATCH)
                  + student_blur_shapes(PATH_BATCH)] + [
        ((3, 13, 9, 3), (2, 1), 1.0, False), ((2, 17, 11, 12), (2, 2), 4.0, False),
        ((2, 10, 15, 130), (1, 1), 1.0, False), ((1, 7, 7, 130), (2, 1), 4.0, False),
        ((2, 9, 8, 12), (1, 1), 4.0, False), ((3, 11, 13, 3), (2, 2), 1.0, False),
        ((BATCH, 65, 65, 512), (1, 1), 4.0, True), ((BATCH, 129, 129, 39), (2, 2), 1.0, True)]
    blur_err = 0.0
    reset_counts()
    for shape, pad, gain, offset in blur_cases:
        x = torch.randn(shape, generator=rng, device=dev)
        if offset:
            x = misaligned(x)
        got = blur4(x, k4, pad, gain)
        want = blur4_plain(x, correlation_taps(k4, gain), pad)
        torch.cuda.synchronize()
        err, tol = (got - want).abs().max().item(), 1e-5 * x.abs().max().item()
        if got.shape != want.shape or not err <= tol:
            fail(f"blur4 {shape} pad {pad} gain {gain}: max_abs_err {err} > tol {tol}")
        blur_err = max(blur_err, err)
    want_vector = sum(s[3] % 4 == 0 and not offset for s, _, _, offset in blur_cases)
    blur_counts = counts()
    detail("blur4_vs_plain", cases=len(blur_cases), max_abs_err=blur_err,
           launches=blur_counts["blur4"], vector_launches=blur_counts["blur4_vector"],
           tolerance="1e-5 * max|x| per case")
    if blur_counts["blur4"] != len(blur_cases) or blur_counts["blur4_vector"] != want_vector:
        fail(f"blur4 launched {blur_counts}, want {len(blur_cases)} with {want_vector} "
             "of them float4")

    fused_cases = [(s, s[0]) for s in fused_shapes] + [
        ((2, 5, 7, 3), 2), ((2, 6, 6, 130), 1), ((16, 8, 8, 512), 1)]
    fused_err = 0.0
    for shape, noise_batch in fused_cases:
        x = torch.randn(shape, generator=rng, device=dev)
        noise = torch.randn((noise_batch, *shape[1:3], 1), generator=rng, device=dev)
        bias = 0.5 * torch.randn(shape[3], generator=rng, device=dev)
        nw = torch.tensor([0.7], device=dev)
        got = fused_noise_bias_lrelu(x, noise, bias, nw)
        want = fused_noise_bias_lrelu_plain(x, noise, bias, nw)
        torch.cuda.synchronize()
        err, tol = (got - want).abs().max().item(), 1e-6 * want.abs().max().item()
        if not err <= tol:
            fail(f"fused_noise_bias_lrelu {shape}: max_abs_err {err} > tol {tol}")
        fused_err = max(fused_err, err)
    detail("fused_vs_plain", cases=len(fused_cases), max_abs_err=fused_err,
           tolerance="1e-6 * max|plain| per case")

    ms_cases = student_epilogue_shapes(BATCH) + student_epilogue_shapes(PATH_BATCH) + [
        (2, 5, 7, 3), (3, 9, 9, 39), (2, 6, 6, 130)]
    ms_err = 0.0
    for shape in ms_cases:
        g_in = torch.randn(shape, generator=rng, device=dev)
        out = torch.randn(shape, generator=rng, device=dev)
        out.view(-1)[:3] = 0.0  # the mask is 1 at exactly 0, as in JAX
        got, want = masked_scale(g_in, out), masked_scale_plain(g_in, out)
        torch.cuda.synchronize()
        err, tol = (got - want).abs().max().item(), 1e-6 * want.abs().max().item()
        if not err <= tol:
            fail(f"masked_scale {shape}: max_abs_err {err} > tol {tol}")
        ms_err = max(ms_err, err)
    detail("masked_scale_vs_plain", cases=len(ms_cases), max_abs_err=ms_err,
           tolerance="1e-6 * max|plain| per case")

    # -- 3. the generate path at full width ---------------------------------
    cfg = GeneratorConfig(size=SIZE)
    g = Generator(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    wrng = torch.Generator().manual_seed(1)
    with torch.no_grad():  # zero at init: make the epilogue's noise and bias terms count
        for m in g.modules():
            if isinstance(m, stylegan2.StyledConv):
                m.noise.weight.copy_(torch.randn(1, generator=wrng))
                m.activate.bias.copy_(0.2 * torch.randn(m.activate.bias.shape, generator=wrng))
    g.eval()
    layout_copies = 0
    to_nhwc = stylegan2._to_nhwc

    def counting_to_nhwc(x):
        nonlocal layout_copies
        layout_copies += not x.permute(0, 2, 3, 1).is_contiguous()
        return to_nhwc(x)

    stylegan2._to_nhwc = counting_to_nhwc
    gen = torch.Generator(dev).manual_seed(0)
    with torch.inference_mode():
        reset_counts()
        mean_latent = g.mean_latent(4096, gen)
        images = sample_images(g, BATCH, 0.5, mean_latent, gen)
        torch.cuda.synchronize()
        launches = {"blur4": blur4.launches,
                    "fused_noise_bias_lrelu": fused_noise_bias_lrelu.launches}
        generate_vector = blur4.vector_launches
    stylegan2._to_nhwc = to_nhwc
    detail("generate_path", images=list(images.shape), launches=launches,
           blur4_vector_launches=generate_vector, layout_copies=layout_copies,
           finite=bool(torch.isfinite(images).all()), std=images.float().std().item())
    if launches != {"blur4": 6, "fused_noise_bias_lrelu": 13} or generate_vector != 6:
        fail(f"main path launches {launches}, {generate_vector} of blur4's float4; want "
             "blur4 6, all float4, and fused_noise_bias_lrelu 13")
    if tuple(images.shape) != (BATCH, 3, SIZE, SIZE) or not torch.isfinite(images).all():
        fail(f"generated images {tuple(images.shape)} not finite or wrong shape")

    g_cpu = Generator(cfg, device="cpu")
    g_cpu.load_state_dict(g.state_dict())
    g_cpu.eval()
    crng = torch.Generator().manual_seed(2)
    z = torch.randn(2, cfg.style_dim, generator=crng)
    noise = g_cpu.make_noise(2, crng)
    with torch.inference_mode():
        on_card = g([z.to(dev)], truncation=0.5, truncation_latent=mean_latent,
                    noise=[n.to(dev) for n in noise]).cpu()
        on_cpu = g_cpu([z], truncation=0.5, truncation_latent=mean_latent.cpu(), noise=noise)
    cuda_vs_cpu = (on_card - on_cpu).abs().max().item()
    detail("cuda_vs_cpu", batch=2, max_abs_err=cuda_vs_cpu, tolerance=1e-3,
           max_abs_value=on_cpu.abs().max().item(), tf32=False)
    if not cuda_vs_cpu <= 1e-3:
        fail(f"256px generator on the card vs the CPU: max_abs_err {cuda_vs_cpu} > 1e-3")
    del g_cpu, on_card, on_cpu

    # -- 4. the generate CLI ----------------------------------------------------
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt = os.path.join(work, "g256_seed0.npz")
    save_checkpoint(ckpt, {"g_ema": g.state_dict()}, metadata={"size": SIZE, "seed": 0})
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "content_aware_gan_compression_torch.generate",
                           "--ckpt", ckpt, "--out_dir", os.path.join(work, "sample")],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.time() - t0
    png = os.path.join(work, "sample", "000000.png")
    if proc.returncode != 0 or not os.path.exists(png):
        fail(f"generate CLI rc {proc.returncode}: {proc.stderr[-3000:]}")
    with open(png, "rb") as f:
        head = f.read(24)
    width, height = struct.unpack(">II", head[16:24])
    want_side = 2 + 4 * (SIZE + 2)
    detail("generate_cli", seconds=round(cli_s, 3), png=[width, height])
    if head[:8] != b"\x89PNG\r\n\x1a\n" or (width, height) != (want_side, want_side):
        fail(f"grid PNG {width}x{height}, want {want_side}x{want_side}")
    shutil.rmtree(work)

    # -- 5. backward and double backward against the plain versions -----------
    def twin(fn_kernel, fn_plain, args):
        """d sum(f^3) and d ||d sum(f^3)||^2 in every input that needs a
        gradient, through the Function on the card and through the plain
        version under autograd; the largest error relative to the plain
        version's largest value."""
        worst = 0.0
        results = []
        for fn in (fn_kernel, fn_plain):
            xs = [a.detach().clone().requires_grad_(a.requires_grad) for a in args]
            wrt = [x for x in xs if x.requires_grad]
            grads = torch.autograd.grad(fn(*xs).pow(3).sum(), wrt, create_graph=True)
            second = torch.autograd.grad(sum(t.pow(2).sum() for t in grads), wrt)
            results.append([t.detach() for t in (*grads, *second)])
        for a, b in zip(*results):
            worst = max(worst, max_rel_err(a, b))
        return worst

    k_asym = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120  # flip != itself
    # (shape, pad, gain, misaligned view): the view goes in inside the
    # function, since twin() copies its inputs into fresh (aligned) tensors
    bw_cases = [(shape, (1, 1), 4.0, False)
                for shape in student_blur_shapes(BATCH) + student_blur_shapes(PATH_BATCH)] + [
        (shape, pad, 1.0, False) for shape, pad in discriminator_blur_cases()] + [
        ((BATCH, 33, 33, 512), (1, 1), 4.0, True), ((PATH_BATCH, 129, 129, 77), (2, 2), 1.0, True)]
    reset_counts()
    bw_blur_err = 0.0
    for shape, pad, gain, offset in bw_cases:
        x = torch.randn(shape, generator=rng, device=dev, requires_grad=True)
        view = misaligned if offset else (lambda t: t)
        err = twin(lambda x: blur4(view(x), k_asym, pad, gain),
                   lambda x: blur4_plain(view(x), correlation_taps(k_asym, gain), pad), [x])
        if not err <= 1e-5:
            fail(f"blur4 backward {shape} pad {pad}: relative error {err} > 1e-5")
        bw_blur_err = max(bw_blur_err, err)
    bw_fused_err = 0.0
    for shape in student_epilogue_shapes(BATCH):
        args = [torch.randn(shape, generator=rng, device=dev, requires_grad=True),
                torch.randn((shape[0], *shape[1:3], 1), generator=rng, device=dev),
                0.5 * torch.randn(shape[3], generator=rng, device=dev),
                torch.tensor([0.7], device=dev)]
        args[2].requires_grad_(True)
        args[3].requires_grad_(True)
        err = twin(fused_noise_bias_lrelu, fused_noise_bias_lrelu_plain, args)
        if not err <= 1e-5:
            fail(f"epilogue backward {shape}: relative error {err} > 1e-5")
        bw_fused_err = max(bw_fused_err, err)
    torch.cuda.synchronize()
    bw_counts = counts()
    detail("backward_vs_plain", blur4_cases=len(bw_cases), blur4_max_rel_err=bw_blur_err,
           epilogue_cases=len(STUDENT_SHAPE) - 1, epilogue_max_rel_err=bw_fused_err,
           launches=bw_counts,
           tolerance="1e-5 of the plain version's largest value, first and second order")
    if (bw_counts["blur4_backward"] < 2 * len(bw_cases)
            or bw_counts["masked_scale"] < 2 * (len(STUDENT_SHAPE) - 1)):
        fail(f"backward phase did not go through the kernels: {bw_counts}")

    # -- 6. the retraining path at 256px: 11x student, full teacher and D -----
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    student, teacher = write_train_checkpoints(work, SIZE)
    cfg256 = train_config(SIZE, BATCH, student, teacher)
    trainer = Trainer(cfg256, device=dev)
    if trainer.g.config.net_shape != STUDENT_SHAPE:
        fail(f"student net_shape {trainer.g.config.net_shape}")
    reals = np.random.RandomState(0).randint(0, 256, (4, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    want_phase = train_phase_launches(int(np.log2(SIZE)))
    torch.backends.cudnn.allow_tf32 = False
    mpl = torch.zeros((), device=dev)
    phases, train_metrics, iter_s = [], [], []
    reset_counts()
    for it in range(5):
        t0 = time.time()
        m, mpl = trainer.step(it, reals[it % 4], mpl, phase_hook=phase_counter(phases))
        torch.cuda.synchronize()
        iter_s.append(round(time.time() - t0, 3))
        train_metrics.append({k: v.item() for k, v in m.items()})
    train_launches = {}
    for name, c in phases:
        want = {k: v for k, v in want_phase[name].items()}
        got = {k: c[k] for k in want}
        if got != want:
            fail(f"train phase {name} launched {got}, want {want}")
        for k, v in c.items():
            train_launches[k] = train_launches.get(k, 0) + v
    finite = all(np.isfinite(v) for m in train_metrics for v in m.values())
    detail("train_path", size=SIZE, batch=BATCH, path_batch=PATH_BATCH,
           student=list(STUDENT_SHAPE), phases=[n for n, _ in phases],
           launches=train_launches, per_phase_want={k: want_phase[k] for k in want_phase},
           iteration_seconds=iter_s, metrics=train_metrics, finite=finite, tf32=False)
    if not finite:
        fail("a training loss is not finite")
    for need in ("d_reg", "g", "g_reg"):
        if not any(n == need for n, _ in phases):
            fail(f"phase {need} did not run")

    # -- 7. one iteration at 64px on the card against the CPU ------------------
    # The path-length and R1 gradients are grads of grads, and fp32 rounds
    # them by up to 1% on either device. So the card and the CPU, both in
    # fp32, are each held against the same iteration in float64 on the CPU:
    # per phase, the card may be no further from it than twice the CPU's
    # own fp32 distance, plus 1e-4.
    s_small, t_small = write_train_checkpoints(work, 64)
    # lr 0: Adam's first step is about lr * sign(g), so a weight whose
    # gradient is near 0 would move apart on the two devices and every later
    # phase would start from other weights; with lr 0 each phase compares
    # the same computation on the same weights
    cfg64 = train_config(64, 4, s_small, t_small, init_lr=0.0)
    runs = {"cpu": Trainer(cfg64, device="cpu"), "card": Trainer(cfg64, device=dev),
            "f64": Trainer(cfg64, device="cpu")}
    for module in (runs["f64"].g, runs["f64"].d, runs["f64"].teacher):
        module.double()
    draws = runs["cpu"].draw(0)
    real64 = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (4, 64, 64, 3), dtype=np.uint8)).float() / 127.5 - 1.0
    trained = {"d": "d", "d_reg": "d", "g": "g", "g_reg": "g"}
    results = {}
    for key, tr in runs.items():
        dtype = torch.float64 if key == "f64" else torch.float32
        store = results[key] = {}

        def hook(name, store=store, tr=tr):
            if name in trained:
                store[name] = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                               .detach().cpu().double()
                               for n, p in getattr(tr, trained[name]).named_parameters()}
        cast = to_device(draws, tr.device)
        if key == "f64":
            cast = {ph: {k: ([t.double() for t in v] if isinstance(v, list)
                             else v.double() if v.is_floating_point() else v)
                         for k, v in d.items()} for ph, d in cast.items()}
        metrics, _ = tr.step(0, real64.to(tr.device, dtype), torch.zeros((), device=tr.device,
                                                                          dtype=dtype),
                             draws=cast, phase_hook=hook)
        store["losses"] = {k: v.item() for k, v in metrics.items()}

    def distance(key):
        losses = max(abs(v - results["f64"]["losses"][k]) / max(abs(results["f64"]["losses"][k]),
                                                                1e-6)
                     for k, v in results[key]["losses"].items())
        grads = {ph: max(max_rel_err(results[key][ph][n], g)
                         for n, g in results["f64"][ph].items()) for ph in trained}
        return {"losses": losses, **grads}

    cpu_err, card_err = distance("cpu"), distance("card")
    detail("train_cuda_vs_cpu", size=64, batch=4, tf32=False, lr=0.0,
           card_vs_float64=card_err, cpu_vs_float64=cpu_err,
           measure="largest |a-b| / max|float64| over each phase's parameter tensors",
           tolerance="card <= 2 * cpu + 1e-4, per phase and for the losses")
    bad = {k: (card_err[k], cpu_err[k]) for k in card_err
           if not card_err[k] <= 2 * cpu_err[k] + 1e-4}
    if bad:
        fail(f"training on the card vs float64 on the CPU: {bad}")
    del runs, results

    # -- 8. the train CLI: two iterations, then a resume -----------------------
    cache = os.path.join(work, "ffhq256_seeded.npy")
    np.save(cache, np.random.RandomState(2).randint(0, 256, (32, SIZE, SIZE, 3), dtype=np.uint8))
    base = [sys.executable, "-m", "content_aware_gan_compression_torch.train", "--path", cache,
            "--size", str(SIZE), "--teacher_ckpt", teacher, "--batch_size", str(BATCH),
            "--n_sample", "4", "--val_sample_freq", "1", "--model_save_freq", "1"]
    cli = {}
    for label, extra in (("train", ["--ckpt", student, "--iter", "2"]),
                         ("resume", ["--load_train_state", "True", "--iter", "3"])):
        root = os.path.join(work, f"cli_{label}")
        if label == "resume":
            extra = ["--ckpt", os.path.join(cli["train"]["exp"], "ckpt", "000001.npz"), *extra]
        t0 = time.time()
        proc = subprocess.run([*base, *extra, "--exp_root", root], cwd=REPO,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"train CLI ({label}) rc {proc.returncode}: {proc.stderr[-3000:]}")
        (exp,) = [os.path.join(root, d) for d in os.listdir(root) if d.startswith("Exp_")]
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        cli[label] = {"exp": exp, "seconds": round(time.time() - t0, 3),
                      "iters": [r["iter"] for r in recs],
                      "finite": all(np.isfinite(v) for r in recs for v in r.values()),
                      "samples": sorted(os.listdir(os.path.join(exp, "sample"))),
                      "ckpts": sorted(os.listdir(os.path.join(exp, "ckpt")))}
    detail("train_cli", **{k: {kk: vv for kk, vv in v.items() if kk != "exp"}
                            for k, v in cli.items()})
    if (cli["train"]["iters"] != [0, 1] or cli["resume"]["iters"] != [2]
            or not cli["train"]["finite"] or not cli["resume"]["finite"]
            or "000001.npz" not in cli["train"]["ckpts"]
            or "000001.png" not in cli["train"]["samples"]
            or "000002.npz" not in cli["resume"]["ckpts"]):
        fail(f"train CLI: {cli}")
    with open(os.path.join(cli["train"]["exp"], "sample", "000001.png"), "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or struct.unpack(">II", head[16:24]) != (
            2 + 2 * (SIZE + 2),) * 2:
        fail("train CLI sample grid is not the expected PNG")
    shutil.rmtree(work)

    # -- 9. times on the card ---------------------------------------------------
    # blur4 at the generator's largest up-blur (whose backward runs at D's
    # shape and pad below), D's largest conv blur (the other way round) and
    # the student's largest up-blur (scalar lanes)
    blur_times = []
    for shape, pad, gain, role in [
            (blur_shapes[-1], (1, 1), 4.0, "G up-blur forward; D skip blur backward"),
            ((BATCH, SIZE, SIZE, 128), (2, 2), 1.0, "D conv blur forward; G up-blur backward"),
            (student_blur_shapes(BATCH)[-1], (1, 1), 4.0, "11x student's largest up-blur")]:
        x = torch.randn(shape, generator=rng, device=dev)
        taps = correlation_taps(k4, gain)
        c = shape[3]
        t_bound, t_by = blur4_bound(shape, pad)
        w_dw = (k4 * gain).flip(0, 1).reshape(1, 1, 4, 4).repeat(c, 1, 1, 1).to(dev)
        x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, as the port holds it
        reset_counts()
        blur4(x, k4, pad, gain)
        blur_times.append({
            "shape": list(shape), "pad": list(pad), "role": role,
            "lanes": 4 if counts()["blur4_vector"] else 1,
            "ms": time_ms(lambda: blur4(x, k4, pad, gain)),
            "plain_ms": time_ms(lambda: blur4_plain(x, taps, pad), iters=5),
            "bound_ms": t_bound, "bound_by": t_by,
            "library_ms": time_ms(lambda: torch.nn.functional.conv2d(
                x_nchw, w_dw, padding=pad[0], groups=c))})
        blur_times[-1]["bound_share"] = t_bound / blur_times[-1]["ms"]
        del x, x_nchw
    detail("blur4_times", shapes=blur_times, card=card,
           library="F.conv2d depthwise (groups=C) on the channels-last view")

    f_shape = fused_shapes[-1]
    x = torch.randn(f_shape, generator=rng, device=dev)
    noise = torch.randn((*f_shape[:3], 1), generator=rng, device=dev)
    bias = 0.5 * torch.randn(f_shape[3], generator=rng, device=dev)
    nw = torch.tensor([0.7], device=dev)
    out = fused_noise_bias_lrelu_plain(x, noise, bias, nw)
    negatives = int((out < 0).sum().item())
    # per element: two adds and the sqrt(2) multiply, plus the 0.2 multiply
    # where the pre-activation is negative; one multiply per noise value
    fused_flops = 3 * x.numel() + negatives + noise.numel()
    fused_bound, fused_by = bound(4 * (2 * x.numel() + noise.numel() + f_shape[3]), fused_flops)
    fused_ms = time_ms(lambda: fused_noise_bias_lrelu(x, noise, bias, nw))
    fused_plain_ms = time_ms(lambda: fused_noise_bias_lrelu_plain(x, noise, bias, nw), iters=5)
    del x, noise, out

    rates = {}
    z = torch.randn(BATCH, cfg.style_dim, generator=rng, device=dev)
    noise = g.make_noise(BATCH, rng)
    for label, tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            ms = time_ms(lambda: g([z], truncation=0.5, truncation_latent=mean_latent,
                                   noise=noise), iters=10, warmup=2)
        rates[label] = {"ms_per_batch": ms, "images_per_s": BATCH * 1e3 / ms}
        rates[label]["device_time"] = profile_forward(
            lambda i: g([z], truncation=0.5, truncation_latent=mean_latent, noise=noise))
    torch.backends.cudnn.allow_tf32 = False
    detail("generator_rate", size=SIZE, batch=BATCH, dtype="float32", **rates,
           note="pytorch_defaults: cuDNN TF32 on, matmul TF32 off")

    # masked_scale at its largest training shape: the student's last conv
    m_shape = (BATCH, SIZE, SIZE, STUDENT_SHAPE[-1])
    g_in = torch.randn(m_shape, generator=rng, device=dev)
    out = torch.randn(m_shape, generator=rng, device=dev)
    negatives = int((out < 0).sum().item())
    # per element a compare and the sqrt(2) multiply, and the 0.2 multiply
    # where out < 0
    ms_bound, ms_by = bound(12 * out.numel(), 2 * out.numel() + negatives)
    ms_ms = time_ms(lambda: masked_scale(g_in, out))
    ms_plain_ms = time_ms(lambda: masked_scale_plain(g_in, out), iters=5)
    # one ATen pass over the same bytes, without the sqrt(2) (and a > 0 mask)
    ms_lib_ms = time_ms(lambda: torch.ops.aten.leaky_relu_backward(g_in, out, 0.2, True))
    del g_in, out

    # -- training rate over one cadence window: iterations 16-31 --------------
    train_rate = {}
    window = range(16, 32)  # R1 at 16, path length at 16, 20, 24, 28
    for label, tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        for it in (1, 2):  # warm-up, no regularizer
            trainer.step(it, reals[it % 4], mpl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for it in window:
            _, mpl = trainer.step(it, reals[it % 4], mpl)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        train_rate[label] = {"iterations_per_s": len(window) / seconds,
                             "ms_per_iteration": seconds * 1e3 / len(window),
                             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        state = {"mpl": mpl}

        def one(i, state=state):
            _, state["mpl"] = trainer.step(window[i % len(window)], reals[i % 4], state["mpl"])
        train_rate[label]["device_time"] = profile_forward(one, iters=len(window),
                                                           inference=False)
        mpl = state["mpl"]
    torch.backends.cudnn.allow_tf32 = False
    detail("train_rate", size=SIZE, batch=BATCH, path_batch=PATH_BATCH, dtype="float32",
           window="iterations 16-31: 16 D and G steps, 1 R1, 4 path length", **train_rate,
           note="pytorch_defaults: cuDNN TF32 on, matmul TF32 off")
    del trainer

    kernels = [
        {"name": "blur4", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/blur4.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/upfirdn2d_pallas.py:66",
         "launches": train_launches["blur4"] + train_launches["blur4_backward"],
         "launches_forward": train_launches["blur4"],
         "launches_backward": train_launches["blur4_backward"],
         "vector_launches": train_launches["blur4_vector"],
         "launches_generate": launches["blur4"], "vector_launches_generate": generate_vector,
         "max_abs_err": blur_err, "max_rel_err_backward": bw_blur_err,
         **{k: blur_times[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "shape")},
         "shapes": blur_times},
        {"name": "fused_noise_bias_lrelu", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/fused_noise_bias_lrelu.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/fused_act_pallas.py:50",
         "launches": train_launches["fused_noise_bias_lrelu"],
         "launches_generate": launches["fused_noise_bias_lrelu"], "max_abs_err": fused_err,
         "max_rel_err_backward": bw_fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound,
         "bound_by": fused_by, "library_ms": None, "shape": list(f_shape)},
        {"name": "masked_scale", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/masked_scale.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/fused_act_pallas.py:73",
         "launches": train_launches["masked_scale"], "max_abs_err": ms_err, "ms": ms_ms,
         "plain_ms": ms_plain_ms, "bound_ms": ms_bound, "bound_by": ms_by,
         "library_ms": ms_lib_ms, "library": "aten.leaky_relu_backward (no sqrt(2), mask > 0)",
         "shape": list(m_shape)},
    ]
    detail("done", seconds=round(time.time() - t_start, 1))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
