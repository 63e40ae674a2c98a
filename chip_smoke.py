#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card (nvidia-smi) and build the CUDA kernels from csrc/;
  2. hold each kernel against its plain PyTorch version on the card, at every
     shape the 256px generator gives it and at ragged shapes;
  3. drive the generate path (mean latent, truncation 0.5, batch 16) of the
     full-width 256px generator, weights drawn from seed 0, and check that it
     launched blur4 6 times and the fused epilogue 13 times; then hold a
     batch of 2 on the card against the same module on the CPU;
  4. run ``python -m content_aware_gan_compression_torch.generate`` on a
     seeded .npz checkpoint and check the PNG grid;
  5. time each kernel at its largest generator shape against its bound, its
     plain version and (blur4) one PyTorch library call, and the generator's
     images/s.
The last lines are a {"kernels": [...]} JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}. Needs a CUDA card; without one it
exits non-zero and prints no result.
"""

import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BATCH = 16
SIZE = 256


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def detail(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median milliseconds of ``fn`` on the card, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def profile_forward(fn, iters=3, top=10):
    """Where a forward's device time goes: torch.profiler over ``iters``
    calls; each kernel's share of the summed kernel time, the blur4 and
    epilogue kernels' shares, and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(t for _, t in kernels)
    if total == 0:
        return "not measured: the profiler recorded no device time"
    kernels.sort(key=lambda kt: -kt[1])
    share = lambda word: sum(t for k, t in kernels if word in k) / total  # noqa: E731
    return {"kernel_ms_per_forward": total / iters / 1e3,
            "busy_share": total / window_us,
            "blur4_share": share("blur4"), "epilogue_share": share("fnbl_"),
            "top": [[k[:80], round(t / total, 4)] for k, t in kernels[:top]]}


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def in_bounds_taps(n_in, n_out, p0):
    """Taps of a 4-tap axis that land inside the input, summed over outputs."""
    return sum(1 for o in range(n_out) for d in range(4) if 0 <= o + d - p0 < n_in)


def generator_layer_shapes():
    """(blur4 input shapes, fused-epilogue shapes) of the 256px generator."""
    from content_aware_gan_compression_torch.models import GeneratorConfig

    ns = GeneratorConfig(size=SIZE).net_shape
    blur = [(BATCH, 2 ** r + 1, 2 ** r + 1, ns[2 * (r - 2)]) for r in range(3, 9)]
    fused = [(BATCH, 4, 4, ns[1])] + [
        (BATCH, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), ns[i + 1]) for i in range(1, 13)]
    return blur, fused


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from content_aware_gan_compression_torch.generate import sample_images
    from content_aware_gan_compression_torch.models import Generator, GeneratorConfig, stylegan2
    from content_aware_gan_compression_torch.ops import make_kernel
    from content_aware_gan_compression_torch.ops.cuda import (
        blur4, blur4_plain, build, correlation_taps, fused_noise_bias_lrelu,
        fused_noise_bias_lrelu_plain)
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
    blur_cases = [(s, (1, 1), 4.0) for s in blur_shapes] + [
        ((3, 13, 9, 3), (2, 1), 1.0), ((2, 17, 11, 12), (2, 2), 4.0),
        ((2, 10, 15, 130), (1, 1), 1.0), ((1, 7, 7, 130), (2, 1), 4.0),
        ((2, 9, 8, 12), (1, 1), 4.0), ((3, 11, 13, 3), (2, 2), 1.0)]
    blur_err = 0.0
    for shape, pad, gain in blur_cases:
        x = torch.randn(shape, generator=rng, device=dev)
        got = blur4(x, k4, pad, gain)
        want = blur4_plain(x, correlation_taps(k4, gain), pad)
        torch.cuda.synchronize()
        err, tol = (got - want).abs().max().item(), 1e-5 * x.abs().max().item()
        if got.shape != want.shape or not err <= tol:
            fail(f"blur4 {shape} pad {pad} gain {gain}: max_abs_err {err} > tol {tol}")
        blur_err = max(blur_err, err)
    detail("blur4_vs_plain", cases=len(blur_cases), max_abs_err=blur_err,
           tolerance="1e-5 * max|x| per case")

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
        blur4.launches = fused_noise_bias_lrelu.launches = 0
        mean_latent = g.mean_latent(4096, gen)
        images = sample_images(g, BATCH, 0.5, mean_latent, gen)
        torch.cuda.synchronize()
        launches = {"blur4": blur4.launches,
                    "fused_noise_bias_lrelu": fused_noise_bias_lrelu.launches}
    stylegan2._to_nhwc = to_nhwc
    detail("generate_path", images=list(images.shape), launches=launches,
           layout_copies=layout_copies, finite=bool(torch.isfinite(images).all()),
           std=images.float().std().item())
    if launches != {"blur4": 6, "fused_noise_bias_lrelu": 13}:
        fail(f"main path launches {launches}, want blur4 6 and fused_noise_bias_lrelu 13")
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

    # -- 5. times on the card ---------------------------------------------------
    b_shape = blur_shapes[-1]
    x = torch.randn(b_shape, generator=rng, device=dev)
    taps = correlation_taps(k4, 4.0)
    ho, wo = b_shape[1] - 1, b_shape[2] - 1
    n_out = b_shape[0] * ho * wo * b_shape[3]
    blur_flops = 2 * b_shape[0] * b_shape[3] * in_bounds_taps(b_shape[1], ho, 1) \
        * in_bounds_taps(b_shape[2], wo, 1)
    blur_bound, blur_by = bound(4 * (x.numel() + n_out), blur_flops)
    w_dw = (k4 * 4.0).flip(0, 1).reshape(1, 1, 4, 4).repeat(b_shape[3], 1, 1, 1).to(dev)
    x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, as the port holds it
    blur_ms = time_ms(lambda: blur4(x, k4, (1, 1), 4.0))
    blur_plain_ms = time_ms(lambda: blur4_plain(x, taps, (1, 1)), iters=5)
    blur_lib_ms = time_ms(lambda: torch.nn.functional.conv2d(
        x_nchw, w_dw, padding=1, groups=b_shape[3]))
    del x, x_nchw

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
            lambda: g([z], truncation=0.5, truncation_latent=mean_latent, noise=noise))
    torch.backends.cudnn.allow_tf32 = False
    detail("generator_rate", size=SIZE, batch=BATCH, dtype="float32", **rates,
           note="pytorch_defaults: cuDNN TF32 on, matmul TF32 off")

    kernels = [
        {"name": "blur4", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/blur4.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/upfirdn2d_pallas.py:66",
         "launches": launches["blur4"], "max_abs_err": blur_err, "ms": blur_ms,
         "plain_ms": blur_plain_ms, "bound_ms": blur_bound, "bound_by": blur_by,
         "library_ms": blur_lib_ms, "shape": list(b_shape)},
        {"name": "fused_noise_bias_lrelu", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/fused_noise_bias_lrelu.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/fused_act_pallas.py:50",
         "launches": launches["fused_noise_bias_lrelu"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound,
         "bound_by": fused_by, "library_ms": None, "shape": list(f_shape)},
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
