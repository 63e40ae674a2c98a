#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card (nvidia-smi) and build the CUDA kernels from csrc/;
  2. hold each kernel against its plain PyTorch version on the card, at every
     shape the 256px generator gives it at batch 16, at the evaluation's
     batch of 64 and at pruning's scoring batch of 10, and at ragged shapes
     (blur4 also at every up-blur of the 11x student at batch 16, path batch
     8 and batch 10, at the scoring backward's blurs of the gradient, and on
     a view that is not 16-byte aligned); the same for masked_scale (the
     epilogue's backward) at every epilogue shape of the 11x student at
     batch 16 and path batch 8 and of the full-width generator at batch 10;
  3. drive the generate path (mean latent, truncation 0.5, batch 16) of the
     full-width 256px generator, weights drawn from seed 0, and check that it
     launched blur4 6 times, all with float4 lanes, and the fused epilogue
     13 times; then hold a batch of 2 on the card against the same module on
     the CPU;
  4. run ``python -m content_aware_gan_compression_torch.generate`` on a
     seeded .npz checkpoint and check the PNG grid;
  5. hold the first and second derivatives through each autograd Function on
     the card (blur4 at the student's up-blurs at batch 16 and 8 and the
     full-width generator's at batch 10, the discriminator's shapes and pads
     and a misaligned view, the epilogue at the student's shapes) against the
     same function built from the plain versions;
  6. drive the retraining path: the port's Trainer with the 11x student, the
     full-width teacher and D at 256px, batch 16, iterations 0-4 (R1 at 0,
     path length at 0 and 4), with the KD-L1 objective and then with the
     reference's default objective (full_kd: content-aware KD, whose mask is
     a full-width seeded BiSeNet's parse of the teacher's images, plus a
     full-width seeded LPIPS-VGG16); check every loss is finite, the KD
     terms are > 0, the mask keeps a share of the teacher's pixels strictly
     inside (0, 1), and each phase launched each kernel, forward and
     backward, as often as the shapes require (train_phase_launches): the
     aux nets launch none;
  7. one iteration at 64px, batch 4, TF32 off, on the card (cuDNN's
     deterministic algorithms) and on the CPU, each against the CPU in
     float64, for both objectives (full_kd with width-scaled aux nets, every
     run given the float64 run's class map):
     losses and parameter gradients of each phase; and the share of pixels
     where the card's own parse agrees with float64's;
  8. run ``python -m content_aware_gan_compression_torch.train`` for 2
     iterations at 256px on a seeded uint8 cache with seeded aux-net files
     in the reference's schemas (torchvision VGG16, the LPIPS heads, a
     79999_iter.pth BiSeNet), then resume it;
  9. time the kernels against their bounds, their plain versions and one
     PyTorch library call each (blur4 at the generator's, the
     discriminator's and the student's largest shapes), the generator's
     images/s, the training iterations/s over one cadence window of 16
     iterations with the full objective and over its first 8 with KD-L1,
     with peak memory and where the device time goes, and LPIPS and the
     parse alone at the G step's shapes;
 10. drive the FID path at 256px (get_fid's batch of 64, 2048 samples cut
     from 50 000): the full-width generator (seed 0) and a full-width seeded
     Inception; check 6 blur4 launches (float4) and 13 epilogue launches per
     batch and none of masked_scale, finite features, the stream's FID against
     its own statistics ~0 (through the overlapped eval on the same draws;
     below 1e-4 of the next FID), against a second stream's > 0, without calc_fid's eps retry; and how far
     the features and the FID move under cuDNN's TF32 (PyTorch's default);
 11. drive PPL at 256px (32 pairs per batch, 512 pairs cut from 5000) with a
     full-width seeded LPIPS: the same launches per batch, finite distances
     >= 0;
 12. the card against the CPU, TF32 off: the first FID batch's pool3
     features, the stream's FID with that batch's features from the CPU, and
     4 PPL distances;
 13. the evaluation CLIs on seeded files (calc_inception on a uint8 cache,
     get_fid on its pickle, get_ppl on LPIPS files in the reference's
     schemas) and the train CLI with --inception_ckpt and --real_stats, whose
     overlapped in-loop FID logs a score for each model_save_freq;
 14. time the feature stream (samples/s; generator and Inception ms per
     batch), Inception alone (TFLOP/s from its convolutions' shapes) and PPL
     (pairs/s), with TF32 off and under the defaults, and peak memory of a
     feature batch at fid_batch 32 and at 64;
 15. drive content-aware pruning at 256px at prune.py's defaults (400
     samples in batches of 10, noise_prob 0.05) on the full-width generator
     with a full-width seeded BiSeNet (the first seed whose parse is mixed):
     per batch 6 blur4 launches forward and 6 backward, all float4, 13
     epilogue and 13 masked_scale (prune_launches); finite scores >= 0; the
     0.7 remove list keeps STUDENT_SHAPE; the surgery loads into Generator
     and one batch of the pruned generator runs (its blur4 lanes logged);
     the scoring's time, the generator's forward + backward and the parse
     per batch, and where a batch's device time goes, with TF32 off and
     under the defaults;
 16. the baseline metrics over 400 samples: ASV, l1-out, l1-style and Random
     (one of each family), aligned with net_shape, finite, timed;
 17. the content-aware scores of one batch at 64px on the card and on the
     CPU, each against float64 (cuDNN deterministic, TF32 off);
 18. ``python -m content_aware_gan_compression_torch.prune`` on a seeded
     .npz (content-aware with a seeded BiSeNet file, and l1-out; 40 samples),
     its .npz and .pth, then the train CLI for 2 iterations on the pruned
     checkpoint with the full-width one as the teacher.
The last lines are a {"kernels": [...]} JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}. Needs a CUDA card; without one it
exits non-zero and prints no result.
"""

import contextlib
import copy
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

START = time.time()
REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 16
SIZE = 256
PATH_BATCH = 8
# the 11x student: int(c * 0.7) channels removed from every layer of the
# 256px generator's default net_shape (the JAX package's pruning rule)
STUDENT_SHAPE = (154,) * 10 + (77, 77, 39, 39)
# evaluation: get_fid's batch; samples cut from the reference's 50 000 (FID)
# and 5000 (PPL) for time; PPL's batch of 32 pairs is 64 images
FID_BATCH = 64
FID_SAMPLES = 2048
PPL_BATCH = 32
PPL_SAMPLES = 512
INCEPTION_SEED = 0
# pruning: prune.py's defaults (400 samples in batches of 10, noise_prob
# 0.05, remove_ratio 0.7); the CLI runs on fewer samples, for time
PRUNE_SAMPLES = 400
PRUNE_BATCH = 10
PRUNE_NOISE = 0.05
PRUNE_RATIO = 0.7
PRUNE_CLI_SAMPLES = 40


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def detail(phase, **fields):
    """One JSON line per phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.time() - START, 1), **fields}), flush=True)


def profile_forward(fn, iters=3, top=12, inference=True):
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


def generator_layer_shapes(batch=BATCH):
    """(blur4 input shapes, fused-epilogue shapes) of the 256px generator."""
    from content_aware_gan_compression_torch.models import GeneratorConfig

    ns = GeneratorConfig(size=SIZE).net_shape
    blur = [(batch, 2 ** r + 1, 2 ** r + 1, ns[2 * (r - 2)])
            for r in range(3, int(np.log2(SIZE)) + 1)]
    fused = [(batch, 4, 4, ns[1])] + [
        (batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), ns[i + 1]) for i in range(1, len(ns) - 1)]
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


def prune_launches(log_size, n_batch):
    """Kernel launches of content-aware scoring at a resolution of
    2**log_size over ``n_batch`` batches: per batch one generator forward
    (k = log_size - 2 up-blurs, e = 2*log_size - 3 epilogues) and its
    backward to the conv weights (each up-blur's and each epilogue's
    backward); the parse launches none. The full-width widths are multiples
    of 4, so every blur, forward and backward, takes float4 lanes."""
    k, e = log_size - 2, 2 * log_size - 3
    return {"blur4": k * n_batch, "blur4_backward": k * n_batch, "blur4_vector": 2 * k * n_batch,
            "fused_noise_bias_lrelu": e * n_batch, "masked_scale": e * n_batch}


def randomize_epilogues(g, seed):
    """Noise weights and activation biases (zero at init) drawn from
    ``seed``, so that the epilogue's noise and bias terms count."""
    from content_aware_gan_compression_torch.models import stylegan2

    wrng = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, stylegan2.StyledConv):
                m.noise.weight.copy_(torch.randn(1, generator=wrng))
                m.activate.bias.copy_(0.2 * torch.randn(m.activate.bias.shape, generator=wrng))


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


def train_config(size, batch, student, teacher, objective, **kw):
    """The retraining configuration: TrainConfig defaults, the reference's
    objective (``full_kd``: content_aware_KD, kd_l1_lambda = kd_lpips_lambda
    = 3), or with the KD terms the CLI keeps when no BiSeNet and VGG weights
    are present (``kd_l1``)."""
    from content_aware_gan_compression_torch.train import TrainConfig

    if objective == "kd_l1":
        kw = {"content_aware_KD": False, "kd_lpips_lambda": 0.0, **kw}
    return TrainConfig(generated_img_size=size, batch_size=batch, ckpt=student,
                       teacher=teacher, **kw)


LPIPS_SEED = 5


def seeded_lpips(width_scale=1.0):
    from content_aware_gan_compression_torch.models import LPIPS, vgg16_widths

    return LPIPS(vgg16_widths(width_scale), device="cpu",
                 generator=torch.Generator().manual_seed(LPIPS_SEED))


def mask_share(parser, img_nhwc):
    """The share of ``img_nhwc``'s pixels the content-aware mask keeps, with
    ``parser``'s parse."""
    from content_aware_gan_compression_torch.models import make_parse_fn
    from content_aware_gan_compression_torch.pruning import batch_img_parsing, get_masked_tensor

    parse = batch_img_parsing(img_nhwc, make_parse_fn(parser, "NHWC"), "NHWC")
    return get_masked_tensor(torch.ones_like(img_nhwc[..., :1]), parse, "NHWC").mean().item()


def pick_parser(img_nhwc, width_scale=1.0, seeds=64):
    """A seeded BiSeNet whose mask keeps between 2% and 98% of these
    images' pixels: the first seed that does. A random parser mostly parses
    every pixel as one class, which makes the mask all or nothing."""
    from content_aware_gan_compression_torch.models import BiSeNet, bisenet_widths

    for seed in range(seeds):
        net = BiSeNet(bisenet_widths(width_scale), device="cpu",
                      generator=torch.Generator().manual_seed(seed))
        net = net.to(img_nhwc.device, img_nhwc.dtype).requires_grad_(False).eval()
        share = mask_share(net, img_nhwc)
        if 0.02 <= share <= 0.98:
            return net, seed, share
    fail(f"no BiSeNet seed in 0..{seeds - 1} parses the teacher's images into a mixed mask")


class FixedParse(torch.nn.Module):
    """Stands in for BiSeNet in a Trainer: head-0 logits one-hot in a given
    class map, so that runs in other precisions mask with the same classes."""

    def __init__(self, class_map):
        super().__init__()
        self.register_buffer("one_hot", torch.nn.functional.one_hot(class_map, 19))

    def forward(self, x, data_format="NCHW", heads=1):
        logits = self.one_hot.to(x.dtype)
        return (logits if data_format == "NHWC" else logits.permute(0, 3, 1, 2),)


def bisenet_file_state(parser):
    """``parser``'s state dict in the 79999_iter.pth schema
    (``num_batches_tracked`` in every batch norm), on the CPU."""
    sd = {k: v.cpu() for k, v in parser.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(79999)
    return sd


def write_aux_files(work, lpips, parser=None):
    """``lpips`` and ``parser`` in the files the train CLI reads:
    torchvision's VGG16 (``features.N.*``), the reference's LPIPS heads
    (``lin{k}.model.1.weight``) and, with a parser, 79999_iter.pth."""
    files = {"vgg16.pth": {f"features.{k}": v.cpu() for k, v in lpips.vgg.state_dict().items()},
             "lpips_lins.pth": {f"lin{k}.model.1.weight": lin.weight.detach().cpu()
                                for k, lin in enumerate(lpips.lins)}}
    if parser is not None:
        files["79999_iter.pth"] = bisenet_file_state(parser)
    paths = [os.path.join(work, name) for name in files]
    for path, sd in zip(paths, files.values()):
        torch.save(sd, path)
    return paths


def drive_train_path(trainer, reals, want_phase, draws0=None):
    """Iterations 0-4 with per-phase launch counts, each checked against
    ``want_phase``. Returns (summed launches, per-iteration metrics,
    per-iteration seconds, phase names)."""
    from content_aware_gan_compression_torch.ops.cuda import reset_counts

    mpl = torch.zeros((), device=trainer.device)
    phases, metrics, iter_s = [], [], []
    reset_counts()
    for it in range(5):
        t0 = time.time()
        m, mpl = trainer.step(it, reals[it % 4], mpl, draws=draws0 if it == 0 else None,
                              phase_hook=phase_counter(phases))
        torch.cuda.synchronize()
        iter_s.append(round(time.time() - t0, 3))
        metrics.append({k: v.item() for k, v in m.items()})
    launches = {}
    for name, c in phases:
        want = dict(want_phase[name])
        got = {k: c[k] for k in want}
        if got != want:
            fail(f"train phase {name} launched {got}, want {want}")
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        fail(f"a training loss is not finite: {metrics}")
    for need in ("d_reg", "g", "g_reg"):
        if not any(n == need for n, _ in phases):
            fail(f"phase {need} did not run")
    return launches, metrics, iter_s, [n for n, _ in phases]


def train_window(trainer, reals, mpl, window=range(16, 32)):
    """Iterations/s, host ms per iteration and peak memory over ``window``
    (by default 16-31: R1 at 16, path length at 16, 20, 24, 28) after two
    warm-up iterations, then the same window under the profiler. Returns
    (dict, the running mean path length)."""
    for it in (1, 2):  # warm-up, no regularizer
        trainer.step(it, reals[it % 4], mpl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for it in window:
        _, mpl = trainer.step(it, reals[it % 4], mpl)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {"iterations_per_s": len(window) / seconds,
           "ms_per_iteration": seconds * 1e3 / len(window),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    state = {"mpl": mpl}

    def one(i):
        _, state["mpl"] = trainer.step(window[i % len(window)], reals[i % 4], state["mpl"])
    out["device_time"] = profile_forward(one, iters=len(window), inference=False)
    return out, state["mpl"]


def phase_counter(store):
    """A Trainer phase hook: the launch counts of each phase, then reset."""
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts

    def hook(name):
        store.append((name, counts()))
        reset_counts()
    return hook


def max_rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)

def inception_conv_flops(inc, dev):
    """Multiply-adds of every convolution of Inception for one 299px image,
    read off the layers' shapes in a forward at batch 1, times 2."""
    from content_aware_gan_compression_torch.models.inception import BasicConv2d

    macs = []

    def hook(module, args, out):
        w = module.conv.weight
        macs.append(out.shape[1] * w.shape[1] * w.shape[2] * w.shape[3] * out.shape[2]
                    * out.shape[3])
    handles = [m.register_forward_hook(hook) for m in inc.modules() if isinstance(m, BasicConv2d)]
    with torch.inference_mode():
        inc(torch.zeros(1, 3, 299, 299, device=dev), resize_input=False)
    for h in handles:
        h.remove()
    return 2 * sum(macs), len(macs)


def fid_quietly(calc_fid, *stats):
    """calc_fid of two {'mean','cov'}; (score, whether it took the eps
    retry for a singular product)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        score = calc_fid(stats[0]["mean"], stats[0]["cov"], stats[1]["mean"], stats[1]["cov"])
    return float(score), any("singular" in str(w.message) for w in caught)


def eval_phases(g, dev, card, work):
    """FID and PPL at 256px on the full-width generator ``g``: the feature
    stream's and PPL's launches per batch, the card against the CPU, the
    three evaluation CLIs and the train CLI's in-loop FID, and the rates.
    Returns the kernels line's launch counts of the evaluation path."""
    from content_aware_gan_compression_torch import calc_inception, get_fid, get_ppl
    from content_aware_gan_compression_torch.bench_blur4 import time_ms
    from content_aware_gan_compression_torch.evaluation import (
        OverlappedFIDEval, calc_fid, extract_feature_from_samples, get_ppl_score)
    from content_aware_gan_compression_torch.evaluation.fid import _draw_features, feature_stats
    from content_aware_gan_compression_torch.evaluation.ppl import _ppl_batch
    from content_aware_gan_compression_torch.models import InceptionV3, pool3_dim
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts
    from content_aware_gan_compression_torch.utils import save_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    inc = InceptionV3(device=dev, generator=torch.Generator().manual_seed(INCEPTION_SEED)).eval()
    n_batch = FID_SAMPLES // FID_BATCH

    def stream(seed, tf32):
        torch.backends.cudnn.allow_tf32 = tf32
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract_feature_from_samples(g, inc, batch_size=FID_BATCH, n_sample=FID_SAMPLES,
                                             generator=torch.Generator(dev).manual_seed(seed))
        seconds = time.perf_counter() - t0  # ends in the features' copy to the host
        torch.backends.cudnn.allow_tf32 = False
        return feats, seconds, counts()

    # -- 10. fid_path: the feature stream, 2048 samples in batches of 64 ------
    feats, stream_s, c = stream(0, False)
    want = {"blur4": 6 * n_batch, "blur4_vector": 6 * n_batch,
            "fused_noise_bias_lrelu": 13 * n_batch, "masked_scale": 0, "blur4_backward": 0}
    fid_launches = {k: c[k] for k in want}
    stats = feature_stats(feats)
    live = int((feats.std(0) > 0).sum())
    rank = int(np.linalg.matrix_rank(stats["cov"]))
    # the same draws again through the overlapped eval: the stream against its
    # own statistics
    ev = OverlappedFIDEval(g, inc, stats, batch_size=FID_BATCH, n_sample=FID_SAMPLES,
                           generator=torch.Generator(dev).manual_seed(0))
    self_fid = None
    ticks = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        while self_fid is None:
            self_fid = ev.advance(2)
            ticks += 1
    self_retry = any("singular" in str(w.message) for w in caught)
    feats_b, _, _ = stream(1, False)
    other_fid, other_retry = fid_quietly(calc_fid, feature_stats(feats_b), stats)
    trace = float(np.trace(stats["cov"]))
    detail("fid_path", size=SIZE, batch=FID_BATCH, samples=FID_SAMPLES,
           cut="2048 samples of the reference's 50000, for time", batches=n_batch,
           launches=fid_launches, launches_per_batch={k: v / n_batch for k, v in
                                                      fid_launches.items()},
           pool3_dim=pool3_dim(inc), inception=f"full width, seeded {INCEPTION_SEED}, unit BN",
           features_finite=bool(np.isfinite(feats).all()), live_features=live, cov_rank=rank,
           fid_self=self_fid, fid_self_overlapped_ticks=ticks, fid_other_stream=other_fid,
           eps_retry={"self": self_retry, "other": other_retry}, cov_trace=trace, tf32=False)
    if fid_launches != want:
        fail(f"fid_path launched {fid_launches}, want {want}")
    if feats.shape != (FID_SAMPLES, 2048) or not np.isfinite(feats).all():
        fail(f"fid_path features {feats.shape} not finite or wrong shape")
    if not (np.isfinite(other_fid) and other_fid > 0 and abs(self_fid) <= 1e-4 * other_fid):
        fail(f"fid_path: FID against its own statistics {self_fid}, against another stream's "
             f"{other_fid}")
    if self_retry or other_retry:
        fail("fid_path: calc_fid took the eps retry for a singular covariance product")

    # TF32: the same latents under PyTorch's defaults (cuDNN TF32 on)
    feats_tf32, stream_tf32_s, _ = stream(0, True)
    tf32_fid, _ = fid_quietly(calc_fid, feature_stats(feats_tf32), stats)
    tf32 = {"feature_max_abs_diff": float(np.abs(feats_tf32 - feats).max()),
            "feature_max_abs": float(np.abs(feats).max()),
            "feature_mean_abs_diff": float(np.abs(feats_tf32 - feats).mean()),
            "fid_defaults_vs_tf32_off": tf32_fid, "fid_other_stream_tf32_off": other_fid}
    detail("fid_tf32_sensitivity", samples=FID_SAMPLES, **tf32,
           note="the same z and noise with cuDNN TF32 on (PyTorch's default) and off; both "
                "the generator's and Inception's convolutions change")

    # -- 11. ppl_path: 512 pairs in batches of 32 --------------------------------
    lpips = seeded_lpips().to(dev).requires_grad_(False).eval()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppl, dist = get_ppl_score(g, lpips, n_sample=PPL_SAMPLES, batch_size=PPL_BATCH,
                              generator=torch.Generator(dev).manual_seed(0),
                              return_distances=True)
    ppl_s = time.perf_counter() - t0
    c = counts()
    ppl_batches = PPL_SAMPLES // PPL_BATCH
    ppl_launches = {k: c[k] for k in want}
    want_ppl = {"blur4": 6 * ppl_batches, "blur4_vector": 6 * ppl_batches,
                "fused_noise_bias_lrelu": 13 * ppl_batches, "masked_scale": 0,
                "blur4_backward": 0}
    detail("ppl_path", size=SIZE, pairs_per_batch=PPL_BATCH, pairs=PPL_SAMPLES,
           cut="512 pairs of the reference's 5000, for time", eps=1e-4, score=ppl,
           distances={"min": float(dist.min()), "max": float(dist.max()),
                      "mean": float(dist.mean())},
           launches=ppl_launches, lpips="LPIPS-VGG16, full width, seed 5", tf32=False)
    if ppl_launches != want_ppl:
        fail(f"ppl_path launched {ppl_launches}, want {want_ppl}")
    if dist.shape != (PPL_SAMPLES,) or not np.isfinite(dist).all() or not (dist >= 0).all():
        fail(f"ppl_path distances {dist.shape} not finite or negative")

    # -- 12. eval_cuda_vs_cpu: the first FID batch and 4 PPL pairs, TF32 off ----
    gen = torch.Generator(dev).manual_seed(0)  # replays the stream's first batch
    z = torch.randn(FID_BATCH, g.config.style_dim, generator=gen, device=dev)
    with torch.inference_mode():
        img = g([z], generator=gen)
        on_card = inc(img, normalize_input=False).cpu().numpy()
    inc_cpu = copy.deepcopy(inc).to("cpu")
    with torch.inference_mode():
        on_cpu = inc_cpu(img.cpu(), normalize_input=False).numpy()
    feat_err = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    replay_err = float(np.abs(on_card - feats[:FID_BATCH]).max())
    swapped = feats.copy()
    swapped[:FID_BATCH] = on_cpu
    swap_fid, _ = fid_quietly(calc_fid, feature_stats(swapped), stats)

    g_cpu = copy.deepcopy(g).to("cpu")
    lpips_cpu = copy.deepcopy(lpips).to("cpu")
    crng = torch.Generator().manual_seed(3)
    z = torch.randn(8, g.config.style_dim, generator=crng)
    t = torch.rand(4, generator=crng)
    noise = g_cpu.make_noise(8, crng)
    d_card = _ppl_batch(g, lpips, z.to(dev), t.to(dev), 1e-4,
                        noise=[n.to(dev) for n in noise]).cpu().numpy()
    d_cpu = _ppl_batch(g_cpu, lpips_cpu, z, t, 1e-4, noise=noise).numpy()
    ppl_err = float(np.abs(d_card - d_cpu).max() / np.abs(d_cpu).max())
    detail("eval_cuda_vs_cpu", tf32=False, features_images=FID_BATCH,
           features_max_rel_err=feat_err, features_tolerance="1e-3 of the CPU's max |feature|",
           features_vs_stream_max_abs_diff=replay_err,
           fid_stream_with_cpu_batch_vs_stream=swap_fid,
           fid_tolerance="below 1e-3 of the FID between two streams",
           ppl_pairs=4, ppl_card=d_card.tolist(), ppl_cpu=d_cpu.tolist(), ppl_max_rel_err=ppl_err,
           ppl_tolerance="5e-2 of the CPU's largest distance (eps 1e-4: the pair's images "
                         "differ by about 1e-4)")
    if not feat_err <= 1e-3 or not abs(swap_fid) <= 1e-3 * other_fid or not ppl_err <= 5e-2:
        fail(f"evaluation on the card vs the CPU: features {feat_err}, FID {swap_fid}, "
             f"PPL {ppl_err}")
    del g_cpu, lpips_cpu, inc_cpu, img

    # -- 13. eval_cli: the three CLIs on seeded files, and the in-loop FID ------
    # A width-1/8 Inception (pool3 dim 256) in the pytorch-fid schema keeps
    # the statistics of 512 images full rank; LPIPS files at full width.
    os.makedirs(work, exist_ok=True)
    small = InceptionV3(0.125, device="cpu", generator=torch.Generator().manual_seed(1))
    inc_file = os.path.join(work, "pt_inception_w0.125.pth")
    sd = {k: v for k, v in small.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    sd.update({"fc.weight": torch.zeros(1008, 256), "fc.bias": torch.zeros(1008)})
    torch.save(sd, inc_file)
    cache = os.path.join(work, "real256_seeded.npy")
    np.save(cache, np.random.RandomState(4).randint(0, 256, (512, SIZE, SIZE, 3), dtype=np.uint8))
    ckpt = os.path.join(work, "g256_seed0.npz")
    save_checkpoint(ckpt, {"g_ema": g.state_dict()}, metadata={"size": SIZE, "seed": 0})
    vgg_file, lins_file = write_aux_files(work, lpips)
    cli = {}
    t0 = time.time()
    stats_file = calc_inception.main([cache, "--size", str(SIZE), "--batch", "64",
                                      "--inception_ckpt", inc_file, "--output",
                                      os.path.join(work, "inception_real256.pkl"),
                                      "--device", "cuda"])
    cli["calc_inception_s"] = round(time.time() - t0, 3)
    t0 = time.time()
    cli["fid"] = float(get_fid.main(["--ckpt", ckpt, "--generated_img_size", str(SIZE),
                                     "--real_stats", stats_file, "--n_sample", "512",
                                     "--inception_ckpt", inc_file, "--device", "cuda"]))
    cli["get_fid_s"] = round(time.time() - t0, 3)
    t0 = time.time()
    cli["ppl"] = float(get_ppl.main(["--ckpt", ckpt, "--generated_img_size", str(SIZE),
                                     "--n_sample", "64", "--batch_size", "32",
                                     "--lpips_vgg_ckpt", vgg_file, "--lpips_lins_ckpt",
                                     lins_file, "--device", "cuda"]))
    cli["get_ppl_s"] = round(time.time() - t0, 3)
    student, teacher = write_train_checkpoints(work, SIZE)
    root = os.path.join(work, "cli_fid")
    t0 = time.time()
    proc = subprocess.run([
        sys.executable, "-m", "content_aware_gan_compression_torch.train", "--path", cache,
        "--size", str(SIZE), "--ckpt", student, "--teacher_ckpt", teacher,
        "--batch_size", str(BATCH), "--iter", "8", "--n_sample", "4",
        "--val_sample_freq", "100", "--model_save_freq", "3", "--fid_n_sample", "512",
        "--fid_batch", "64", "--inception_ckpt", inc_file, "--real_stats", stats_file,
        "--exp_root", root], cwd=REPO, capture_output=True, text=True, timeout=600)
    cli["train_in_loop_fid_s"] = round(time.time() - t0, 3)
    if proc.returncode != 0:
        fail(f"train CLI with in-loop FID rc {proc.returncode}: {proc.stderr[-3000:]}")
    (exp,) = [os.path.join(root, d) for d in os.listdir(root) if d.startswith("Exp_")]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        fid_recs = [r for r in map(json.loads, f) if "fid" in r]
    cli["train_fid_records"] = fid_recs
    detail("eval_cli", **cli, inception="width 1/8, seeded, pytorch-fid schema",
           real="512 seeded uint8 images at 256px",
           train="11x student, KD-L1, 8 iterations, FID of 512 samples every 3, overlapped")
    if not (np.isfinite(cli["fid"]) and cli["fid"] > 0 and np.isfinite(cli["ppl"])
            and cli["ppl"] >= 0):
        fail(f"eval CLIs: {cli}")
    if [r["iter"] for r in fid_recs] != [3, 6] or not all(np.isfinite(r["fid"])
                                                        for r in fid_recs):
        fail(f"train CLI in-loop FID records {fid_recs}, want iterations 3 and 6")
    shutil.rmtree(work)

    # -- 14. times: the stream, Inception alone, PPL, peak memory ---------------
    flops, n_convs = inception_conv_flops(inc, dev)
    x64 = torch.randn(FID_BATCH, 3, SIZE, SIZE, device=dev).clamp(-1, 1)
    z64 = torch.randn(FID_BATCH, g.config.style_dim, device=dev)
    noise64 = g.make_noise(FID_BATCH, torch.Generator(dev).manual_seed(9))
    rates = {}
    for label, tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        with torch.inference_mode():
            g_ms = time_ms(lambda: g([z64], noise=noise64), iters=10)
            inc_ms = time_ms(lambda: inc(x64, normalize_input=False), iters=10)
        rates[label] = {"generator_ms_per_batch": g_ms, "inception_ms_per_batch": inc_ms,
                        "inception_tflop_per_s": FID_BATCH * flops / inc_ms / 1e9}
    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator(dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    get_ppl_score(g, lpips, n_sample=4 * PPL_BATCH, batch_size=PPL_BATCH, generator=gen)
    ppl_defaults_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = False
    rates["tf32_off"].update(fid_samples_per_s=FID_SAMPLES / stream_s,
                             ppl_pairs_per_s=PPL_SAMPLES / ppl_s)
    rates["pytorch_defaults"].update(fid_samples_per_s=FID_SAMPLES / stream_tf32_s,
                                     ppl_pairs_per_s=4 * PPL_BATCH / ppl_defaults_s)
    memory = {}
    for batch in (32, FID_BATCH):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _draw_features(g, inc, batch, torch.Generator(dev).manual_seed(0), 1.0, None)
        torch.cuda.synchronize()
        memory[f"batch_{batch}"] = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                                    "above_resident_gb": (torch.cuda.max_memory_allocated()
                                                          - base) / 1e9}
    memory["g_ema_snapshot_gb"] = sum(t.numel() * t.element_size()
                                      for t in g.state_dict().values()) / 1e9
    detail("eval_rate", size=SIZE, fid_batch=FID_BATCH, ppl_pairs_per_batch=PPL_BATCH,
           inception_gflop_per_image=flops / 1e9, inception_convs=n_convs, **rates,
           peak_memory=memory, card=card,
           note="stream rates: host clock over the whole stream (2048 samples; PPL 512 pairs "
                "with TF32 off, 128 under the defaults) ending in the copy to the host; "
                "generator and Inception ms: median of 10 calls, CUDA events; FLOPs: the "
                "convolutions' multiply-adds x 2")
    del inc, lpips, x64
    return {"fid": fid_launches, "ppl": ppl_launches}


def prune_vs_float64(dev):
    """The content-aware scores of one batch at 64px, batch 4, full width,
    with explicit draws, on the card and on the CPU, each held against the
    CPU in float64 (as phase 7: the card may be no further from float64
    than twice the CPU's fp32 distance, plus 1e-4). Every run masks with the
    float64 run's class map from a width-0.25 seeded BiSeNet. Runs under the
    caller's cuDNN flags (deterministic, TF32 off). Returns the distances."""
    from content_aware_gan_compression_torch.models import (
        Generator, GeneratorConfig, make_parse_fn)
    from content_aware_gan_compression_torch.pruning import (
        batch_img_parsing, draw_scoring_batch, get_content_aware_pruning_score)

    g_cpu = Generator(GeneratorConfig(size=64), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    randomize_epilogues(g_cpu, 1)
    runs = {"cpu": g_cpu, "card": copy.deepcopy(g_cpu).to(dev),
            "f64": copy.deepcopy(g_cpu).double()}
    z, noise, sp, bern = draw_scoring_batch(g_cpu, 4, PRUNE_NOISE,
                                            torch.Generator().manual_seed(0))
    with torch.no_grad():
        img64 = runs["f64"]([z.double()], noise=[n.double() for n in noise],
                            output_format="NHWC")
    parser64, parser_seed, share = pick_parser(img64, width_scale=0.25)
    class_map = batch_img_parsing(img64, make_parse_fn(parser64, "NHWC"), "NHWC")
    scores = {}
    for key, g_run in runs.items():
        dtype = torch.float64 if key == "f64" else torch.float32
        d = g_run.device
        draws = [(z.to(d, dtype), [n.to(d, dtype) for n in noise], sp.to(d, dtype), bern.to(d))]
        parse_fn = make_parse_fn(FixedParse(class_map).to(d), "NHWC")
        scores[key] = get_content_aware_pruning_score(
            g_run, parse_fn=parse_fn, n_sample=4, batch_size=4, noise_prob=PRUNE_NOISE,
            draws=draws)[0]

    def distance(key):
        return [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(scores[key], scores["f64"])]
    card, cpu = distance("card"), distance("cpu")
    out = {"card_vs_float64": max(card), "cpu_vs_float64": max(cpu),
           "card_per_layer": card, "cpu_per_layer": cpu, "parser_seed": parser_seed,
           "coi_share": share}
    if not max(card) <= 2 * max(cpu) + 1e-4:
        fail(f"content-aware scores on the card vs float64 on the CPU: {out}")
    return out


def prune_phases(g, dev, card, work):
    """Content-aware pruning at 256px on the full-width generator ``g``:
    the scoring path's launches per batch, the 0.7 remove list, surgery and
    one batch of the pruned generator; the baseline metrics; the scores on
    the card and on the CPU against float64; the prune CLI and the train CLI
    on its output; and the times. Returns the kernels line's launch counts
    of the scoring path."""
    from content_aware_gan_compression_torch.bench_blur4 import time_ms
    from content_aware_gan_compression_torch.models import (
        Discriminator, DiscriminatorConfig, make_parse_fn, net_shape_from_params)
    from content_aware_gan_compression_torch.ops.cuda import counts, lane_width, reset_counts
    from content_aware_gan_compression_torch.pruning import (
        batch_img_parsing, coi_mask_from_parsing, draw_scoring_batch, generate_prune_mask_list,
        get_content_aware_pruning_score, get_network_score_list, get_uniform_remove_list,
        mask_the_generator)
    from content_aware_gan_compression_torch.pruning.content_aware import _image_grad_scores
    from content_aware_gan_compression_torch.utils import (
        build_generator_from_state_dict, load_checkpoint, pytree_to_torch_state_dict,
        save_checkpoint)

    torch.backends.cudnn.allow_tf32 = False
    net_shape = g.config.net_shape
    n_batch = PRUNE_SAMPLES // PRUNE_BATCH

    # -- 15. prune_path: content-aware scoring at prune.py's defaults ---------
    # the parser: the first seed whose parse of a batch of g's images is mixed
    with torch.no_grad():
        pick = torch.Generator(dev).manual_seed(8)
        img = g([torch.randn(PRUNE_BATCH, g.config.style_dim, generator=pick, device=dev)],
                noise=g.make_noise(PRUNE_BATCH, pick), output_format="NHWC")
        parser, parser_seed, pick_share = pick_parser(img)
    parse_fn = make_parse_fn(parser, "NHWC")

    def score(tf32):
        torch.backends.cudnn.allow_tf32 = tf32
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = get_content_aware_pruning_score(
            g, parse_fn=parse_fn, n_sample=PRUNE_SAMPLES, batch_size=PRUNE_BATCH,
            noise_prob=PRUNE_NOISE, generator=torch.Generator(dev).manual_seed(0))
        seconds = time.perf_counter() - t0  # ends in the last batch's copy to the host
        torch.backends.cudnn.allow_tf32 = False
        return out, seconds, counts()

    batch_scores, score_s, c = score(False)
    want = prune_launches(int(np.log2(SIZE)), n_batch)
    launches = {k: c[k] for k in want}
    finite = all(np.isfinite(s).all() and (s >= 0).all() for b in batch_scores for s in b)
    total = [sum(b[i] for b in batch_scores) for i in range(len(net_shape))]
    masks = generate_prune_mask_list(total, net_shape, get_uniform_remove_list(net_shape,
                                                                               PRUNE_RATIO))
    kept = tuple(int(m.sum()) for m in masks)
    pruned = mask_the_generator(g.state_dict(), masks)
    g_small = build_generator_from_state_dict(pruned, SIZE, device=dev)
    reset_counts()
    with torch.inference_mode():
        gen = torch.Generator(dev).manual_seed(1)
        small_img = g_small([torch.randn(PRUNE_BATCH, g.config.style_dim, generator=gen,
                                         device=dev)], generator=gen)
        torch.cuda.synchronize()
    small_counts = counts()
    # the content mask's share over the first scoring batch's images
    z, noise, sp, bern = draw_scoring_batch(g, PRUNE_BATCH, PRUNE_NOISE,
                                            torch.Generator(dev).manual_seed(0))
    with torch.no_grad():
        img = g([z], noise=noise, output_format="NHWC")
        coi = coi_mask_from_parsing(batch_img_parsing(img, parse_fn, "NHWC")).float().mean().item()

    def forward_backward():
        _image_grad_scores(g, g([z], noise=noise, output_format="NHWC"), sp.float(), bern.float())

    times = {}
    for label, tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        times[label] = {"generator_forward_backward_ms": time_ms(forward_backward, iters=10),
                        "parse_ms": time_ms(lambda: batch_img_parsing(img, parse_fn, "NHWC"),
                                            iters=10)}
    _, score_defaults_s, _ = score(True)
    # where a scoring batch's device time goes (parse, forward, backward),
    # profiled after the timings, so that the profiler stays out of them:
    # under the defaults the batch is host-bound, and its times vary from
    # run to run (forward and backward 28.6-44.6 ms on an H100)
    for label, tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        times[label]["device_time"] = profile_forward(
            lambda i: get_content_aware_pruning_score(
                g, parse_fn=parse_fn, n_sample=PRUNE_BATCH, batch_size=PRUNE_BATCH,
                noise_prob=PRUNE_NOISE, generator=torch.Generator(dev).manual_seed(i)),
            iters=5, inference=False)
    torch.backends.cudnn.allow_tf32 = False
    times["tf32_off"]["scoring_s"] = score_s
    times["pytorch_defaults"]["scoring_s"] = score_defaults_s
    for label in times:
        times[label]["samples_per_s"] = PRUNE_SAMPLES / times[label]["scoring_s"]
    detail("prune_path", size=SIZE, samples=PRUNE_SAMPLES, batch=PRUNE_BATCH,
           noise_prob=PRUNE_NOISE, batches=n_batch, launches=launches,
           launches_per_batch={k: v / n_batch for k, v in launches.items()},
           grad_copies=c["blur4_grad_copies"] + c["masked_scale_grad_copies"],
           parser=f"BiSeNet, full width, seed {parser_seed} (mask keeps {pick_share:.4f} of "
                  "the picking batch)", coi_share_first_batch=coi, scores_finite=finite,
           score_ranges=[[float(s.min()), float(s.max())] for s in total],
           kept=list(kept), pruned_launches=small_counts,
           pruned_blur_lanes=[lane_width(shape[3]) for shape in student_blur_shapes(PRUNE_BATCH,
                                                                                    kept)],
           pruned_images=list(small_img.shape), **times, card=card,
           note=f"scoring_s: host clock over the {n_batch} batches, ending in the scores' copy "
                "to the host; forward_backward and parse: median ms of 10 calls, CUDA events; "
                "device_time: the profiler over 5 scoring batches")
    if launches != want:
        fail(f"prune_path launched {launches}, want {want}")
    if not finite or any(s.shape != (w,) for s, w in zip(total, net_shape)):
        fail("prune_path: a score is not finite, negative or of the wrong width")
    if kept != STUDENT_SHAPE or net_shape_from_params(pruned) != STUDENT_SHAPE:
        fail(f"prune_path kept {kept}, want {STUDENT_SHAPE}")
    one = prune_launches(int(np.log2(SIZE)), 1)
    if (small_counts["blur4"] != one["blur4"] or small_counts["blur4_vector"] != 0
            or small_counts["fused_noise_bias_lrelu"] != one["fused_noise_bias_lrelu"]
            or not torch.isfinite(small_img).all()):
        fail(f"the pruned generator: launches {small_counts}, finite "
             f"{bool(torch.isfinite(small_img).all())}")
    if not 0.0 < coi < 1.0:
        fail(f"prune_path: the mask keeps {coi} of the first batch's pixels")
    del g_small, small_img, img

    # -- 16. prune_metrics: one metric of each family over 400 samples --------
    z400 = torch.randn(PRUNE_SAMPLES, g.config.style_dim, generator=torch.Generator(dev)
                       .manual_seed(3), device=dev)
    metrics = {}
    for metric in ("ASV", "l1-out", "l1-style", "Random"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = get_network_score_list(g, z400, metric, batch_size=PRUNE_BATCH,
                                        generator=torch.Generator(dev).manual_seed(4))
        metrics[metric] = {"seconds": time.perf_counter() - t0,
                           "range": [float(min(s.min() for s in scores)),
                                     float(max(s.max() for s in scores))],
                           "launches": {k: counts()[k] for k in want}}
        if ([s.shape for s in scores] != [(w,) for w in net_shape]
                or not all(np.isfinite(s).all() for s in scores)):
            fail(f"prune_metrics {metric}: shapes {[s.shape for s in scores]} or not finite")
        if metric == "ASV" and not (scores[0] == 0).all():
            fail(f"prune_metrics ASV of the constant input is {scores[0].max()}, want 0")
    detail("prune_metrics", size=SIZE, samples=PRUNE_SAMPLES, batch=PRUNE_BATCH, tf32=False,
           **metrics, card=card, note="seconds: host clock, ending in the scores' copy to the "
           f"host; ASV: {n_batch} feature-map forwards, no backward")

    # -- 17. prune_cuda_vs_cpu: 64px, batch 4, against float64 -----------------
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                     allow_tf32=False):
        small = prune_vs_float64(dev)
    detail("prune_cuda_vs_cpu", size=64, batch=4, tf32=False, cudnn_deterministic=True,
           **small, measure="per layer, largest |a - float64| / max|float64| of the scores",
           tolerance="card <= 2 * cpu + 1e-4")

    # -- 18. prune_cli: the prune CLI, then the train CLI on its output --------
    os.makedirs(work, exist_ok=True)
    ckpt = os.path.join(work, "g256_seed0.npz")
    d_sd = Discriminator(DiscriminatorConfig(size=SIZE), device="cpu",
                         generator=torch.Generator().manual_seed(3)).state_dict()
    save_checkpoint(ckpt, {"g_ema": g.state_dict(), "d": d_sd}, metadata={"size": SIZE})
    parser_file = os.path.join(work, "79999_iter.pth")
    torch.save(bisenet_file_state(parser), parser_file)
    cli = {}
    for metric in ("content-aware", "l1-out"):
        out_dir = os.path.join(work, f"pruned_{metric}")
        t0 = time.time()
        proc = subprocess.run([
            sys.executable, "-m", "content_aware_gan_compression_torch.prune", "--ckpt", ckpt,
            "--generated_img_size", str(SIZE), "--parsing_ckpt", parser_file, "--n_sample",
            str(PRUNE_CLI_SAMPLES), "--metric", metric, "--out_dir", out_dir], cwd=REPO,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"prune CLI ({metric}) rc {proc.returncode}: {proc.stderr[-3000:]}")
        (npz,) = [os.path.join(out_dir, f) for f in os.listdir(out_dir) if f.endswith(".npz")]
        trees, meta = load_checkpoint(npz)
        g_ema, g_tree = (pytree_to_torch_state_dict(trees[k]) for k in ("g_ema", "g"))
        pth = torch.load(npz[:-4] + ".pth", weights_only=True)
        cli[metric] = {"seconds": round(time.time() - t0, 3), "npz": npz, "metadata": meta,
                       "trees": sorted(trees), "pth_trees": sorted(pth),
                       "net_shape": list(net_shape_from_params(g_ema)),
                       "g_equals_g_ema": all(torch.equal(g_tree[k], v) for k, v in g_ema.items()),
                       "printed": [ln for ln in proc.stdout.splitlines() if "takes" in ln
                                   or "WARNING" in ln]}
        if (sorted(trees) != ["d", "g", "g_ema"] or sorted(pth) != ["d", "g", "g_ema"]
                or tuple(cli[metric]["net_shape"]) != STUDENT_SHAPE
                or not cli[metric]["g_equals_g_ema"] or meta["metric"] != metric
                or not any("takes" in ln for ln in cli[metric]["printed"])
                or any("WARNING" in ln for ln in cli[metric]["printed"])):
            fail(f"prune CLI ({metric}): {cli[metric]}")
    cache = os.path.join(work, "ffhq256_seeded.npy")
    np.save(cache, np.random.RandomState(5).randint(0, 256, (32, SIZE, SIZE, 3), dtype=np.uint8))
    root = os.path.join(work, "cli_retrain")
    t0 = time.time()
    proc = subprocess.run([
        sys.executable, "-m", "content_aware_gan_compression_torch.train", "--path", cache,
        "--size", str(SIZE), "--ckpt", cli["content-aware"]["npz"], "--teacher_ckpt", ckpt,
        "--batch_size", str(BATCH), "--iter", "2", "--n_sample", "4", "--val_sample_freq", "100",
        "--model_save_freq", "100", "--exp_root", root], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"train CLI on the pruned checkpoint rc {proc.returncode}: {proc.stderr[-3000:]}")
    (exp,) = [os.path.join(root, d) for d in os.listdir(root) if d.startswith("Exp_")]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    cli["retrain"] = {"seconds": round(time.time() - t0, 3), "iters": [r["iter"] for r in recs],
                      "finite": all(np.isfinite(v) for r in recs for v in r.values())}
    detail("prune_cli", **{k: {kk: vv for kk, vv in v.items() if kk != "npz"}
                           for k, v in cli.items()},
           cut=f"{PRUNE_CLI_SAMPLES} samples of prune.py's 400, for time",
           retrain_setup="the train CLI: the pruned checkpoint as --ckpt, the full-width one "
                         "as --teacher_ckpt, KD-L1 (no aux files), 2 iterations")
    if cli["retrain"]["iters"] != [0, 1] or not cli["retrain"]["finite"]:
        fail(f"train CLI on the pruned checkpoint: {cli['retrain']}")
    shutil.rmtree(work)
    del parser
    return launches


def train_vs_float64(work, dev, objectives=("kd_l1", "full_kd")):
    """One iteration at 64px, batch 4, TF32 off, on the card and on the CPU,
    each held against the CPU in float64, per phase; fails on a phase where
    the card is further from float64 than the bound. Returns the distances.

    The path-length and R1 gradients are grads of grads, and fp32 rounds
    them by up to 1% on either device. So the card and the CPU, both in
    fp32, are each held against the same iteration in float64 on the CPU:
    per phase, the card may be no further from it than twice the CPU's own
    fp32 distance, plus 1e-4. With the full objective every run masks with
    the float64 run's class map: an argmax may flip where two logits tie
    within rounding, which would measure the tie, not the port.

    The card runs cuDNN's deterministic algorithms here. The default ones
    sum with atomics in a varying order, and the gradient of the student's
    last noise weight (a scalar, 0.0094 in float64, the sum of terms of both
    signs over a [4,64,64,C] map) then moves from run to run by up to 6e-3
    of its value, on the parent commit's code too; deterministic algorithms
    give the same result in every run."""
    from content_aware_gan_compression_torch.train import Trainer

    s_small, t_small = write_train_checkpoints(work, 64)
    real64 = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (4, 64, 64, 3), dtype=np.uint8)).float() / 127.5 - 1.0
    trained = {"d": "d", "d_reg": "d", "g": "g", "g_reg": "g"}
    small_checks = {}
    for objective in objectives:
        # lr 0: Adam's first step is about lr * sign(g), so a weight whose
        # gradient is near 0 would move apart on the two devices and every
        # later phase would start from other weights; with lr 0 each phase
        # compares the same computation on the same weights
        cfg64 = train_config(64, 4, s_small, t_small, objective, init_lr=0.0)
        aux = {"lpips_params": seeded_lpips(0.25).state_dict()} if objective == "full_kd" else {}
        runs = {"cpu": Trainer(cfg64, device="cpu", **aux),
                "card": Trainer(cfg64, device=dev, **aux),
                "f64": Trainer(cfg64, device="cpu", **aux)}
        for module in (runs["f64"].g, runs["f64"].d, runs["f64"].teacher, runs["f64"].lpips):
            if module is not None:
                module.double()
        draws = runs["cpu"].draw(0)
        f64_draws = {ph: {k: ([t.double() for t in v] if isinstance(v, list)
                              else v.double() if v.is_floating_point() else v)
                          for k, v in d.items()} for ph, d in draws.items()}
        agree = None
        if objective == "full_kd":
            from content_aware_gan_compression_torch.models import make_parse_fn
            from content_aware_gan_compression_torch.pruning import batch_img_parsing

            maps = {}
            for key in ("cpu", "f64", "card"):  # the parser is picked on the CPU's images
                tr, g_draw = runs[key], to_device(
                    f64_draws["g"] if key == "f64" else draws["g"], runs[key].device)
                with torch.no_grad():
                    img = tr.teacher(g_draw["z"], inject_index=g_draw["inject_index"],
                                     noise=g_draw["teacher_noise"], output_format="NHWC")
                if key == "cpu":
                    parser64, parser64_seed, _ = pick_parser(img, width_scale=0.25)
                    continue
                net = copy.deepcopy(parser64).to(tr.device, img.dtype)
                maps[key] = batch_img_parsing(img, make_parse_fn(net, "NHWC"), "NHWC").cpu()
            agree = (maps["card"] == maps["f64"]).float().mean().item()
            for tr in runs.values():
                tr.parser = FixedParse(maps["f64"]).to(tr.device)
        results = {}
        for key, tr in runs.items():
            dtype = torch.float64 if key == "f64" else torch.float32
            store = results[key] = {}

            def hook(name, store=store, tr=tr):
                if name in trained:
                    store[name] = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                   .detach().cpu().double()
                                   for n, p in getattr(tr, trained[name]).named_parameters()}
            metrics, _ = tr.step(0, real64.to(tr.device, dtype),
                                 torch.zeros((), device=tr.device, dtype=dtype),
                                 draws=to_device(f64_draws if key == "f64" else draws, tr.device),
                                 phase_hook=hook)
            store["losses"] = {k: v.item() for k, v in metrics.items()}

        def distance(key, results=results):
            losses = max(abs(v - results["f64"]["losses"][k])
                         / max(abs(results["f64"]["losses"][k]), 1e-6)
                         for k, v in results[key]["losses"].items())
            grads = {ph: max(max_rel_err(results[key][ph][n], g)
                             for n, g in results["f64"][ph].items()) for ph in trained}
            return {"losses": losses, **grads}

        cpu_err, card_err = distance("cpu"), distance("card")
        small_checks[objective] = {"card_vs_float64": card_err, "cpu_vs_float64": cpu_err,
                                   "losses_float64": results["f64"]["losses"]}
        if agree is not None:
            small_checks[objective].update(
                parse_agreement_card_vs_float64=agree, parser_seed=parser64_seed,
                aux="LPIPS and BiSeNet widths scaled 0.25, seeded")
        bad = {k: (card_err[k], cpu_err[k]) for k in card_err
               if not card_err[k] <= 2 * cpu_err[k] + 1e-4}
        if bad:
            fail(f"training ({objective}) on the card vs float64 on the CPU: {bad}")
        if objective == "full_kd" and not results["f64"]["losses"]["kd_lpips_loss"] > 0:
            fail("64px full_kd: the LPIPS term is 0")
        del runs, results
    return small_checks


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
    # the evaluation path's shapes: a FID batch of 64, a PPL batch of 32 pairs
    eval_blur_shapes, eval_fused_shapes = generator_layer_shapes(FID_BATCH)
    # the prune path's: scoring batches of 10 at full width (the up-blurs,
    # and their backward, the blur of the gradient with pads (2, 2)), and the
    # pruned generator at batch 10 (C = 154, 77, 39: scalar lanes)
    prune_blur_shapes, prune_fused_shapes = generator_layer_shapes(PRUNE_BATCH)
    # (shape, pad, gain, misaligned view)
    blur_cases = [(s, (1, 1), 4.0, False) for s in blur_shapes + student_blur_shapes(BATCH)
                  + student_blur_shapes(PATH_BATCH) + eval_blur_shapes + prune_blur_shapes
                  + student_blur_shapes(PRUNE_BATCH)] + [
        ((b, h - 1, w - 1, c), (2, 2), 4.0, False) for b, h, w, c in prune_blur_shapes] + [
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

    fused_cases = [(s, s[0]) for s in fused_shapes + eval_fused_shapes + prune_fused_shapes
                   + student_epilogue_shapes(PRUNE_BATCH)] + [
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

    # the student's training shapes, and the full-width scoring batch's
    ms_cases = student_epilogue_shapes(BATCH) + student_epilogue_shapes(PATH_BATCH) + \
        prune_fused_shapes + [(2, 5, 7, 3), (3, 9, 9, 39), (2, 6, 6, 130)]
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
    randomize_epilogues(g, 1)
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
                for shape in student_blur_shapes(BATCH) + student_blur_shapes(PATH_BATCH)
                + prune_blur_shapes] + [
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
    trainer = Trainer(train_config(SIZE, BATCH, student, teacher, "kd_l1"), device=dev)
    if trainer.g.config.net_shape != STUDENT_SHAPE:
        fail(f"student net_shape {trainer.g.config.net_shape}")
    reals = np.random.RandomState(0).randint(0, 256, (4, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    want_phase = train_phase_launches(int(np.log2(SIZE)))
    torch.backends.cudnn.allow_tf32 = False
    train_launches, train_metrics, iter_s, phase_names = drive_train_path(
        trainer, reals, want_phase)
    detail("train_path", objective="kd_l1", size=SIZE, batch=BATCH, path_batch=PATH_BATCH,
           student=list(STUDENT_SHAPE), phases=phase_names, launches=train_launches,
           per_phase_want={k: want_phase[k] for k in want_phase}, iteration_seconds=iter_s,
           metrics=train_metrics, tf32=False)

    # full_kd: the parser is the first seed whose parse of teacher images
    # (fresh latents) is mixed; LPIPS is drawn from its own seed
    with torch.no_grad():
        pick_gen = torch.Generator(dev).manual_seed(7)
        t_img = trainer.teacher([torch.randn(BATCH, 512, generator=pick_gen, device=dev)],
                                noise=trainer.teacher.make_noise(BATCH, pick_gen),
                                output_format="NHWC")
        parser, parser_seed, pick_share = pick_parser(t_img)
    del t_img
    full = Trainer(train_config(SIZE, BATCH, student, teacher, "full_kd"), device=dev,
                   lpips_params=seeded_lpips(), parse_params=parser)
    draws0 = full.draw(0)
    full_launches, full_metrics, full_iter_s, full_phases = drive_train_path(
        full, reals, want_phase, draws0)
    with torch.no_grad():
        g0 = draws0["g"]
        t_img = full.teacher(g0["z"], inject_index=g0["inject_index"], noise=g0["teacher_noise"],
                             output_format="NHWC")
        coi = mask_share(full.parser, t_img)
    del t_img
    detail("train_path", objective="full_kd", size=SIZE, batch=BATCH, path_batch=PATH_BATCH,
           lpips="LPIPS-VGG16, full width, seed 5", parser=f"BiSeNet, full width, seed "
           f"{parser_seed} (mask keeps {pick_share:.4f} of the picking batch)",
           phases=full_phases, launches=full_launches, iteration_seconds=full_iter_s,
           metrics=full_metrics, coi_share_iteration0=coi, tf32=False)
    if not all(m["kd_lpips_loss"] > 0 and m["kd_l1_loss"] > 0 for m in full_metrics):
        fail(f"full_kd: a KD term is not > 0: {full_metrics}")
    if not 0.0 < coi < 1.0:
        fail(f"full_kd: the mask keeps {coi} of the teacher's pixels at iteration 0")

    # -- 7. one iteration at 64px on the card against the CPU ------------------
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                     allow_tf32=False):
        small_checks = train_vs_float64(work, dev)
    detail("train_cuda_vs_cpu", size=64, batch=4, tf32=False, lr=0.0,
           cudnn_deterministic=True, **small_checks,
           measure="largest |a-b| / max|float64| over each phase's parameter tensors",
           tolerance="card <= 2 * cpu + 1e-4, per phase and for the losses")

    # -- 8. the train CLI: two iterations, then a resume, full objective ------
    cache = os.path.join(work, "ffhq256_seeded.npy")
    np.save(cache, np.random.RandomState(2).randint(0, 256, (32, SIZE, SIZE, 3), dtype=np.uint8))
    vgg_file, lins_file, parsing_file = write_aux_files(work, full.lpips, full.parser)
    base = [sys.executable, "-m", "content_aware_gan_compression_torch.train", "--path", cache,
            "--size", str(SIZE), "--teacher_ckpt", teacher, "--batch_size", str(BATCH),
            "--n_sample", "4", "--val_sample_freq", "1", "--model_save_freq", "1",
            "--lpips_vgg_ckpt", vgg_file, "--lpips_lins_ckpt", lins_file,
            "--parsing_ckpt", parsing_file]
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
                      "kd_lpips_loss": [r["kd_lpips_loss"] for r in recs],
                      "warnings": [ln for ln in proc.stdout.splitlines() if "WARNING" in ln],
                      "finite": all(np.isfinite(v) for r in recs for v in r.values()),
                      "samples": sorted(os.listdir(os.path.join(exp, "sample"))),
                      "ckpts": sorted(os.listdir(os.path.join(exp, "ckpt")))}
    detail("train_cli", **{k: {kk: vv for kk, vv in v.items() if kk != "exp"}
                            for k, v in cli.items()})
    if (cli["train"]["iters"] != [0, 1] or cli["resume"]["iters"] != [2]
            or not cli["train"]["finite"] or not cli["resume"]["finite"]
            or "000001.npz" not in cli["train"]["ckpts"]
            or "000001.png" not in cli["train"]["samples"]
            or "000002.npz" not in cli["resume"]["ckpts"]
            or not all(v > 0 for c in cli.values() for v in c["kd_lpips_loss"])
            or any(c["warnings"] for c in cli.values())):
        fail(f"train CLI: {cli}")
    with open(next(os.path.join(cli["train"]["exp"], f) for f in os.listdir(cli["train"]["exp"])
                   if f.endswith("_training_log.out"))) as f:
        if "KD_LPIPS_Loss: 0.0 " in f.read():
            fail("train CLI logged KD_LPIPS_Loss 0")
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
    # full_kd over the whole window; KD-L1, for the cost of the full
    # objective beside it, over its first half (1 R1 and 2 path-length steps
    # in 8 iterations), which keeps the smoke near 10 minutes
    train_rate = {}
    for objective, tr, window in (("full_kd", full, range(16, 32)),
                                  ("kd_l1", trainer, range(16, 24))):
        mpl = torch.zeros((), device=dev)
        for label, tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
            torch.backends.cudnn.allow_tf32 = tf32
            train_rate[f"{objective}_{label}"], mpl = train_window(tr, reals, mpl, window)
    torch.backends.cudnn.allow_tf32 = False
    detail("train_rate", size=SIZE, batch=BATCH, path_batch=PATH_BATCH, dtype="float32",
           window="full_kd iterations 16-31: 16 D and G steps, 1 R1, 4 path length; "
                  "kd_l1 iterations 16-23: 8 D and G steps, 1 R1, 2 path length", **train_rate,
           note="pytorch_defaults: cuDNN TF32 on, matmul TF32 off; full_kd with full-width "
                "seeded LPIPS-VGG16 and BiSeNet")

    # the aux nets alone at the g phase's shapes: LPIPS on the student's and
    # the teacher's images with the student's input gradient, and the parse
    # (the 512px resize, BiSeNet head 0, the argmax)
    from content_aware_gan_compression_torch.models import make_parse_fn
    from content_aware_gan_compression_torch.pruning import batch_img_parsing

    x_s = torch.randn(BATCH, SIZE, SIZE, 3, generator=rng, device=dev).tanh()
    x_t = torch.randn(BATCH, SIZE, SIZE, 3, generator=rng, device=dev).tanh()
    parse_fn = make_parse_fn(full.parser, "NHWC")

    def lpips_step():
        x = x_s.detach().requires_grad_(True)
        full.lpips(x, x_t, data_format="NHWC").sum().backward()
    aux_ms = {}
    for label, tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        aux_ms[label] = {"lpips_forward_backward": time_ms(lpips_step, iters=10),
                         "parse": time_ms(lambda: batch_img_parsing(x_t, parse_fn, "NHWC"),
                                          iters=10)}
    torch.backends.cudnn.allow_tf32 = False
    detail("aux_times", batch=BATCH, size=SIZE, **aux_ms, card=card,
           note="median ms of 10 calls, CUDA events; lpips: both images forward, the "
                "student's input gradient back")
    del trainer, full, x_s, x_t

    eval_launches = eval_phases(g, dev, card, os.path.join(REPO, "build", "chip_smoke"))
    prune_counts = prune_phases(g, dev, card, os.path.join(REPO, "build", "chip_smoke"))

    kernels = [
        {"name": "blur4", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/blur4.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/upfirdn2d_pallas.py:66",
         "launches": full_launches["blur4"] + full_launches["blur4_backward"],
         "launches_forward": full_launches["blur4"],
         "launches_backward": full_launches["blur4_backward"],
         "vector_launches": full_launches["blur4_vector"],
         "launches_kd_l1": train_launches["blur4"] + train_launches["blur4_backward"],
         "launches_generate": launches["blur4"], "vector_launches_generate": generate_vector,
         "launches_fid": eval_launches["fid"]["blur4"],
         "launches_ppl": eval_launches["ppl"]["blur4"],
         "launches_prune": prune_counts["blur4"] + prune_counts["blur4_backward"],
         "launches_prune_forward": prune_counts["blur4"],
         "launches_prune_backward": prune_counts["blur4_backward"],
         "max_abs_err": blur_err, "max_rel_err_backward": bw_blur_err,
         **{k: blur_times[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "shape")},
         "shapes": blur_times},
        {"name": "fused_noise_bias_lrelu", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/fused_noise_bias_lrelu.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/fused_act_pallas.py:50",
         "launches": full_launches["fused_noise_bias_lrelu"],
         "launches_kd_l1": train_launches["fused_noise_bias_lrelu"],
         "launches_generate": launches["fused_noise_bias_lrelu"],
         "launches_fid": eval_launches["fid"]["fused_noise_bias_lrelu"],
         "launches_ppl": eval_launches["ppl"]["fused_noise_bias_lrelu"],
         "launches_prune": prune_counts["fused_noise_bias_lrelu"], "max_abs_err": fused_err,
         "max_rel_err_backward": bw_fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound,
         "bound_by": fused_by, "library_ms": None, "shape": list(f_shape)},
        {"name": "masked_scale", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/masked_scale.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/fused_act_pallas.py:73",
         "launches": full_launches["masked_scale"],
         "launches_kd_l1": train_launches["masked_scale"],
         "launches_fid": eval_launches["fid"]["masked_scale"],
         "launches_ppl": eval_launches["ppl"]["masked_scale"],
         "launches_prune": prune_counts["masked_scale"], "max_abs_err": ms_err, "ms": ms_ms,
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
