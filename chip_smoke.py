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
     a view that is not 16-byte aligned); the epilogue and masked_scale (the
     epilogue's backward) also at every epilogue shape of the 11x student at
     batch 16 and path batch 8, every epilogue launch with the 16-byte body
     whatever C is, masked_scale also at the full-width generator's at
     batch 10; and all three at the projector's shapes, the full-width
     generator's at batch 1;
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
     and a misaligned view, the full-width generator's at batch 1; the
     epilogue at the student's shapes at batch 16, without the noise gradient
     as training runs it and with it for a per-sample and a broadcast noise,
     and at the full-width generator's at batch 1 with the noise gradient, as
     the projector runs it) against the same function built from the plain
     versions;
  6. drive the retraining path: the port's Trainer with the 11x student, the
     full-width teacher and D at 256px, batch 16, iterations 0-4 (R1 at 0,
     path length at 0 and 4), with the KD-L1 objective and then with the
     reference's default objective (full_kd: content-aware KD, whose mask is
     a full-width seeded BiSeNet's parse of the teacher's images, plus a
     full-width seeded LPIPS-VGG16); check every loss is finite, the KD
     terms are > 0, the mask keeps a share of the teacher's pixels strictly
     inside (0, 1), and each phase launched each kernel, forward and
     backward, as often as the shapes require (train_phase_launches), every
     epilogue launch with the 16-byte body: the aux nets launch none;
  7. one iteration at 64px, batch 4, TF32 off, on the card (cuDNN's
     deterministic algorithms) and on the CPU, each against the CPU in
     float64, for both objectives (full_kd with width-scaled aux nets, every
     run given the float64 run's class map):
     losses and parameter gradients of each phase; and the share of pixels
     where the card's own parse agrees with float64's;
  8. run ``python -m content_aware_gan_compression_torch.train`` for 2
     iterations at 256px on a seeded uint8 cache with seeded aux-net files
     in the reference's schemas (torchvision VGG16, the LPIPS heads, a
     79999_iter.pth BiSeNet), then resume it with ``--dtype bfloat16
     --opt_state_dtype bfloat16``;
  9. time the kernels against their bounds, their plain versions and one
     PyTorch library call each (blur4 at the generator's, the
     discriminator's and the student's largest shapes; the epilogue and
     masked_scale in float32 and bfloat16 at the student's largest shapes at
     256px and 1024px, C = 39, 77, 154, 20, 10: ``fused_pair_times``), the
     generator's images/s, the training iterations/s over one cadence window of 16
     iterations with the full objective and over its first 8 with KD-L1
     (PyTorch's defaults), with peak memory and where the device time goes,
     and LPIPS and the parse alone at the G step's shapes;
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
     schemas); the train CLI with --inception_ckpt and --real_stats runs in
     phase 25;
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
     its .npz and .pth (phase 25 trains a pruned checkpoint with the train
     CLI).
 19. drive the sparsity baseline at 256px (train_sparsity's defaults where
     they matter: eta 1e-5, Global_Number 588, l1-style, the VGG percept
     term at 3 with a full-width seeded LPIPS, KD-L1 0, Intermediate; batch
     16, path batch 8) from the full-width generator, student and teacher:
     SparsityTrainer.run over iterations 0-5 on a seeded uint8 cache, the prune
     event after iteration 3; each phase's launches against the shapes (the
     g phase as retraining's, with the student's blurs on float4 lanes until
     the prune and on the lanes its new widths give after it), the new
     net_shape (at least 589 channels removed) and its FLOPs % in the log;
 20. the sparsity rates: iterations/s over iterations 16-23 before and after
     a prune event, under PyTorch's defaults, the prune event's seconds and
     peak memory;
 21. one sparse G step at 64px on the card and on the CPU, each against
     float64 (phase 7's bound, cuDNN deterministic, TF32 off);
 22. ``python -m content_aware_gan_compression_torch.train_sparsity`` for 4
     iterations with the prune event after 2: the FLOPs % line and the
     checkpoint saved after the prune; then phases 2 and 5 again at the
     student's shapes at batch 16 and path batch 8 for each net_shape that
     the prune events of 19, 20 and 22 left (widths that are mostly not
     multiples of 4, so scalar lanes);
 23. drive the projector at 256px (the full-width generator, its noise
     weights drawn, and a full-width seeded LPIPS) on one of the generator's
     samples: Adam for 50 iterations and L-BFGS (optax's, with its zoom line
     search) for 10, the latent and the noise maps optimized, 4096 samples
     for the mean latent, with TF32 off and under the defaults; each
     evaluation launches blur4 6 times forward and 6 backward, the epilogue
     13 times and masked_scale 13 times; both losses decrease and the noise
     maps move (the epilogue's noise gradient); PSNR, evaluations per L-BFGS
     iteration, Adam iterations/s and L-BFGS seconds per iteration;
 24. ``python -m content_aware_gan_compression_torch.get_projected_image`` on
     a PNG written by ``write_png`` (read without Pillow where Pillow is
     absent): the printed scores and the side-by-side PNG.
 25. ``e2e_checks``: the port's end-to-end tools at cut settings.
     ``python -m content_aware_gan_compression_torch.tools.e2e_validation
     --in_process`` (one interpreter for its train runs) at 256px, batch 16,
     bfloat16 full_kd: the train CLI for 32 iterations from a folder of 64
     seeded 256px PNGs and from a 256px uint8 cache, one overlapped in-loop
     FID of 256 samples (a width-1/8 Inception) at iteration 16, the it/s of
     iterations 16-31 from each run's metrics.jsonl (over all their time,
     and the 16-iteration window), then ``bench`` in an interpreter
     of its own with its defaults (bfloat16, full_kd) over 16 iterations
     after 9, whose one JSON line is the smoke's bench line; ``tools.fid_descent_validation``
     in this process, its CLIs in process, at 64px (256 teacher samples,
     calc_inception, prune 0.7, get_fid of the teacher and the pruned
     student, 20 iterations with the FID every 10 over 256 samples, get_ppl
     before and after), with each kernel's launches counted. Every step
     exits cleanly and every rate, FID and PPL is finite and positive; the
     descent is reported (held in the tool's full run only).
 26. the training data path on the card's host: 64 seeded PNGs at 512px and
     64 at 256px (``write_png``); the native batch transform's build seconds
     and its images/s at 512 -> 256, batch 16, with the host's threads,
     beside the images/s that bfloat16 full_kd takes (the bench's rate x
     16); the loader's float (512px folder) and uint8 (256px folder, cache)
     rates, each loader's first line naming the decoder;
     ``tools.bench_loader`` on the 512px folder, the native float path and
     the uint8 cache, 4 batches each, each a rate > 0; read_png on a
     Paeth-filtered 1024px PNG; ``prepare_data --format uint8`` against
     ``FFHQDataset.load_uint8``; the train CLI from the 256px folder with no
     cache for 5 iterations (11x student, full teacher), launches per phase
     against train_phase_launches; ``SparsityTrainer.run`` from the 512px
     folder for 2 iterations (float NCHW batches through the transform);
 27. ``train_time_profiler --trace_dir`` at 256px in bfloat16 for 4
     iterations: each phase's mean ms and calls (R1 and path length once),
     every launch a bfloat16 one; the trace through
     ``tools.trace_op_time``: its launches of blur4 (forward and backward),
     the epilogue and masked_scale equal the launch counts of the traced
     iterations, and the device was busy; then ``bench_world`` (27b): with 2
     cards, ``bench`` (9 + 16 iterations) and ``train_time_profiler`` (4
     iterations) under ``torchrun --nproc_per_node=2``, each one JSON object
     from rank 0 with ``world_size`` 2 and finite values; with one card it
     prints ``bench_world: not run, 1 card(s)``;
 28. ``convert_weight`` on seeded TF variables at 256px, full widths, with
     dlatent_avg: its 16-image render on the card against the same CLI on
     the CPU to 1e-3 (TF32 off, cuDNN deterministic), 6 blur4 and 13
     epilogue launches, then the generate CLI on the converted .npz;
 29. ``ModulatedConv2d(downsample=True)`` on [16, 256, 256, 128] in float32
     and bfloat16 against the same conv with the plain blur (float32 1e-5
     of the largest value, bfloat16 bit for bit), one blur4 launch with pad
     (2, 2) each;
 30. path_1024, the 1024px operating point with remat (the checkpointed
     resolution blocks of G and res-blocks of D): ``kernels_1024_vs_plain``
     (the three kernels against their plain versions at every shape of the
     1024px retraining path at batch 16 and path batch 8, forward and
     backward, float32 and bfloat16, the epilogue at FID's [64, 1024, 1024,
     32] of 2^31 elements, and their times), ``train_1024`` (bf16 full_kd at
     1024px, the 11x student, full teacher and D, batch 16, iterations 0-4
     with --remat and without, launches per phase against
     train_phase_launches's remat and plain forms, finite losses, peak
     memory, and the in-loop FID's extra memory at fid_batch 32 beside the
     resident trainer), ``remat_vs_plain_64`` (iteration 0 at 64px, float32,
     TF32 off, lr 0, with remat against without: every gradient tensor
     within 1e-5 of its largest value) and ``generate_fid_1024`` (generate
     --size 1024, a feature stream at fid_batch 32 and 64 with 8 blur4 and
     17 epilogue launches per batch, Inception's pool3 features of 2 of the
     card's images, card vs CPU, to 1e-3).
bfloat16, between phases 5 and 8: ``bf16_kernels_vs_plain`` (5b: the
three kernels in bfloat16 against their plain versions, forward bit for bit
at the generator's, the student's (batch 16 and 8) and D's shapes, backward and double
backward to 2^-7 of the largest value, and their times against the bfloat16
bytes bound), ``train_bf16_vs_float64`` (7b: phase 7's check of full_kd in
bfloat16, card <= 2 x CPU + 1e-3, against phase 7's float64 run, kept when
its draws and parser are the same) and ``train_rate_bf16`` (7c: the full_kd
path in bfloat16 at 256px, iterations 0-4 with every launch a bfloat16 one
and as many as ``train_phase_launches`` wants, no bfloat16 blur in the
general ``upfirdn2d``; then train_rate's window with Adam's second moment in
float32 and in bfloat16).
Data parallel (``parallel``), after phase 8: ``dp_world1_nccl`` (8b: the
bfloat16 full_kd Trainer of 7c, iterations 0-4 in one process and then with
an NCCL process group of world size 1, both under cuDNN's deterministic
algorithms: launches per phase as ``train_phase_launches`` wants, all
bfloat16, and the two trajectories bit for bit; then train_rate_bf16's
window under its flags with the collectives off, on, on, off, and every
all-reduce's CUDA-event time and bytes per iteration),
``dp_two_ranks_one_card`` (8c: two processes on cuda:0 joined over gloo,
named, 64px at a global batch of 8, lr 0, iterations 0-4: the metrics
against one process at 1e-4, iteration 0's all-reduced gradients against
float64 (on the card, plain routes) within twice the card's own fp32
distance from it (one process at batch 8, each half at batch 4) + 1e-4,
the ranks' gradients bit-equal, each rank's launches per phase) and
``dp_nccl_cards`` (8d: with 2 cards, the train CLI under ``torchrun
--nproc_per_node=2`` at 256px, bfloat16 full_kd, global batch 16, it/s and
images/s from rank 0's pass-boundary times; with one card it prints
``dp_nccl_cards: not run, 1 card(s)``). ``python3 chip_smoke.py --dp_cards
1,2,4`` runs that phase alone at each card count for 48 iterations (on a
machine with that many cards) and nothing else; ``python3 chip_smoke.py
--bench_world`` runs only ``bench_world`` (2 cards).
The checks against the host's CPU (phases 7 and 7b, 12's CPU side, 17
and 21) run in a thread beside the phase after them (8, 13, 18, 22), which
drives its CLIs, and report after it; that phase's seconds then include
the CPU's share of the work beside it.
The last lines are a {"kernels": [...]} JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}. Each phase's JSON line also goes to
chiprun_out/chip_smoke_details.jsonl. Needs a CUDA card; without one it
exits non-zero and prints no result.
"""

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
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

from content_aware_gan_compression_torch.tools.fixtures import (
    bisenet_file_state, mask_share, pick_parser, seeded_lpips, write_aux_files, write_pngs,
    write_train_checkpoints)

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


def beside(fn, *args):
    """``fn(*args)`` started in a thread; its future. The checks against the
    host's CPU, whose time goes to the CPU, run beside the phase after them,
    so that the CPU reference costs little wall time of its own. Phases 7
    and 7b, 17 and 21 set cuDNN's flags, which are the process's: each runs
    beside a phase (8, 18, 22) that drives CLI subprocesses and runs no
    convolution here; 12's CPU side sets none and runs beside 13. A
    ``fail`` in ``fn`` exits through the future's ``result()``."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return future


def deterministic(fn):
    """``fn`` under cuDNN's deterministic algorithms with TF32 off (the
    float64 checks' flags)."""
    def run(*args, **kw):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                         allow_tf32=False):
            return fn(*args, **kw)
    return run


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


DETAILS = os.path.join(REPO, "chiprun_out", "chip_smoke_details.jsonl")


def detail(phase, **fields):
    """One JSON line per phase, with the seconds since the script started;
    also appended to ``DETAILS`` (the end of standard output may be all a
    caller keeps)."""
    line = json.dumps({"phase": phase, "t": round(time.time() - START, 1), **fields})
    print(line, flush=True)
    os.makedirs(os.path.dirname(DETAILS), exist_ok=True)
    with open(DETAILS, "a") as f:
        f.write(line + "\n")


def profile_kernels(fn, iters):
    """torch.profiler over ``iters`` calls of ``fn(i)``: ({kernel name: its
    device microseconds}, the window's host-clock microseconds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
    return kernels, window_us


def device_time(parts, top=12):
    """Where the device time goes over profiled windows, each standing for
    ``weight`` windows like it: ``parts`` is [(kernels, window_us, calls,
    weight)]. Each kernel's share of the summed kernel time, the
    hand-written kernels' shares, kernel ms per call and the device's busy
    share of the host clock."""
    kernels, window_us, calls = {}, 0.0, 0
    for part, us, n, weight in parts:
        for k, t in part.items():
            kernels[k] = kernels.get(k, 0.0) + weight * t
        window_us += weight * us
        calls += weight * n
    total = sum(kernels.values())
    if total == 0:
        return "not measured: the profiler recorded no device time"
    ranked = sorted(kernels.items(), key=lambda kt: -kt[1])
    share = lambda word: sum(t for k, t in ranked if word in k) / total  # noqa: E731
    return {"kernel_ms_per_call": total / calls / 1e3,
            "busy_share": total / window_us,
            "blur4_share": share("blur4"), "epilogue_share": share("fnbl_"),
            "masked_scale_share": share("masked_scale"),
            "top": [[k[:80], round(t / total, 4)] for k, t in ranked[:top]]}


def profile_forward(fn, iters=3, top=12, inference=True):
    """``device_time`` of one profiled window of ``iters`` calls of
    ``fn(i)``, after one call outside it."""
    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode:
        fn(0)
        kernels, window_us = profile_kernels(fn, iters)
    return device_time([(kernels, window_us, iters, 1)], top)


def generator_layer_shapes(batch=BATCH):
    """(blur4 input shapes, fused-epilogue shapes) of the 256px generator."""
    from content_aware_gan_compression_torch.models import GeneratorConfig

    ns = GeneratorConfig(size=SIZE).net_shape
    blur = [(batch, 2 ** r + 1, 2 ** r + 1, ns[2 * (r - 2)])
            for r in range(3, int(np.log2(SIZE)) + 1)]
    fused = [(batch, 4, 4, ns[1])] + [
        (batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), ns[i + 1]) for i in range(1, len(ns) - 1)]
    return blur, fused


def train_phase_launches(log_size, remat=False, student_vector=0):
    """Kernel launches of each training phase at a resolution of 2**log_size.
    k = log_size - 2 is both the generator's number of up-blurs and the
    discriminator's number of ResBlocks (two blurs each); e = 2*log_size - 3
    is the generator's number of epilogues. ``student_vector`` of the
    student's k up-blurs take 16-byte lanes. With ``remat`` (the steps'
    checkpointed blocks) the backward replays each checkpointed forward:
    D's 2k blurs once per D backward and twice for R1 (its gradient, then
    the gradient's backward), the student's resolution blocks (k up-blurs,
    2k epilogues; conv1 stays outside) once in g and twice in g_reg. Every
    epilogue launch takes the 16-byte body (``fused_noise_bias_lrelu_vector``):
    its lanes run over the flat tensor whatever C is. PERF.md derives each
    entry."""
    k, e, sv = log_size - 2, 2 * log_size - 3, student_vector
    r = int(remat)
    zero = {"blur4": 0, "blur4_backward": 0, "blur4_vector": 0, "fused_noise_bias_lrelu": 0,
            "fused_noise_bias_lrelu_vector": 0, "masked_scale": 0}
    # blur4_vector: the launches with 16-byte lanes, forward and backward.
    # The teacher's and D's widths are multiples of 8; the 11x student's
    # (154, 77, 39, and 20 and 10 at 1024px) mostly are not, so most of its
    # blurs take narrower lanes.
    phases = {
        # student forward without grad; D forward on fake and on real, and back
        "d": {**zero, "blur4": k + 4 * k + r * 4 * k, "blur4_backward": 4 * k,
              "blur4_vector": 8 * k + sv + r * 4 * k, "fused_noise_bias_lrelu": e},
        # D forward on real; R1's backward; its backward, which also runs
        # back through the forward (the minibatch stddev is not linear)
        "d_reg": {**zero, "blur4": 2 * k + r * 4 * k, "blur4_backward": 6 * k,
                  "blur4_vector": 8 * k + r * 4 * k},
        # teacher and student forward, D forward; back through D and student
        "g": {"blur4": 4 * k + r * 3 * k, "blur4_backward": 3 * k,
              "blur4_vector": k + 2 * k + 2 * k + 2 * sv + r * (2 * k + sv),
              "fused_noise_bias_lrelu": 2 * e + r * 2 * k, "masked_scale": e},
        # student forward; the path-length grad; its backward, and back
        # through the forward
        "g_reg": {**zero, "blur4": k + r * 2 * k, "blur4_backward": 3 * k,
                  "blur4_vector": 4 * sv + r * 2 * sv,
                  "fused_noise_bias_lrelu": e + r * 4 * k, "masked_scale": 3 * e},
        "ema": zero,
    }
    for c in phases.values():
        c["fused_noise_bias_lrelu_vector"] = c["fused_noise_bias_lrelu"]
    return phases


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


def to_float64(draws):
    """A Trainer's draws (phase -> name -> tensor or list of tensors) with
    every floating tensor in float64."""
    return {ph: {k: ([t.double() for t in v] if isinstance(v, list)
                     else v.double() if v.is_floating_point() else v)
                 for k, v in d.items()} for ph, d in draws.items()}


def student_epilogue_shapes(batch, net_shape=STUDENT_SHAPE):
    return [(batch, 4, 4, net_shape[1])] + [
        (batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), net_shape[i + 1])
        for i in range(1, len(net_shape) - 1)]


def student_blur_shapes(batch, net_shape=STUDENT_SHAPE):
    """blur4 input shapes of a generator's up-blurs at ``net_shape``'s
    resolution (the student's: C = 154, ..., 77, 39)."""
    return [(batch, 2 ** r + 1, 2 ** r + 1, net_shape[2 * (r - 2)])
            for r in range(3, (len(net_shape) + 2) // 2 + 1)]


def misaligned(x):
    """``x`` as a contiguous view 4 bytes into its storage, so not 16-byte
    aligned; differentiable."""
    return torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)


def discriminator_blur_cases(size=SIZE):
    """(input shape, pad) of every blur of D at ``size``: each ResBlock blurs
    its input with pad (1,1) for the skip and its conv1 output with (2,2)."""
    from content_aware_gan_compression_torch.models import DiscriminatorConfig

    ch = DiscriminatorConfig(size=size).channels()
    return [((BATCH, size >> i, size >> i, ch[size >> i]), pad)
            for i in range(int(np.log2(size)) - 2) for pad in ((2, 2), (1, 1))]


def hold_forward(blur_cases, fused_cases, ms_shapes, rng):
    """Each kernel against its plain version on the card, on inputs drawn
    from ``rng``: blur4 over (shape, pad, gain, misaligned view) cases to
    1e-5 of max|x|, with one launch per case and float4 lanes where C is a
    multiple of 4 and the view aligned; the epilogue over (shape, noise
    batch) cases, each launch with the 16-byte body whatever C is, and
    masked_scale over shapes, each to 1e-6 of the plain version's largest
    value. Returns the largest absolute error of each."""
    from content_aware_gan_compression_torch.ops import make_kernel
    from content_aware_gan_compression_torch.ops.cuda import (
        blur4, blur4_plain, correlation_taps, counts, fused_noise_bias_lrelu,
        fused_noise_bias_lrelu_plain, masked_scale, masked_scale_plain)

    dev = rng.device
    k4 = make_kernel([1, 3, 3, 1])
    before = counts()
    blur_err = 0.0
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
    after = counts()
    launched = {k: after[k] - before[k] for k in ("blur4", "blur4_vector")}
    want_vector = sum(s[3] % 4 == 0 and not offset for s, _, _, offset in blur_cases)
    if launched != {"blur4": len(blur_cases), "blur4_vector": want_vector}:
        fail(f"blur4 launched {launched}, want {len(blur_cases)} with {want_vector} "
             "of them float4")

    fused_err = 0.0
    before = counts()
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
    after = counts()
    launched = {k: after[k] - before[k] for k in ("fused_noise_bias_lrelu",
                                                    "fused_noise_bias_lrelu_vector")}
    if set(launched.values()) != {len(fused_cases)}:
        fail(f"fused_noise_bias_lrelu launched {launched}, want {len(fused_cases)}, all with "
             "the 16-byte body")

    ms_err = 0.0
    for shape in ms_shapes:
        g_in = torch.randn(shape, generator=rng, device=dev)
        out = torch.randn(shape, generator=rng, device=dev)
        out.view(-1)[:3] = 0.0  # the mask is 1 at exactly 0, as in JAX
        got, want = masked_scale(g_in, out), masked_scale_plain(g_in, out)
        torch.cuda.synchronize()
        err, tol = (got - want).abs().max().item(), 1e-6 * want.abs().max().item()
        if not err <= tol:
            fail(f"masked_scale {shape}: max_abs_err {err} > tol {tol}")
        ms_err = max(ms_err, err)
    return blur_err, fused_err, ms_err


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


def hold_backward(blur_cases, epilogue_cases, rng):
    """The first and second order of blur4 (asymmetric taps) over (shape,
    pad, gain, misaligned view) cases, and of the epilogue over (shape, noise
    batch, noise needs a gradient) cases, against the plain versions to 1e-5
    of their largest values (``twin``); x, the bias and the noise weight
    always need a gradient. Each case must launch blur4's backward or
    masked_scale at least twice. Returns the two largest relative errors."""
    from content_aware_gan_compression_torch.ops.cuda import (
        blur4, blur4_plain, correlation_taps, counts, fused_noise_bias_lrelu,
        fused_noise_bias_lrelu_plain)

    dev = rng.device
    k_asym = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120  # flip != itself
    before = counts()
    blur_err = 0.0
    for shape, pad, gain, offset in blur_cases:
        # the view goes in inside the function: twin() copies its inputs
        # into fresh (aligned) tensors
        x = torch.randn(shape, generator=rng, device=dev, requires_grad=True)
        view = misaligned if offset else (lambda t: t)
        err = twin(lambda x: blur4(view(x), k_asym, pad, gain),
                   lambda x: blur4_plain(view(x), correlation_taps(k_asym, gain), pad), [x])
        if not err <= 1e-5:
            fail(f"blur4 backward {shape} pad {pad}: relative error {err} > 1e-5")
        blur_err = max(blur_err, err)
    fused_err = 0.0
    for shape, noise_batch, noise_grad in epilogue_cases:
        args = [torch.randn(shape, generator=rng, device=dev),
                torch.randn((noise_batch, *shape[1:3], 1), generator=rng, device=dev),
                0.5 * torch.randn(shape[3], generator=rng, device=dev),
                torch.tensor([0.7], device=dev)]
        for i, a in enumerate(args):
            a.requires_grad_(i != 1 or noise_grad)
        err = twin(fused_noise_bias_lrelu, fused_noise_bias_lrelu_plain, args)
        if not err <= 1e-5:
            fail(f"epilogue backward {shape}, noise batch {noise_batch}, noise gradient "
                 f"{noise_grad}: relative error {err} > 1e-5")
        fused_err = max(fused_err, err)
    torch.cuda.synchronize()
    after = counts()
    if (after["blur4_backward"] - before["blur4_backward"] < 2 * len(blur_cases)
            or after["masked_scale"] - before["masked_scale"] < 2 * len(epilogue_cases)):
        fail(f"the backward checks did not go through the kernels: {before} -> {after}")
    return blur_err, fused_err


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


class FixedParse(torch.nn.Module):
    """Stands in for BiSeNet in a Trainer: head-0 logits one-hot in a given
    class map, so that runs in other precisions mask with the same classes."""

    def __init__(self, class_map):
        super().__init__()
        self.register_buffer("one_hot", torch.nn.functional.one_hot(class_map, 19))

    def forward(self, x, data_format="NCHW", heads=1):
        logits = self.one_hot.to(x.dtype)
        return (logits if data_format == "NHWC" else logits.permute(0, 3, 1, 2),)


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


def train_window(trainer, reals, mpl, window=range(16, 32), profile=True):
    """Iterations/s, host ms per iteration and peak memory over ``window``
    (by default 16-31: R1 at 16, path length at 16, 20, 24, 28) after two
    warm-up iterations; then, with ``profile``, where its device time goes:
    one iteration of each kind in it (with R1 and path length, with path
    length alone, with neither; the first of each) under the profiler,
    whose host-side processing takes seconds per iteration, weighted by how
    many of that kind the window holds. Returns (dict, the running mean
    path length)."""
    cfg = trainer.cfg
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
    if not profile:
        out["device_time"] = "not measured: the window is not profiled"
        return out, mpl
    kinds = {}  # (R1, path length) -> [its first iteration, its count]
    for it in window:
        kinds.setdefault((it % cfg.d_reg_freq == 0, it % cfg.g_reg_freq == 0), [it, 0])[1] += 1
    state = {"mpl": mpl}
    parts = []
    for it, count in kinds.values():
        def one(_, it=it):
            _, state["mpl"] = trainer.step(it, reals[it % 4], state["mpl"])
        parts.append((*profile_kernels(one, 1), 1, count))
    out["device_time"] = device_time(parts)
    out["device_time_weights"] = {f"iteration {it}": count for it, count in kinds.values()}
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
    three evaluation CLIs, and the rates.
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

    # -- 12. eval_cuda_vs_cpu: the first FID batch and 4 PPL pairs, TF32 off;
    # the CPU's side in a thread beside phase 13 (CPU work only) -------------------
    gen = torch.Generator(dev).manual_seed(0)  # replays the stream's first batch
    z = torch.randn(FID_BATCH, g.config.style_dim, generator=gen, device=dev)
    with torch.inference_mode():
        img = g([z], generator=gen)
        on_card = inc(img, normalize_input=False).cpu().numpy()
    inc_cpu = copy.deepcopy(inc).to("cpu")
    g_cpu = copy.deepcopy(g).to("cpu")
    lpips_cpu = copy.deepcopy(lpips).to("cpu")
    crng = torch.Generator().manual_seed(3)
    z = torch.randn(8, g.config.style_dim, generator=crng)
    t = torch.rand(4, generator=crng)
    noise = g_cpu.make_noise(8, crng)

    def on_the_cpu(img, z, t, noise):
        with torch.inference_mode():
            features = inc_cpu(img, normalize_input=False).numpy()
        return features, _ppl_batch(g_cpu, lpips_cpu, z, t, 1e-4, noise=noise).numpy()
    cpu_side = beside(on_the_cpu, img.cpu(), z, t, noise)
    d_card = _ppl_batch(g, lpips, z.to(dev), t.to(dev), 1e-4,
                        noise=[n.to(dev) for n in noise]).cpu().numpy()
    replay_err = float(np.abs(on_card - feats[:FID_BATCH]).max())

    # -- 13. eval_cli: the three CLIs on seeded files ----------------------------
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
    detail("eval_cli", **cli, inception="width 1/8, seeded, pytorch-fid schema",
           real="512 seeded uint8 images at 256px")
    if not (np.isfinite(cli["fid"]) and cli["fid"] > 0 and np.isfinite(cli["ppl"])
            and cli["ppl"] >= 0):
        fail(f"eval CLIs: {cli}")
    shutil.rmtree(work)

    # -- 12, its CPU side joined -------------------------------------------------
    on_cpu, d_cpu = cpu_side.result()
    feat_err = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    swapped = feats.copy()
    swapped[:FID_BATCH] = on_cpu
    swap_fid, _ = fid_quietly(calc_fid, feature_stats(swapped), stats)
    ppl_err = float(np.abs(d_card - d_cpu).max() / np.abs(d_cpu).max())
    detail("eval_cuda_vs_cpu", tf32=False, features_images=FID_BATCH,
           features_max_rel_err=feat_err, features_tolerance="1e-3 of the CPU's max |feature|",
           features_vs_stream_max_abs_diff=replay_err,
           fid_stream_with_cpu_batch_vs_stream=swap_fid,
           fid_tolerance="below 1e-3 of the FID between two streams",
           ppl_pairs=4, ppl_card=d_card.tolist(), ppl_cpu=d_cpu.tolist(), ppl_max_rel_err=ppl_err,
           ppl_tolerance="5e-2 of the CPU's largest distance (eps 1e-4: the pair's images "
                         "differ by about 1e-4)", beside="eval_cli")
    if not feat_err <= 1e-3 or not abs(swap_fid) <= 1e-3 * other_fid or not ppl_err <= 5e-2:
        fail(f"evaluation on the card vs the CPU: features {feat_err}, FID {swap_fid}, "
             f"PPL {ppl_err}")
    del g_cpu, lpips_cpu, inc_cpu, img

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

    # -- 17. prune_cuda_vs_cpu: 64px, batch 4, against float64; beside phase 18 --
    prune_check = beside(deterministic(prune_vs_float64), dev)

    # -- 18. prune_cli: the prune CLI on a seeded checkpoint ----------------------
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
    detail("prune_cli", **{k: {kk: vv for kk, vv in v.items() if kk != "npz"}
                           for k, v in cli.items()},
           cut=f"{PRUNE_CLI_SAMPLES} samples of prune.py's 400, for time")
    detail("prune_cuda_vs_cpu", size=64, batch=4, tf32=False, cudnn_deterministic=True,
           **prune_check.result(), beside="prune_cli",
           measure="per layer, largest |a - float64| / max|float64| of the scores",
           tolerance="card <= 2 * cpu + 1e-4")
    shutil.rmtree(work)
    del parser
    return launches


# sparsity baseline: train_sparsity.py's defaults where they matter (eta
# 1e-5, Global_Number 588, l1-style, VGG percept 3, KD-L1 0, Intermediate,
# 9 samples), from the full-width generator; SparsityTrainer.run over iterations
# 0-5 with the prune event after iteration 3; the CLI over 4 iterations
SPARSITY_OPTS = dict(sparsity_eta=1e-5, model_prune_freq=3, num_rmve_channel=588,
                     prune_metric="l1-style", pruning_mode="Global_Number",
                     kd_percept_mode="VGG")
SPARSITY_ITERS = 6
# projector: get_projected_image's defaults cut from 800 iterations
PROJECT_ADAM_ITERS = 50
PROJECT_LBFGS_ITERS = 10
PROJECT_CLI_ITERS = 10


def student_lanes(net_shape, lanes=4):
    """How many of a generator's up-blurs take 16-byte lanes: those whose
    width (the up conv's output) is a multiple of ``lanes`` (4 float32, 8
    bfloat16)."""
    return sum(c % lanes == 0 for c in [s[3] for s in student_blur_shapes(1, net_shape)])


def sparse_phase_launches(log_size, net_shape):
    """``train_phase_launches`` with the student at ``net_shape``: its blurs
    take float4 lanes where its widths allow. The student's blur passes are 1
    in d (forward), 2 in g (forward, backward) and 4 in g_reg (forward, the
    path-length grad, its backward and back through the forward)."""
    return train_phase_launches(log_size, student_vector=student_lanes(net_shape))


def sparsity_config(size, batch, ckpt, cache, **kw):
    """The sparsity CLI's TrainConfig: the checkpoint as student and
    teacher, KD-L1 off, the percept term at 3, Intermediate, 9 samples."""
    from content_aware_gan_compression_torch.train import TrainConfig

    base = dict(data_folder=cache, generated_img_size=size, batch_size=batch, ckpt=ckpt,
                teacher=ckpt, kd_l1_lambda=0.0, kd_lpips_lambda=3.0, kd_mode="Intermediate",
                content_aware_KD=False, val_sample_num=9, val_sample_freq=1000,
                model_save_freq=100000)
    return TrainConfig(**{**base, **kw})


def sparsity_vs_float64(work, dev):
    """One sparse G step at 64px, batch 4, full width, lr 0, with KD-L1
    (weight 1), the VGG term of a width-0.25 seeded LPIPS and eta 1e-2, on
    the card and on the CPU, each against the CPU in float64 (phase 7's
    bound: card <= 2 * cpu + 1e-4, losses and G's gradients). Runs under
    the caller's cuDNN flags (deterministic, TF32 off)."""
    from content_aware_gan_compression_torch.models import Generator, GeneratorConfig
    from content_aware_gan_compression_torch.train.sparsity import SparsityTrainer
    from content_aware_gan_compression_torch.utils import save_checkpoint

    g64 = Generator(GeneratorConfig(size=64), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    randomize_epilogues(g64, 1)
    ckpt = os.path.join(work, "full64.npz")
    save_checkpoint(ckpt, {"g": g64.state_dict(), "g_ema": g64.state_dict()})
    cfg = sparsity_config(64, 4, ckpt, "", kd_l1_lambda=1.0, init_lr=0.0)
    opts = {**SPARSITY_OPTS, "sparsity_eta": 1e-2}
    lp = seeded_lpips(0.25).state_dict()
    runs = {key: SparsityTrainer(cfg, opts, device=d, lpips_params=lp)
            for key, d in (("cpu", "cpu"), ("card", dev), ("f64", "cpu"))}
    for module in (runs["f64"].g, runs["f64"].d, runs["f64"].teacher, runs["f64"].lpips):
        module.double()
    draws = runs["cpu"].draw(0)["g"]
    results = {}
    for key, tr in runs.items():
        d = to_device(draws, tr.device)
        if key == "f64":
            d = {k: ([t.double() for t in v] if isinstance(v, list)
                     else v.double() if v.is_floating_point() else v) for k, v in d.items()}
        metrics = tr.g_phase(d)
        results[key] = {"losses": {k: v.item() for k, v in metrics.items()},
                        "grads": {n: p.grad.detach().cpu().double()
                                  for n, p in tr.g.named_parameters()}}

    def distance(key):
        losses = max(abs(v - results["f64"]["losses"][k])
                     / max(abs(results["f64"]["losses"][k]), 1e-6)
                     for k, v in results[key]["losses"].items())
        grads = max(max_rel_err(results[key]["grads"][n], w)
                    for n, w in results["f64"]["grads"].items())
        return {"losses": losses, "g": grads}

    card_err, cpu_err = distance("card"), distance("cpu")
    out = {"card_vs_float64": card_err, "cpu_vs_float64": cpu_err,
           "losses_float64": results["f64"]["losses"]}
    bad = {k: (card_err[k], cpu_err[k]) for k in card_err
           if not card_err[k] <= 2 * cpu_err[k] + 1e-4}
    if bad:
        fail(f"the sparse G step on the card vs float64 on the CPU: {bad}")
    if not all(results["f64"]["losses"][k] > 0 for k in ("sparse", "kd_percept_loss")):
        fail(f"64px sparse step: a term is not > 0: {results['f64']['losses']}")
    return out


def sparsity_phases(g, dev, card, work):
    """The sparsity baseline at 256px from the full-width generator ``g``:
    SparsityTrainer.run with a prune event and its launches per phase, the rates
    before and after a prune event, one sparse G step on the card and the
    CPU against float64, and the CLI. Returns the kernels line's launch
    counts."""
    from content_aware_gan_compression_torch.models import default_net_shape
    from content_aware_gan_compression_torch.ops.cuda import lane_width, reset_counts
    from content_aware_gan_compression_torch.train.sparsity import SparsityTrainer
    from content_aware_gan_compression_torch.utils import (
        ExperimentLogger, load_checkpoint, pytree_to_torch_state_dict, save_checkpoint)
    from content_aware_gan_compression_torch.utils.calculators import (
        GENERATOR_FLOPS_256PX, styled_conv_flops)
    from content_aware_gan_compression_torch.models import net_shape_from_params

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    full_shape = default_net_shape(SIZE)
    log_size = int(np.log2(SIZE))
    ckpt = os.path.join(work, "g256_full.npz")
    save_checkpoint(ckpt, {"g": g.state_dict(), "g_ema": g.state_dict()},
                    metadata={"size": SIZE})
    cache = os.path.join(work, "ffhq256_seeded.npy")
    np.save(cache, np.random.RandomState(6).randint(0, 256, (32, SIZE, SIZE, 3), dtype=np.uint8))
    lpips = seeded_lpips()
    torch.backends.cudnn.allow_tf32 = False

    # -- 19. sparsity_path: the sparse run, iterations 0-5, prune after 3 --------
    trainer = SparsityTrainer(sparsity_config(SIZE, BATCH, ckpt, cache), SPARSITY_OPTS,
                              device=dev, lpips_params=lpips)
    logger = ExperimentLogger(work, name="sparsity")
    phases = []
    reset_counts()
    t0 = time.time()
    trainer.run(max_iters=SPARSITY_ITERS, logger=logger, phase_hook=phase_counter(phases))
    torch.cuda.synchronize()
    path_s = time.time() - t0
    logger.close()
    new_shape = tuple(trainer.g.config.net_shape)
    keys = ("blur4", "blur4_backward", "blur4_vector", "fused_noise_bias_lrelu",
            "fused_noise_bias_lrelu_vector", "masked_scale")
    want_before = sparse_phase_launches(log_size, full_shape)
    want_after = sparse_phase_launches(log_size, new_shape)
    names = [n for n, _ in phases]
    prune_at = names.index("prune") if "prune" in names else len(names)
    launches = {"before_prune": dict.fromkeys(keys, 0), "after_prune": dict.fromkeys(keys, 0)}
    bad = []
    for i, (name, c) in enumerate(phases):
        got = {k: c[k] for k in keys}
        if name == "sample":  # 9 samples of g_ema at full width
            want = {**dict.fromkeys(keys, 0), "blur4": log_size - 2,
                    "blur4_vector": log_size - 2, "fused_noise_bias_lrelu": 2 * log_size - 3,
                    "fused_noise_bias_lrelu_vector": 2 * log_size - 3}
        elif name == "prune":  # l1-style scores the modulations only
            want = dict.fromkeys(keys, 0)
        else:
            want = (want_before if i < prune_at else want_after)[name]
        if got != want:
            bad.append((i, name, got, want))
        side = "before_prune" if i < prune_at else "after_prune"
        for k in keys:
            launches[side][k] += got[k]
    g_first = next(c for n, c in phases if n == "g")
    same_as_train = {k: g_first[k] for k in keys if k != "blur4_vector"} == {
        k: train_phase_launches(log_size)["g"][k] for k in keys if k != "blur4_vector"}
    with open(next(os.path.join(logger.exp_dir, f) for f in os.listdir(logger.exp_dir)
                   if f.endswith(".out"))) as f:
        log = f.read()
    with open(os.path.join(logger.exp_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "d" in r]
    pct = styled_conv_flops(new_shape, False) / GENERATOR_FLOPS_256PX * 100.0
    removed = sum(full_shape) - sum(new_shape)
    lanes_after = [lane_width(s[3]) for s in student_blur_shapes(BATCH, new_shape)]
    detail("sparsity_path", size=SIZE, batch=BATCH, path_batch=PATH_BATCH, opts=SPARSITY_OPTS,
           iterations=SPARSITY_ITERS, seconds=round(path_s, 3), phases=names,
           launches=launches, bad_phases=bad, g_phase_same_as_train_g=same_as_train,
           net_shape_after=list(new_shape), removed=removed, flops_pct=pct,
           blur4_lanes_after_prune=lanes_after,
           metrics=[{k: r[k] for k in ("iter", "g", "sparse", "kd_percept_loss", "d")}
                    for r in steps], tf32=False,
           lpips="LPIPS-VGG16, full width, seed 5 (its VGG trunk on raw images)")
    if bad or not same_as_train:
        fail(f"sparsity_path launches: {bad}")
    if (names.count("prune") != 1 or names[prune_at - 1] != "ema"
            or names[:prune_at].count("ema") != SPARSITY_OPTS["model_prune_freq"] + 1):
        fail(f"sparsity_path: the prune event did not follow iteration 3: {names}")
    if removed < SPARSITY_OPTS["num_rmve_channel"] + 1 or f"FLOPs %: {round(pct, 2)}" not in log:
        fail(f"sparsity_path: removed {removed}, FLOPs % {pct} (log has it: "
             f"{f'FLOPs %: {round(pct, 2)}' in log})")
    if ([r["iter"] for r in steps] != list(range(SPARSITY_ITERS))
            or not all(np.isfinite(v) for r in steps for v in r.values())
            or not all(r["sparse"] > 0 and r["kd_percept_loss"] > 0 for r in steps)):
        fail(f"sparsity_path metrics: {steps}")
    del trainer

    # -- 20. sparsity_rate: windows before and after a prune event ----------------
    rate = {}
    trainer = SparsityTrainer(sparsity_config(SIZE, BATCH, ckpt, cache), SPARSITY_OPTS,
                              device=dev, lpips_params=lpips)
    reals = np.random.RandomState(7).randint(0, 256, (4, BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    window = range(16, 24)
    for side in ("before_prune", "after_prune"):
        if side == "after_prune":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shape_after, pct_after = trainer.prune_in_training()
            torch.cuda.synchronize()
            rate["prune_event_s"] = time.perf_counter() - t0
            rate["net_shape_after"] = list(shape_after)
        # under PyTorch's defaults only (the TF32-off windows made room for
        # path_1024; PERF.md keeps their last numbers)
        torch.backends.cudnn.allow_tf32 = True
        rate[f"{side}_pytorch_defaults"], _ = train_window(
            trainer, reals, torch.zeros((), device=dev), window,
            profile=side == "after_prune")
    torch.backends.cudnn.allow_tf32 = False
    detail("sparsity_rate", size=SIZE, batch=BATCH, path_batch=PATH_BATCH, card=card,
           window="iterations 16-23: 8 D and sparse G steps, 1 R1, 2 path length; "
                  "device_time: iterations 16 (R1, path length), 17 (neither) and 20 (path "
                  "length) profiled, weighted 1, 6 and 1", **rate,
           note="prune_event_s: host clock around prune_in_training (500 latents scored "
                "with l1-style, the surgery of g and g_ema, both optimizers rebuilt); "
                "pytorch_defaults: cuDNN TF32 on, matmul TF32 off")
    del trainer

    # -- 21. sparsity_cuda_vs_cpu: one sparse G step at 64px against float64;
    # beside phase 22 ------------------------------------------------------------
    sparse_check = beside(deterministic(sparsity_vs_float64), work, dev)

    # -- 22. sparsity_cli: train_sparsity over 4 iterations, prune after 2 ---------
    vgg_file, lins_file = write_aux_files(work, lpips)
    root = os.path.join(work, "cli_sparsity")
    t0 = time.time()
    proc = subprocess.run([
        sys.executable, "-m", "content_aware_gan_compression_torch.train_sparsity", "--path",
        cache, "--size", str(SIZE), "--ckpt", ckpt, "--teacher_ckpt", ckpt, "--iter", "4",
        "--model_prune_freq", "2", "--model_save_freq", "3", "--lpips_vgg_ckpt", vgg_file,
        "--lpips_lins_ckpt", lins_file, "--exp_root", root], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"train_sparsity CLI rc {proc.returncode}: {proc.stderr[-3000:]}")
    (exp,) = [os.path.join(root, d) for d in os.listdir(root) if d.startswith("Exp_")]
    with open(next(os.path.join(exp, f) for f in os.listdir(exp) if f.endswith(".out"))) as f:
        log = f.read()
    shape_line = [ln for ln in log.splitlines() if ln.startswith("Shape: ")]
    flops_line = [ln for ln in log.splitlines() if ln.startswith("FLOPs %: ")]
    cli_shape = tuple(json.loads(shape_line[0][len("Shape: "):])) if shape_line else ()
    trees, meta = load_checkpoint(os.path.join(exp, "ckpt", "000003.npz"))
    saved_shape = tuple(net_shape_from_params(pytree_to_torch_state_dict(trees["g_ema"])))
    cli_pct = round(styled_conv_flops(cli_shape, False) / GENERATOR_FLOPS_256PX * 100.0, 2) \
        if cli_shape else None
    cli = {"seconds": round(time.time() - t0, 3), "shape": list(cli_shape),
           "flops_line": flops_line, "saved_net_shape": list(saved_shape),
           "saved_trees": sorted(trees), "metadata_iter": meta.get("iter"),
           "warnings": [ln for ln in proc.stdout.splitlines() if "WARNING" in ln]}
    detail("sparsity_cli", **cli, args="--iter 4 --model_prune_freq 2 --model_save_freq 3, "
           "the CLI's defaults otherwise (batch 16, Global_Number 588, l1-style, VGG 3)")
    if (len(shape_line) != 1 or flops_line != [f"FLOPs %: {cli_pct}"]
            or saved_shape != cli_shape or meta.get("iter") != 3
            or sum(full_shape) - sum(cli_shape) < SPARSITY_OPTS["num_rmve_channel"] + 1
            or sorted(trees) != ["d", "d_optim", "g", "g_ema", "g_optim"] or cli["warnings"]):
        fail(f"train_sparsity CLI: {cli}")
    detail("sparsity_cuda_vs_cpu", size=64, batch=4, tf32=False, lr=0.0,
           cudnn_deterministic=True, **sparse_check.result(), beside="sparsity_cli",
           measure="largest |a-b| / max|float64| over G's parameter gradients; losses relative",
           tolerance="card <= 2 * cpu + 1e-4")
    shutil.rmtree(work)

    # -- 22, continued: the kernels against their plain versions at the pruned
    # widths ----------------------------------------------------------------
    # the student after each prune event above trains at widths that are
    # mostly not multiples of 4: its up-blurs and epilogues at batch 16 and
    # at the path batch, forward and backward (no noise gradient in training)
    rng = torch.Generator(dev).manual_seed(13)
    held = {}
    for shape in dict.fromkeys((new_shape, tuple(rate["net_shape_after"]), cli_shape)):
        blurs = student_blur_shapes(BATCH, shape) + student_blur_shapes(PATH_BATCH, shape)
        epilogues = student_epilogue_shapes(BATCH, shape) + student_epilogue_shapes(
            PATH_BATCH, shape)
        errs = hold_forward([(s, (1, 1), 4.0, False) for s in blurs],
                            [(s, s[0]) for s in epilogues], epilogues, rng)
        errs += hold_backward([(s, (1, 1), 4.0, False) for s in blurs],
                              [(s, s[0], False) for s in epilogues], rng)
        held[str(list(shape))] = dict(zip(
            ("blur4_max_abs_err", "epilogue_max_abs_err", "masked_scale_max_abs_err",
             "blur4_backward_max_rel_err", "epilogue_backward_max_rel_err"), errs))
    detail("sparsity_widths_vs_plain", batches=[BATCH, PATH_BATCH], net_shapes=held,
           tolerance="forward: blur4 1e-5 * max|x|, epilogue and masked_scale 1e-6 * "
                     "max|plain|; backward: 1e-5 of the plain version's largest value, first "
                     "and second order")
    return launches


def projector_phases(g, dev, card, work):
    """The projector at 256px on the full-width generator ``g`` (its noise
    weights drawn, so the noise gradient counts) with a full-width seeded
    LPIPS: Adam and L-BFGS on a target that is one of g's samples, launches
    per evaluation, the rates with TF32 off and under the defaults, and the
    CLI. Returns the kernels line's launch counts."""
    import importlib.util

    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts
    from content_aware_gan_compression_torch.projector import (
        image_projector, psnr, to_uint8_image)
    from content_aware_gan_compression_torch.utils import save_checkpoint
    from content_aware_gan_compression_torch.utils.logging import read_png, write_png

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    lpips = seeded_lpips().to(dev).requires_grad_(False).eval()
    pick = torch.Generator(dev).manual_seed(11)
    with torch.no_grad():
        target = g([torch.randn(1, g.config.style_dim, generator=pick, device=dev)],
                   noise=g.make_noise(1, pick))
    target_uint8 = to_uint8_image(target[0].cpu().numpy())
    keys = ("blur4", "blur4_backward", "blur4_vector", "fused_noise_bias_lrelu", "masked_scale")
    k, e = int(np.log2(SIZE)) - 2, 2 * int(np.log2(SIZE)) - 3

    # -- 23. projector_path: Adam and L-BFGS, TF32 off and the defaults -----------
    runs, launches, bad = {}, {}, []
    for label, tf32 in (("tf32_off", False), ("pytorch_defaults", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        for opt, iters in (("Adam", PROJECT_ADAM_ITERS), ("LBFGS", PROJECT_LBFGS_ITERS)):
            info = {}
            noise0 = g.make_noise(1, torch.Generator(dev).manual_seed(12))
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _, noises, losses = image_projector(
                g, target, lpips=lpips, generator=torch.Generator(dev).manual_seed(0),
                noise=noise0, opt=opt, num_iters=iters, avg_w_samples=4096, info=info)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            c = {kk: counts()[kk] for kk in keys}
            n_eval = info["evaluations"]
            # every evaluation a forward and a backward; one more forward for
            # the output; full width: float4 lanes throughout
            want = {"blur4": k * (n_eval + 1), "blur4_backward": k * n_eval,
                    "blur4_vector": k * (2 * n_eval + 1),
                    "fused_noise_bias_lrelu": e * (n_eval + 1), "masked_scale": e * n_eval}
            if c != want:
                bad.append((label, opt, c, want))
            noise_moved = max((a - b).abs().max().item() for a, b in zip(noises, noise0))
            run = {"seconds": seconds, "iterations": iters, "evaluations": n_eval,
                   "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
                   "psnr": psnr(to_uint8_image(out[0].cpu().numpy()), target_uint8),
                   "noise_moved": noise_moved, "launches": c}
            if opt == "Adam":
                run["iterations_per_s"] = iters / seconds
            else:
                run["seconds_per_iteration"] = seconds / iters
                run["evaluations_per_iteration"] = (n_eval - 1) / iters
                run["stepsizes"] = [round(s, 6) for s in info["stepsizes"]]
            runs[f"{opt}_{label}"] = run
            if label == "tf32_off":
                launches[opt] = c
            if not (losses[-1] < losses[0] and np.isfinite(losses).all() and noise_moved > 0):
                fail(f"projector {opt} ({label}): losses {losses[0]} -> {losses[-1]}, "
                     f"noise moved {noise_moved}")
        # where an evaluation's device time goes: 5 Adam iterations
        runs[f"Adam_{label}"]["device_time_5_iterations"] = profile_forward(
            lambda i: image_projector(g, target, lpips=lpips, noise=noise0, opt="Adam",
                                      num_iters=5, avg_w_samples=4096,
                                      generator=torch.Generator(dev).manual_seed(i)),
            iters=1, inference=False)
    torch.backends.cudnn.allow_tf32 = False
    detail("projector_path", size=SIZE, batch=1, avg_w_samples=4096, optimize_noise=True,
           **runs, bad_launches=bad, card=card,
           lpips="LPIPS-VGG16, full width, seed 5; the target is one of g's samples",
           note="seconds: host clock around image_projector (the mean latent, the loop and "
                "the output's forward); device_time: the profiler over one 5-iteration Adam "
                "run; pytorch_defaults: cuDNN TF32 on, matmul TF32 off")
    if bad:
        fail(f"projector_path launches: {bad}")

    # -- 24. projector_cli: get_projected_image on a PNG write_png wrote ---------
    ckpt = os.path.join(work, "g256.npz")
    save_checkpoint(ckpt, {"g_ema": g.state_dict()}, metadata={"size": SIZE})
    image_file = os.path.join(work, "target.png")
    write_png(image_file, target_uint8)
    vgg_file, lins_file = write_aux_files(work, lpips)
    side_file = os.path.join(work, "side.png")
    t0 = time.time()
    proc = subprocess.run([
        sys.executable, "-m", "content_aware_gan_compression_torch.get_projected_image",
        "--ckpt", ckpt, "--image_file", image_file, "--num_iters", str(PROJECT_CLI_ITERS),
        "--lpips_vgg_ckpt", vgg_file, "--lpips_lins_ckpt", lins_file, "--out", side_file],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"get_projected_image CLI rc {proc.returncode}: {proc.stderr[-3000:]}")
    side = read_png(side_file)
    printed = [ln for ln in proc.stdout.splitlines() if "Score" in ln or "WARNING" in ln]
    cli = {"seconds": round(time.time() - t0, 3), "printed": printed,
           "png": list(side.shape), "left_is_target": bool((side[:, :SIZE] == target_uint8).all()),
           "reader": "Pillow" if importlib.util.find_spec("PIL") else "read_png (no Pillow)"}
    detail("projector_cli", **cli, args=f"--num_iters {PROJECT_CLI_ITERS}, L-BFGS")
    if (side.shape != (SIZE, 2 * SIZE, 3) or not cli["left_is_target"]
            or not any(ln.startswith("PSNR Score: ") for ln in printed)
            or not any(ln.startswith("LPIPS Score: ") for ln in printed)
            or any("WARNING" in ln for ln in printed)):
        fail(f"get_projected_image CLI: {cli}")
    shutil.rmtree(work)
    return launches


def train_vs_float64(work, dev, objectives=("kd_l1", "full_kd"), compute_dtype="float32",
                     slack=1e-4, f64_runs=None):
    """One iteration at 64px, batch 4, TF32 off, on the card and on the CPU,
    each held against the CPU in float64, per phase; fails on a phase where
    the card is further from float64 than the bound. Returns the distances.
    ``compute_dtype`` is the card's and the CPU's steps' type (float64 runs
    in float64 either way); ``slack`` the bound's constant term. In
    bfloat16 a phase's distance is that of its whole gradient (|a - b| /
    |b| over all parameters as one vector): the largest error of the worst
    tensor is near 1 there on both devices, the noise of a few tensors
    whose float64 gradient is small. (The CPU's bfloat16 convolution,
    oneDNN's, takes R1's second order further from float64 than the same
    runs without it, tests/test_torch_bf16_steps.py; without it the CPU
    takes minutes here.)

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
    give the same result in every run.

    ``f64_runs``, a dict the caller keeps between calls, holds each
    objective's float64 run (its draws, parser seed, class map, losses and
    gradients); a later call whose float64 draws and parser are the same
    takes the run from there instead of computing it again: phase 7b's
    float64 iteration is phase 7's full_kd one."""
    from content_aware_gan_compression_torch.train import Trainer

    f64_runs = {} if f64_runs is None else f64_runs

    s_small, t_small = write_train_checkpoints(work, 64)
    real64 = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (4, 64, 64, 3), dtype=np.uint8)).float() / 127.5 - 1.0
    trained = {"d": "d", "d_reg": "d", "g": "g", "g_reg": "g"}
    small_checks, kd_l1_results = {}, None
    for objective in objectives:
        # lr 0: Adam's first step is about lr * sign(g), so a weight whose
        # gradient is near 0 would move apart on the two devices and every
        # later phase would start from other weights; with lr 0 each phase
        # compares the same computation on the same weights
        cfg64 = train_config(64, 4, s_small, t_small, objective, init_lr=0.0)
        cfg = dataclasses.replace(cfg64, compute_dtype=compute_dtype)
        aux = {"lpips_params": seeded_lpips(0.25).state_dict()} if objective == "full_kd" else {}
        runs = {"cpu": Trainer(cfg, device="cpu", **aux),
                "card": Trainer(cfg, device=dev, **aux)}
        draws = runs["cpu"].draw(0)
        f64_draws = to_float64(draws)
        kept = f64_runs.get(objective)
        if kept is not None and not same_tensors(kept["draws"], f64_draws):
            kept = None
        agree = parser64_seed = None
        if objective == "full_kd":
            from content_aware_gan_compression_torch.models import make_parse_fn
            from content_aware_gan_compression_torch.pruning import batch_img_parsing

            maps = {}
            for key in ("cpu", "f64", "card"):  # the parser is picked on the CPU's images
                if key == "f64" and kept is not None and kept["parser_seed"] == parser64_seed:
                    maps[key] = kept["map"]
                    continue
                if key == "f64":
                    kept = None
                    runs["f64"] = float64_trainer(Trainer, cfg64, aux)
                tr, g_draw = runs[key], to_device(
                    f64_draws["g"] if key == "f64" else draws["g"], runs[key].device)
                with torch.no_grad():
                    img = tr.teacher(g_draw["z"], inject_index=g_draw["inject_index"],
                                     noise=g_draw["teacher_noise"], output_format="NHWC")
                if key == "cpu":
                    parser64, parser64_seed, _ = pick_parser(img, width_scale=0.25)
                    continue
                net = copy.deepcopy(parser64).to(tr.device, img.dtype)
                maps[key] = batch_img_parsing(img, make_parse_fn(net, "NHWC", tr.dtype),
                                              "NHWC").cpu()
            agree = (maps["card"] == maps["f64"]).float().mean().item()
        if kept is None and "f64" not in runs:
            runs["f64"] = float64_trainer(Trainer, cfg64, aux)
        if objective == "full_kd":
            for tr in runs.values():
                tr.parser = FixedParse(maps["f64"]).to(tr.device)
        results = {} if kept is None else {"f64": kept["results"]}
        # D's two phases and the path length read nothing of the objective:
        # with lr 0 and the same draws full_kd's are kd_l1's to the last bit,
        # so after kd_l1 full_kd runs its G phase alone and takes the others
        g_only = objective == "full_kd" and kd_l1_results is not None
        for key, tr in runs.items():
            dtype = torch.float64 if key == "f64" else torch.float32
            store = results[key] = {}

            def hook(name, store=store, tr=tr):
                if name in trained:
                    store[name] = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                   .detach().cpu().double()
                                   for n, p in getattr(tr, trained[name]).named_parameters()}
            step_draws = to_device(f64_draws if key == "f64" else draws, tr.device)
            if g_only:
                metrics = {k: v.item() for k, v in tr.g_phase(step_draws["g"]).items()}
                hook("g")
                store.update({ph: kd_l1_results[key][ph] for ph in trained if ph != "g"})
                store["losses"] = {**{k: v for k, v in kd_l1_results[key]["losses"].items()
                                      if k not in metrics}, **metrics}
                continue
            metrics, _ = tr.step(0, real64.to(tr.device, dtype),
                                 torch.zeros((), device=tr.device, dtype=dtype),
                                 draws=step_draws, phase_hook=hook)
            store["losses"] = {k: v.item() for k, v in metrics.items()}
        if objective == "kd_l1":
            kd_l1_results = results
        f64_runs[objective] = {"draws": f64_draws, "parser_seed": parser64_seed,
                               "map": maps["f64"] if objective == "full_kd" else None,
                               "results": results["f64"]}

        def distance(key, results=results):
            losses = max(abs(v - results["f64"]["losses"][k])
                         / max(abs(results["f64"]["losses"][k]), 1e-6)
                         for k, v in results[key]["losses"].items())
            if compute_dtype == "bfloat16":
                grads = {ph: (sum(float((results[key][ph][n] - g).square().sum())
                                  for n, g in results["f64"][ph].items())
                              / sum(float(g.square().sum())
                                    for g in results["f64"][ph].values())) ** 0.5
                         for ph in trained}
            else:
                grads = {ph: max(max_rel_err(results[key][ph][n], g)
                                 for n, g in results["f64"][ph].items()) for ph in trained}
            return {"losses": losses, **grads}

        cpu_err, card_err = distance("cpu"), distance("card")
        small_checks[objective] = {"card_vs_float64": card_err, "cpu_vs_float64": cpu_err,
                                   "losses_float64": results["f64"]["losses"],
                                   "float64_run": "computed" if kept is None else
                                   "the same run as an earlier call's, kept",
                                   "phases_run": ["g"] if g_only else list(trained)}
        if agree is not None:
            small_checks[objective].update(
                parse_agreement_card_vs_float64=agree, parser_seed=parser64_seed,
                aux="LPIPS and BiSeNet widths scaled 0.25, seeded")
        bad = {k: (card_err[k], cpu_err[k]) for k in card_err
               if not card_err[k] <= 2 * cpu_err[k] + slack}
        if bad:
            fail(f"training ({objective}, {compute_dtype}) on the card vs float64 on the CPU: "
                 f"{bad}")
        if objective == "full_kd" and not results["f64"]["losses"]["kd_lpips_loss"] > 0:
            fail("64px full_kd: the LPIPS term is 0")
        del runs, results
    return small_checks


def float64_phases(work, dev):
    """Phases 7 and 7b: train_vs_float64 for both objectives in float32,
    then for full_kd in bfloat16 on phase 7's float64 run. Returns (7's
    distances, 7b's, 7b's seconds)."""
    f64_runs = {}
    small_checks = train_vs_float64(work, dev, f64_runs=f64_runs)
    t0 = time.time()
    bf16_checks = train_vs_float64(work, dev, ("full_kd",), "bfloat16", 1e-3, f64_runs)
    return small_checks, bf16_checks, round(time.time() - t0, 1)


def float64_trainer(Trainer, cfg64, aux):
    """The float64 reference of train_vs_float64: a Trainer on the CPU with
    every network in float64."""
    tr = Trainer(cfg64, device="cpu", **aux)
    for module in (tr.g, tr.d, tr.teacher, tr.lpips):
        if module is not None:
            module.double()
    return tr


def same_tensors(a, b):
    """Whether two nests of dicts, lists and tensors hold equal tensors."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same_tensors(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
    return a == b


# -- bfloat16 --------------------------------------------------------------------

BF16_EPS = 2.0 ** -7  # bfloat16's spacing in [1, 2)


@contextlib.contextmanager
def plain_routes():
    """The three wrappers take their plain versions on the card too, inside
    the same autograd Functions: the kernels' arithmetic swapped for the
    plain one, the backward's structure kept. No launch is counted."""
    import importlib

    from content_aware_gan_compression_torch.ops.cuda import (
        blur4_plain, fused_noise_bias_lrelu_plain, masked_scale_plain)

    mods = [importlib.import_module(f"content_aware_gan_compression_torch.ops.cuda.{m}")
            for m in ("blur4", "fused_noise_bias_lrelu", "masked_scale")]

    def plain_ms(g, out):
        return masked_scale_plain(g, out)
    plain_ms.grad_copies = 0
    saved = mods[0]._run, mods[1]._run, mods[2].masked_scale
    mods[0]._run = lambda x, taps, pad, backward: blur4_plain(x, taps, pad)
    mods[1]._run, mods[2].masked_scale = fused_noise_bias_lrelu_plain, plain_ms
    try:
        yield
    finally:
        mods[0]._run, mods[1]._run, mods[2].masked_scale = saved


def f32_up(t):
    return t.to(torch.promote_types(t.dtype, torch.float32))


def grads_bf16(fn, args):
    """``twin``'s d sum(f^3) and d ||d sum(f^3)||^2 for bfloat16: the cube
    and the squares around ``fn`` run in float32, so that two functions
    held against each other round only inside themselves."""
    xs = [a.detach().clone().requires_grad_(a.requires_grad) for a in args]
    wrt = [x for x in xs if x.requires_grad]
    grads = torch.autograd.grad(f32_up(fn(*xs)).pow(3).sum(), wrt, create_graph=True)
    second = torch.autograd.grad(sum(f32_up(t).pow(2).sum() for t in grads), wrt)
    return [t.detach().float() for t in (*grads, *second)]


def twin_bf16(grads_a, grads_b):
    """The largest error of each gradient relative to ``grads_b``'s
    largest value."""
    return max(max_rel_err(a, b) for a, b in zip(grads_a, grads_b))


def hold_bf16(blur_cases, fused_cases, ms_shapes, bw_blur_cases, epilogue_cases, rng):
    """Each kernel in bfloat16 against its plain version on the card, on
    bfloat16 inputs drawn from ``rng``. Forward: bit for bit (the kernels
    round where the plain versions do, once per output), with blur4's
    16-byte lanes where C % 8 == 0 and the view is aligned. Backward and
    double backward to 2^-7 of the plain version's largest value: blur4
    against autograd of its plain version; the epilogue against the same
    Function under ``plain_routes``, because its backward sums the rounded
    dx, as the JAX package's _bwd_vjp does, where autograd of the plain
    expression sums the unrounded one (that distance is reported too).
    Returns the largest errors."""
    from content_aware_gan_compression_torch.ops import make_kernel
    from content_aware_gan_compression_torch.ops.cuda import (
        blur4, blur4_plain, correlation_taps, counts, fused_noise_bias_lrelu,
        fused_noise_bias_lrelu_plain, masked_scale, masked_scale_plain, reset_counts)

    bf, dev = torch.bfloat16, rng.device
    k4 = make_kernel([1, 3, 3, 1])
    reset_counts()
    out = {"blur4": 0.0, "fused_noise_bias_lrelu": 0.0, "masked_scale": 0.0}
    for shape, pad, gain, offset in blur_cases:
        x = torch.randn(shape, generator=rng, device=dev).to(bf)
        if offset:
            x = misaligned(x)
        got, want = blur4(x, k4, pad, gain), blur4_plain(x, correlation_taps(k4, gain), pad)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != bf or got.shape != want.shape or err != 0.0:
            fail(f"bf16 blur4 {shape} pad {pad}: max_abs_err {err}, want bit for bit")
        out["blur4"] = max(out["blur4"], err)
    c = counts()
    want_vector = sum(s[3] % 8 == 0 and not offset for s, _, _, offset in blur_cases)
    if (c["blur4_bf16"], c["blur4_vector_bf16"]) != (len(blur_cases), want_vector):
        fail(f"bf16 blur4 launched {c}, want {len(blur_cases)} with {want_vector} 16-byte")
    for shape, noise_batch in fused_cases:
        x = torch.randn(shape, generator=rng, device=dev).to(bf)
        noise = torch.randn((noise_batch, *shape[1:3], 1), generator=rng, device=dev).to(bf)
        bias = (0.5 * torch.randn(shape[3], generator=rng, device=dev)).to(bf)
        nw = torch.tensor([0.7], device=dev).to(bf)
        got, want = (fused_noise_bias_lrelu(x, noise, bias, nw),
                     fused_noise_bias_lrelu_plain(x, noise, bias, nw))
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != bf or err != 0.0:
            fail(f"bf16 epilogue {shape}: max_abs_err {err}, want bit for bit")
    for shape in ms_shapes:
        g_in = torch.randn(shape, generator=rng, device=dev).to(bf)
        o = torch.randn(shape, generator=rng, device=dev).to(bf)
        o.view(-1)[:3] = 0.0
        got, want = masked_scale(g_in, o), masked_scale_plain(g_in, o)
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != bf or err != 0.0:
            fail(f"bf16 masked_scale {shape}: max_abs_err {err}, want bit for bit")
    c = counts()
    if (c["fused_noise_bias_lrelu_bf16"], c["fused_noise_bias_lrelu_vector_bf16"],
            c["masked_scale_bf16"]) != (len(fused_cases), len(fused_cases), len(ms_shapes)):
        fail(f"bf16 epilogue / masked_scale launches {c}, want every epilogue with the "
             "16-byte body")

    k_asym = torch.arange(16, dtype=torch.float32).reshape(4, 4) / 120
    bw = {"blur4": 0.0, "epilogue": 0.0, "epilogue_vs_autograd_of_plain": 0.0}
    reset_counts()
    for shape, pad, gain, offset in bw_blur_cases:
        x = torch.randn(shape, generator=rng, device=dev).to(bf).requires_grad_(True)
        view = misaligned if offset else (lambda t: t)
        err = twin_bf16(grads_bf16(lambda x: blur4(view(x), k_asym, pad, gain), [x]), grads_bf16(
            lambda x: blur4_plain(view(x), correlation_taps(k_asym, gain), pad), [x]))
        if not err <= BF16_EPS:
            fail(f"bf16 blur4 backward {shape} pad {pad}: relative error {err} > 2^-7")
        bw["blur4"] = max(bw["blur4"], err)
    for shape, noise_batch, noise_grad in epilogue_cases:
        args = [torch.randn(shape, generator=rng, device=dev).to(bf),
                torch.randn((noise_batch, *shape[1:3], 1), generator=rng, device=dev).to(bf),
                (0.5 * torch.randn(shape[3], generator=rng, device=dev)).to(bf),
                torch.tensor([0.7], device=dev).to(bf)]
        for i, a in enumerate(args):
            a.requires_grad_(i != 1 or noise_grad)
        with plain_routes():
            plain = grads_bf16(fused_noise_bias_lrelu, args)
        kernel = grads_bf16(fused_noise_bias_lrelu, args)
        err = twin_bf16(kernel, plain)
        if not err <= BF16_EPS:
            fail(f"bf16 epilogue backward {shape}, noise batch {noise_batch}, noise gradient "
                 f"{noise_grad}: relative error {err} > 2^-7")
        bw["epilogue"] = max(bw["epilogue"], err)
        bw["epilogue_vs_autograd_of_plain"] = max(
            bw["epilogue_vs_autograd_of_plain"],
            twin_bf16(kernel, grads_bf16(fused_noise_bias_lrelu_plain, args)))
    torch.cuda.synchronize()
    c = counts()
    if (c["blur4_backward_bf16"] < 2 * len(bw_blur_cases)
            or c["masked_scale_bf16"] < 2 * len(epilogue_cases)):
        fail(f"the bf16 backward checks did not go through the kernels: {c}")
    return out, bw


def bf16_times(rng, blur_shape, fused_shape, ms_shape):
    """The bfloat16 kernels' ms against their bytes bounds, their plain
    versions and, where one exists, one PyTorch call: F.conv2d depthwise on
    the channels-last bfloat16 view for blur4, aten.leaky_relu_backward in
    bfloat16 for masked_scale."""
    from content_aware_gan_compression_torch.bench_blur4 import blur4_bound, bound, time_ms
    from content_aware_gan_compression_torch.ops import make_kernel
    from content_aware_gan_compression_torch.ops.cuda import (
        blur4, blur4_plain, correlation_taps, fused_noise_bias_lrelu,
        fused_noise_bias_lrelu_plain, masked_scale, masked_scale_plain)

    bf, dev = torch.bfloat16, rng.device
    k4, gain, pad = make_kernel([1, 3, 3, 1]), 4.0, (1, 1)
    x = torch.randn(blur_shape, generator=rng, device=dev).to(bf)
    taps, c = correlation_taps(k4, gain), blur_shape[3]
    w_dw = (k4 * gain).flip(0, 1).reshape(1, 1, 4, 4).repeat(c, 1, 1, 1).to(dev, bf)
    x_nchw = x.permute(0, 3, 1, 2)
    t_bound, t_by = blur4_bound(blur_shape, pad, itemsize=2)
    times = {"blur4": {
        "shape": list(blur_shape), "pad": list(pad), "ms": time_ms(lambda: blur4(x, k4, pad, gain)),
        "plain_ms": time_ms(lambda: blur4_plain(x, taps, pad), iters=5),
        "bound_ms": t_bound, "bound_by": t_by,
        "library_ms": time_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_dw, padding=pad[0],
                                                                 groups=c))}}
    del x, x_nchw
    x = torch.randn(fused_shape, generator=rng, device=dev).to(bf)
    noise = torch.randn((*fused_shape[:3], 1), generator=rng, device=dev).to(bf)
    bias = (0.5 * torch.randn(fused_shape[3], generator=rng, device=dev)).to(bf)
    nw = torch.tensor([0.7], device=dev).to(bf)
    negatives = int((fused_noise_bias_lrelu_plain(x, noise, bias, nw) < 0).sum().item())
    f_bound, f_by = bound(2 * (2 * x.numel() + noise.numel() + fused_shape[3]),
                          3 * x.numel() + negatives + noise.numel())
    times["fused_noise_bias_lrelu"] = {
        "shape": list(fused_shape), "ms": time_ms(lambda: fused_noise_bias_lrelu(x, noise, bias, nw)),
        "plain_ms": time_ms(lambda: fused_noise_bias_lrelu_plain(x, noise, bias, nw), iters=5),
        "bound_ms": f_bound, "bound_by": f_by, "library_ms": None}
    del x, noise
    g_in = torch.randn(ms_shape, generator=rng, device=dev).to(bf)
    o = torch.randn(ms_shape, generator=rng, device=dev).to(bf)
    negatives = int((o < 0).sum().item())
    m_bound, m_by = bound(6 * o.numel(), 2 * o.numel() + negatives)
    times["masked_scale"] = {
        "shape": list(ms_shape), "ms": time_ms(lambda: masked_scale(g_in, o)),
        "plain_ms": time_ms(lambda: masked_scale_plain(g_in, o), iters=5),
        "bound_ms": m_bound, "bound_by": m_by,
        "library_ms": time_ms(lambda: torch.ops.aten.leaky_relu_backward(g_in, o, 0.2, True))}
    for t in times.values():
        t["bound_share"] = t["bound_ms"] / t["ms"]
    return times


def student_pair_shapes():
    """The 11x student's largest epilogue shapes at batch 16: C = 39, 77,
    154 at 256px and C = 20, 10 at 1024px (widths no 16-byte lane divides)."""
    s256 = student_epilogue_shapes(BATCH)
    s1024 = student_epilogue_shapes(BATCH, net_shapes_1024()[1])
    return [s256[-1], s256[-3], s256[-5], s1024[-3], s1024[-1]]


def fused_pair_times(rng):
    """The epilogue and masked_scale in float32 and bfloat16 at
    ``student_pair_shapes``: ms against the bytes bound, the plain version
    and, for masked_scale, aten.leaky_relu_backward. Returns {kernel name
    (``_bf16`` for bfloat16): [rows]}."""
    from content_aware_gan_compression_torch.bench_fused_act import (
        epilogue_bound, masked_bound)
    from content_aware_gan_compression_torch.bench_blur4 import time_ms
    from content_aware_gan_compression_torch.ops.cuda import (
        fused_noise_bias_lrelu, fused_noise_bias_lrelu_plain, masked_scale, masked_scale_plain)

    dev = rng.device
    out = {}
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        fused, ms = out.setdefault(f"fused_noise_bias_lrelu{suffix}", []), out.setdefault(
            f"masked_scale{suffix}", [])
        for shape in student_pair_shapes():
            x = torch.randn(shape, generator=rng, device=dev).to(dtype)
            noise = torch.randn((*shape[:3], 1), generator=rng, device=dev).to(dtype)
            bias = (0.5 * torch.randn(shape[3], generator=rng, device=dev)).to(dtype)
            nw = torch.tensor([0.7], device=dev).to(dtype)
            negatives = int((fused_noise_bias_lrelu_plain(x, noise, bias, nw) < 0).sum().item())
            b_ms, by = epilogue_bound(x, noise, shape[3], negatives)
            fused.append({
                "shape": list(shape), "ms": time_ms(lambda: fused_noise_bias_lrelu(x, noise, bias,
                                                                                   nw)),
                "plain_ms": time_ms(lambda: fused_noise_bias_lrelu_plain(x, noise, bias, nw),
                                    iters=5),
                "bound_ms": b_ms, "bound_by": by, "library_ms": None})
            g_in, o = x, torch.randn(shape, generator=rng, device=dev).to(dtype)
            b_ms, by = masked_bound(o, int((o < 0).sum().item()))
            ms.append({
                "shape": list(shape), "ms": time_ms(lambda: masked_scale(g_in, o)),
                "plain_ms": time_ms(lambda: masked_scale_plain(g_in, o), iters=5),
                "bound_ms": b_ms, "bound_by": by,
                "library_ms": time_ms(lambda: torch.ops.aten.leaky_relu_backward(g_in, o, 0.2,
                                                                                  True))})
            del x, noise, g_in, o
        for row in fused + ms:
            row["bound_share"] = row["bound_ms"] / row["ms"]
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def no_general_blurs(dtype):
    """Records every call of the general upfirdn2d that is a plain blur (up
    and down 1) on a CUDA tensor of ``dtype``: blur4 should have taken it.
    The ToRGB skip's upsample (up 2) is not a blur4 case."""
    import importlib

    mod = importlib.import_module("content_aware_gan_compression_torch.ops.upfirdn2d")
    orig, seen = mod.upfirdn2d, []

    def recording(x, kernel, up=1, down=1, pad=(0, 0), data_format="NHWC"):
        if (x.is_cuda and x.dtype == dtype and up in (1, (1, 1))
                and down in (1, (1, 1))):
            seen.append((tuple(x.shape), tuple(pad)))
        return orig(x, kernel, up, down, pad, data_format)
    mod.upfirdn2d = recording
    try:
        yield seen
    finally:
        mod.upfirdn2d = orig


def bf16_train_phases(student, teacher, parser, reals, want_phase, dev):
    """The bfloat16 retraining path: full_kd at 256px with the 11x student,
    batch 16, path batch 8, as train_rate runs it. With opt_state_dtype
    float32: iterations 0-4 with per-phase launches, every one of them a
    bfloat16 launch and as many as train_phase_launches wants, and no bf16
    blur in the general upfirdn2d; then, for opt_state_dtype float32 and
    bfloat16, the train_rate window (it/s, kernel ms, busy share, peak
    memory) under PyTorch's defaults. Returns (launches, rates)."""
    from content_aware_gan_compression_torch.ops.cuda import reset_counts
    from content_aware_gan_compression_torch.train import Trainer

    torch.backends.cudnn.allow_tf32 = True
    launches, rates = None, {}
    for sd in ("float32", "bfloat16"):
        tr = Trainer(train_config(SIZE, BATCH, student, teacher, "full_kd",
                                  compute_dtype="bfloat16", opt_state_dtype=sd),
                     device=dev, lpips_params=seeded_lpips(), parse_params=parser)
        mpl = torch.zeros((), device=dev)
        if launches is None:
            phases = []
            reset_counts()
            with no_general_blurs(torch.bfloat16) as general:
                for it in range(5):
                    m, mpl = tr.step(it, reals[it % 4], mpl, phase_hook=phase_counter(phases))
                torch.cuda.synchronize()
            if general:
                fail(f"bf16 blurs reached the general upfirdn2d on the card: {general[:4]}")
            if not all(np.isfinite(v.item()) for v in m.values()):
                fail(f"a bf16 training loss is not finite: {m}")
            launches = {}
            for name, c in phases:
                want = dict(want_phase[name])
                got = {k: c[k] for k in want}
                got_bf16 = {k: c[f"{k}_bf16"] for k in want}
                if got != want or got_bf16 != want:
                    fail(f"bf16 train phase {name} launched {got} ({got_bf16} in bf16), "
                         f"want {want}, all bf16")
                for k, v in c.items():
                    launches[k] = launches.get(k, 0) + v
            for need in ("d_reg", "g", "g_reg"):
                if not any(n == need for n, _ in phases):
                    fail(f"bf16 phase {need} did not run")
        rates[f"opt_state_{sd}"], _ = train_window(tr, reals, mpl, profile=sd == "float32")
        nu = next(iter(tr.g_opt.state.values()))["exp_avg_sq"]
        rates[f"opt_state_{sd}"]["nu_dtype"] = str(nu.dtype)
        del tr
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cudnn.allow_tf32 = False
    return launches, rates


# -- data parallel (parallel/mesh.py) -------------------------------------------

DP_WINDOW = range(16, 32)  # train_rate_bf16's window
DP_SIZE, DP_BATCH = 64, 8  # dp_two_ranks_one_card
DP_CADENCE = dict(d_reg_freq=4, g_reg_freq=2)  # R1 at 0, path length at 0, 2 and 4
DP_ITERS = 5
DP_CLI_ITERS = 5


def weights_of(trainer):
    """g, d and g_ema's state on the CPU."""
    return {net: {k: v.detach().cpu().clone()
                  for k, v in getattr(trainer, net).state_dict().items()}
            for net in ("g", "d", "g_ema")}


def drive_counted(trainer, real_rows, want_phase, bf16, iters=DP_ITERS):
    """Iterations 0..iters-1 with each phase's launches checked against
    ``want_phase`` (None on the CPU, which launches none; with ``bf16``
    every one a bfloat16 launch); each iteration's metrics averaged over
    ranks. ``real_rows(it)`` is the rank's real batch. Returns (metrics,
    summed launches, mean path length)."""
    from content_aware_gan_compression_torch import parallel
    from content_aware_gan_compression_torch.ops.cuda import reset_counts

    mpl = torch.zeros((), device=trainer.device)
    phases, metrics = [], []
    reset_counts()
    for it in range(iters):
        m, mpl = trainer.step(it, real_rows(it), mpl, phase_hook=phase_counter(phases))
        keys = sorted(m)
        packed = parallel.mean_over_ranks(torch.stack([m[k].float() for k in keys]))
        metrics.append(dict(zip(keys, packed.tolist())))
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    launches = {}
    for name, c in phases:
        if want_phase is None:
            continue
        want = dict(want_phase[name])
        got = {k: c[k] for k in want}
        if got != want or (bf16 and {k: c[f"{k}_bf16"] for k in want} != want):
            fail(f"data-parallel phase {name} launched {c}, want {want}"
                 + (" all bf16" if bf16 else ""))
        for k, v in c.items():
            launches[k] = launches.get(k, 0) + v
    for need in ("d_reg", "g", "g_reg"):
        if need not in [n for n, _ in phases]:
            fail(f"data-parallel phase {need} did not run")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        fail(f"a data-parallel loss is not finite: {metrics}")
    return metrics, launches, float(mpl)


@contextlib.contextmanager
def collective_times():
    """CUDA-event times and bytes of every ``torch.distributed.all_reduce``
    (the gradient buckets, the stddev gather and the path mean, forward and
    backward, the logged metrics) and of each ``all_reduce_grads`` call
    (flatten, all-reduce, divide, write back) while the context is open."""
    import torch.distributed as dist

    from content_aware_gan_compression_torch import parallel

    rec = {"all_reduce": [], "all_reduce_grads": []}

    def timed(name, fn):
        def wrapper(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            nbytes = args[0].numel() * args[0].element_size() if name == "all_reduce" else 0
            rec[name].append((start, end, nbytes))
            return out
        return wrapper

    saved = dist.all_reduce, parallel.all_reduce_grads
    dist.all_reduce = timed("all_reduce", saved[0])
    parallel.all_reduce_grads = timed("all_reduce_grads", saved[1])
    try:
        yield rec
    finally:
        dist.all_reduce, parallel.all_reduce_grads = saved


def dp_rate(trainer, reals, mpl, window=DP_WINDOW):
    """Iterations/s, ms per iteration and peak memory over ``window`` after
    two warm-up iterations (train_window's timing, without its profile)."""
    for it in (1, 2):
        trainer.step(it, reals[it % 4], mpl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for it in window:
        _, mpl = trainer.step(it, reals[it % 4], mpl)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"iterations_per_s": len(window) / seconds,
            "ms_per_iteration": seconds * 1e3 / len(window),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}, mpl


def dp_world1_phase(student, teacher, parser, reals, want_phase, dev, work):
    """``dp_world1_nccl``: the bf16 full_kd Trainer at 256px, batch 16,
    iterations 0-4, in one process, then again with an NCCL process group
    of world size 1 (every collective of the data-parallel path runs), both
    under cuDNN's deterministic algorithms: launches per phase, and the
    trajectory bit for bit. Then train_rate_bf16's window with the group's
    collectives on and off in turns, and the collectives' CUDA-event ms and
    bytes per iteration. Returns (launches, details)."""
    from content_aware_gan_compression_torch import parallel
    from content_aware_gan_compression_torch.parallel import mesh
    from content_aware_gan_compression_torch.train import Trainer

    def make():
        return Trainer(train_config(SIZE, BATCH, student, teacher, "full_kd",
                                    compute_dtype="bfloat16"),
                       device=dev, lpips_params=seeded_lpips(), parse_params=parser)

    t0 = time.time()
    runs = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                     allow_tf32=True):
        tr = make()
        runs["one_process"] = (*drive_counted(tr, lambda it: reals[it % 4], want_phase, True),
                               weights_of(tr))
        del tr
        torch.cuda.empty_cache()
        got = parallel.initialize(dev, backend="nccl",
                                  init_method=f"file://{os.path.join(work, 'nccl_store')}",
                                  world_size=1, rank=0)
        if got != torch.device("cuda", 0) or torch.distributed.get_backend() != "nccl":
            fail(f"dp_world1_nccl: initialize gave {got}, {torch.distributed.get_backend()}")
        tr = make()
        runs["nccl"] = (*drive_counted(tr, lambda it: reals[it % 4], want_phase, True),
                        weights_of(tr))
    (m1, _, p1, w1), (m2, launches, p2, w2) = runs["one_process"], runs["nccl"]
    differ = [f"{net}.{k}" for net in w1 for k in w1[net]
              if not torch.equal(w1[net][k], w2[net][k])]
    if m1 != m2 or p1 != p2 or differ:
        fail(f"dp_world1_nccl: the NCCL run is not bit for bit the one-process run: metrics "
             f"{m1} vs {m2}, weights differ in {differ[:6]}")
    # the window with the collectives off (as without a group) and on, in
    # turns off, on, on, off, under train_rate_bf16's flags (cuDNN's
    # default algorithms, TF32 on for the float32 convolutions)
    active = mesh.active
    turns = []
    mpl = torch.zeros((), device=dev)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                     allow_tf32=True):
        try:
            for turn in ("off", "on", "on", "off"):
                mesh.active = (lambda: False) if turn == "off" else active
                r, mpl = dp_rate(tr, reals, mpl)
                turns.append({"collectives": turn, **r})
        finally:
            mesh.active = active
        with collective_times() as rec:
            r, mpl = dp_rate(tr, reals, mpl)
        torch.cuda.synchronize()
    n = len(DP_WINDOW) + 2
    per_iter = {name: {"ms_per_iteration": sum(s.elapsed_time(e) for s, e, _ in rec[name]) / n,
                       "calls_per_iteration": len(rec[name]) / n}
                for name in rec}
    per_iter["all_reduce"]["mbytes_per_iteration"] = sum(
        b for _, _, b in rec["all_reduce"]) / n / 1e6
    del tr
    torch.cuda.empty_cache()
    parallel.finalize()
    mean = {turn: float(np.mean([x["iterations_per_s"] for x in turns
                                 if x["collectives"] == turn])) for turn in ("off", "on")}
    out = {"seconds": round(time.time() - t0, 1), "bit_for_bit": True,
           "metrics_iteration4": m2[-1], "turns": turns, "mean_iterations_per_s": mean,
           "instrumented_window": r, "collectives": per_iter}
    return launches, out


def dp_reals():
    """dp_two_ranks_one_card's seeded uint8 real batches, iterations 0-4."""
    return np.random.RandomState(6).randint(0, 256, (DP_ITERS, DP_BATCH, DP_SIZE, DP_SIZE, 3),
                                            dtype=np.uint8)


def dp_config(student, teacher, batch):
    return train_config(DP_SIZE, batch, student, teacher, "kd_l1", init_lr=0.0, **DP_CADENCE)


def dp_rank_run(dev, student, teacher):
    """The 64px KD-L1 Trainer at a global batch of DP_BATCH and lr 0,
    iterations 0-4 (DP_CADENCE), each rank on its rows of ``dp_reals``,
    TF32 off under cuDNN's deterministic algorithms: (metrics averaged over
    ranks, launches, mean path length, iteration 0's gradient of each
    phase's network after its all-reduce, by parameter, and iteration 0's
    draws as the Trainer drew them, both on the CPU)."""
    from content_aware_gan_compression_torch import parallel
    from content_aware_gan_compression_torch.train import Trainer

    reals = dp_reals()
    grads, drawn = {}, {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                     allow_tf32=False):
        tr = Trainer(dp_config(student, teacher, DP_BATCH), device=dev)
        plain_step, plain_draw = tr.step, tr.draw

        def draw(it):
            out = plain_draw(it)
            if it == 0:
                drawn.update(to_device(out, "cpu"))
            return out

        def step(it, real, mpl, phase_hook=None):
            def both(name):
                if it == 0 and name in ("d", "d_reg", "g", "g_reg"):
                    net = tr.d if name.startswith("d") else tr.g
                    grads[name] = {n: p.grad.cpu() for n, p in net.named_parameters()
                                   if p.grad is not None}
                phase_hook(name)
            return plain_step(it, real, mpl, phase_hook=both)

        tr.draw, tr.step = draw, step
        out = drive_counted(tr, lambda it: parallel.shard_rows(torch.from_numpy(reals[it])),
                            train_phase_launches(int(np.log2(DP_SIZE))), False)
    return (*out, grads, drawn)


def dp_iteration0_grads(dev, student, teacher, real, draws, dtype=torch.float32):
    """Iteration 0 of ``dp_rank_run``'s Trainer at ``real``'s batch (uint8)
    in one process on ``dev`` in ``dtype``, on ``draws``, TF32 off under
    cuDNN's deterministic algorithms: each phase's gradient by parameter, on
    the CPU. In float64 every network and input is float64 and the three
    wrappers take their plain versions (``plain_routes``); the port's
    float32 islands (the demodulation's sigma, the stddev, the path
    lengths, D's logits into the losses) stay float32, as in JAX."""
    from content_aware_gan_compression_torch.train import Trainer

    tr = Trainer(dp_config(student, teacher, real.shape[0]), device=dev)
    routes = contextlib.nullcontext()
    if dtype == torch.float64:
        for module in (tr.g, tr.d, tr.teacher):
            module.double()
        draws = to_float64(draws)
        routes = plain_routes()
    grads = {}

    def hook(name):
        if name in ("d", "d_reg", "g", "g_reg"):
            net = tr.d if name.startswith("d") else tr.g
            grads[name] = {n: p.grad.cpu() for n, p in net.named_parameters()
                           if p.grad is not None}
    with routes, torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                             allow_tf32=False):
        tr.step(0, torch.from_numpy(real).to(dev, dtype) / 127.5 - 1.0,
                torch.zeros((), device=dev, dtype=dtype), draws=to_device(draws, dev),
                phase_hook=hook)
    return grads


def half_draws(draws, h):
    """Half ``h`` (0 or 1) of the rows of every tensor of a Trainer's draws;
    the mixing point is shared."""
    def rows(t):
        n = t.shape[0] // 2
        return t[h * n:(h + 1) * n]
    return {ph: {k: v if k == "inject_index" else
                 [rows(t) for t in v] if isinstance(v, list) else rows(v)
                 for k, v in d.items()} for ph, d in draws.items()}


def grad_distance(grads, ref):
    """Per phase: (the largest error of a tensor over that tensor's largest
    value in ``ref``, phase 7's measure; the tensor; the largest error of
    any tensor over the largest value of any, the whole gradient's)."""
    out = {}
    for ph, want in ref.items():
        err, name = max((max_rel_err(grads[ph][n].double(), g.double()), n)
                        for n, g in want.items())
        whole = (max(float((grads[ph][n].double() - g.double()).abs().max())
                     for n, g in want.items())
                 / max(float(g.abs().max()) for g in want.values()))
        out[ph] = (err, name, whole)
    return out


def dp_rank_worker(rank, world, store, out_dir, student, teacher):
    """One rank of ``dp_two_ranks_one_card``: gloo on cuda:0, named."""
    from content_aware_gan_compression_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = parallel.initialize("cuda:0", backend="gloo", init_method=f"file://{store}",
                              world_size=world, rank=rank)
    try:
        torch.save(dp_rank_run(dev, student, teacher), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        parallel.finalize()


def dp_two_ranks_phase(dev, work):
    """``dp_two_ranks_one_card``: two processes on cuda:0 over gloo, 64px at
    a global batch of 8, lr 0, iterations 0-4, against one process on the
    card: the metrics at 1e-4 relative and 1e-5 absolute
    (test_torch_data_parallel.py's bound), the ranks' gradients and metrics
    bit-equal, each rank's launches per phase as train_phase_launches
    wants. Iteration 0's all-reduced gradient of each phase is held against
    the same iteration in float64 (one process on the card, the plain
    routes, the same draws), phase 7's way: two ranks may be no further from it than twice
    the card's own fp32 distance, plus 1e-4. The card's own is the largest
    of one process at batch 8 and of each half of that batch run alone as
    a batch of 4 (a rank's shapes; the same rows and draws), each against
    its own run in float64. Both of ``grad_distance``'s measures are held:
    a tensor's (phase 7's), which the cancellation in a small tensor's
    gradient makes noisy, and the whole gradient's.

    At lr 0 the weights stay put, so the gradients are what the trajectory
    is made of: with the training lr, Adam's first steps (about lr *
    sign(g)) turn the last bits of a gradient near 0 into whole steps, and
    5 iterations at 64px end 3% apart on the card between any two batch
    splits."""
    import torch.multiprocessing as mp

    t0 = time.time()
    student, teacher = write_train_checkpoints(work, DP_SIZE)
    one = dp_rank_run(dev, student, teacher)
    real = dp_reals()[0]
    rows = DP_BATCH // 2
    halves = [(real[h * rows:(h + 1) * rows], half_draws(one[4], h)) for h in range(2)]
    store, out_dir = os.path.join(work, "gloo_store"), os.path.join(work, "dp_ranks")
    os.makedirs(out_dir, exist_ok=True)
    try:
        mp.spawn(dp_rank_worker, args=(2, store, out_dir, student, teacher), nprocs=2,
                 join=True)
    except Exception as e:  # a rank's failure, with its traceback
        fail(f"dp_two_ranks_one_card: a rank failed: {e}")
    half_grads = [dp_iteration0_grads(dev, student, teacher, rows, draws)
                  for rows, draws in halves]
    f64, *f64_halves = [dp_iteration0_grads(dev, student, teacher, rows, draws, torch.float64)
                        for rows, draws in [(real, one[4]), *halves]]
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    dist = {"two_ranks_vs_float64": grad_distance(ranks[0][3], f64),
            "one_process_vs_float64": grad_distance(one[3], f64),
            **{f"half{h}_vs_float64": grad_distance(half_grads[h], f64_halves[h])
               for h in range(2)},
            "two_ranks_vs_one_process": grad_distance(ranks[0][3], one[3])}
    own = [k for k in dist if k.startswith(("one", "half"))]
    bound = {ph: [2 * max(dist[k][ph][i] for k in own) + 1e-4 for i in (0, 2)] for ph in f64}
    metric_err = max(abs(ranks[0][0][it][k] - v) - 1e-4 * abs(v)
                     for it, want in enumerate(one[0]) for k, v in want.items())
    out = {"seconds": round(time.time() - t0, 1), "size": DP_SIZE, "global_batch": DP_BATCH,
           "ranks": 2, "backend": "gloo", "device": "cuda:0", "lr": 0.0,
           "launches_per_rank": ranks[0][1], "launches_one_process": one[1],
           "metric_excess_over_1e-4_relative": metric_err,
           "grad_distance": {k: {ph: {"tensor_err": e, "tensor": n, "whole_err": w}
                                 for ph, (e, n, w) in v.items()} for k, v in dist.items()},
           "grad_bound": {ph: {"tensor_err": b[0], "whole_err": b[1]}
                          for ph, b in bound.items()},
           "metrics_iteration4": ranks[0][0][-1]}
    detail("dp_two_ranks_one_card", card=card_line(), **out,
           tolerance="metrics 1e-4 relative + 1e-5 absolute; two ranks' gradients vs float64, "
                     "in both measures, <= 2 x the card's own distance (the largest of one "
                     "process at batch 8 and of each half of its batch run alone) + 1e-4; "
                     "the ranks bit-equal",
           measure="per phase: tensor_err, the largest error of a tensor over its largest "
                   "value in the reference (phase 7's), and that tensor; whole_err, the "
                   "largest error over the largest value of the phase's whole gradient")
    for it, want in enumerate(one[0]):
        for k, v in want.items():
            got = ranks[0][0][it][k]
            if abs(got - v) > 1e-5 + 1e-4 * abs(v):
                fail(f"dp_two_ranks_one_card: iteration {it} {k}: {got} vs one process {v}")
    for ph, (err, name, whole) in dist["two_ranks_vs_float64"].items():
        if err > bound[ph][0] or whole > bound[ph][1]:
            fail(f"dp_two_ranks_one_card: phase {ph}'s gradient is {err} ({name}) and {whole} "
                 f"(whole) from float64's, over {bound[ph]}")
        if any(not torch.equal(g, ranks[1][3][ph][n]) for n, g in ranks[0][3][ph].items()):
            fail(f"dp_two_ranks_one_card: the ranks' {ph} gradients differ")
    if ranks[0][0] != ranks[1][0]:
        fail("dp_two_ranks_one_card: the ranks logged different metrics")
    return out


def dp_cards_phase(work, cache, student, teacher, aux_files, nproc=2, iters=DP_CLI_ITERS):
    """``dp_nccl_cards``: where the machine has ``nproc`` cards or more, the
    train CLI under ``torchrun --nproc_per_node=nproc`` at 256px, bf16
    full_kd, global batch 16, for ``iters`` iterations: from rank 0's records
    (each iteration's pass-boundary ``train_time``), it/s and images/s over
    iterations 1 on (the sample grid of iteration 0 falls in 1's span) and,
    from 32 iterations, over the whole 16-iteration cadences from 16 on
    (and their single iterations' median). None on fewer cards."""
    if torch.cuda.device_count() < nproc:
        print(f"dp_nccl_cards: not run, {torch.cuda.device_count()} card(s)", flush=True)
        return None
    vgg_file, lins_file, parsing_file = aux_files
    root = os.path.join(work, f"cli_dp{nproc}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "content_aware_gan_compression_torch.train",
           "--path", cache, "--size", str(SIZE), "--ckpt", student, "--teacher_ckpt", teacher,
           "--batch_size", str(BATCH), "--iter", str(iters), "--dtype", "bfloat16",
           "--n_sample", "4", "--lpips_vgg_ckpt", vgg_file, "--lpips_lins_ckpt", lins_file,
           "--parsing_ckpt", parsing_file, "--exp_root", root]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"dp_nccl_cards: torchrun rc {proc.returncode}: {proc.stderr[-3000:]}")
    (exp,) = [os.path.join(root, d) for d in os.listdir(root) if d.startswith("Exp_")]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if '"d"' in line]
    if [r["iter"] for r in recs] != list(range(iters)) or not all(
            np.isfinite(v) for r in recs for v in r.values()):
        fail(f"dp_nccl_cards: records {recs}")
    if f"{nproc} process(es)" not in proc.stdout:
        fail(f"dp_nccl_cards: the CLI did not run {nproc} processes: {proc.stdout[-2000:]}")
    times = [r["train_time"] for r in recs]
    rate = (len(recs) - 1) / sum(times[1:])
    out = {"seconds": round(time.time() - t0, 1), "cards": nproc, "global_batch": BATCH,
           "iterations": iters, "iterations_per_s": rate, "images_per_s": rate * BATCH,
           "note": "rank 0's records: train_time is the pass-boundary time; iterations_per_s "
                   "over iterations 1 on"}
    if iters >= 32:  # whole cadences of R1 (16) and path length (4) from iteration 16
        steady = times[16:16 * (iters // 16)]
        out.update(cadence_iterations=[16, 16 * (iters // 16) - 1],
                   cadence_iterations_per_s=len(steady) / sum(steady),
                   cadence_images_per_s=len(steady) / sum(steady) * BATCH,
                   median_iterations_per_s=1 / float(np.median(steady)))
    return out


DP_CARDS_ITERS = 48  # --dp_cards: iteration 0, then two whole cadences from 16


def dp_cards_only(counts):
    """``python3 chip_smoke.py --dp_cards 1,2,4``: the kernels built, then
    the seeded 256px files of phases 6 and 8 (the parser picked the same
    way), then ``dp_cards_phase`` at each card count for DP_CARDS_ITERS
    iterations; each result a ``dp_nccl_cards`` line."""
    from content_aware_gan_compression_torch.ops.cuda import build
    from content_aware_gan_compression_torch.tools.fixtures import teacher_images
    from content_aware_gan_compression_torch.utils import load_generator

    card = card_line()
    print(card, flush=True)
    build.build()
    work = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    student, teacher = write_train_checkpoints(work, SIZE)
    cache = os.path.join(work, "ffhq256_seeded.npy")
    np.save(cache, np.random.RandomState(2).randint(0, 256, (32, SIZE, SIZE, 3), dtype=np.uint8))
    t = load_generator(teacher, SIZE, device="cuda").eval()
    parser, _, _ = pick_parser(teacher_images(t, BATCH))
    aux_files = write_aux_files(work, seeded_lpips(), parser)
    del t, parser
    torch.cuda.empty_cache()
    for n in counts:
        if torch.cuda.device_count() < n:
            fail(f"--dp_cards {n}: the machine has {torch.cuda.device_count()} card(s)")
        detail("dp_nccl_cards", card=card, **dp_cards_phase(work, cache, student, teacher,
                                                           aux_files, n, DP_CARDS_ITERS))
    shutil.rmtree(work)
    return 0


# -- the data path, the profiler, the converter and the down conv ---------------
DATA_IMAGES = 64  # seeded PNGs at each of 512px and 256px
DATA_RATE_BATCHES = 12  # batches of BATCH taken to time a loader
DATA_TRAIN_ITERS = 5
PROFILER_ITERS = 4  # R1 and path length once each, traced
FULL_KD_ITERS_PER_S = 3.6  # bf16 full_kd on an H100 80GB HBM3 at 700 W (PERF.md)


def total_launches(counts, name):
    """A kernel's launches in ``counts``: blur4's forward and backward."""
    return counts["blur4"] + counts["blur4_backward"] if name == "blur4" else counts[name]


def loader_rate(loader, n_batches):
    """Images/s of ``n_batches`` batches from a fresh loader, start-up
    included; the loader is closed after."""
    t0 = time.perf_counter()
    try:
        shapes = {tuple(next(loader).shape) for _ in range(n_batches)}
    finally:
        loader.close()
    return {"images_per_s": n_batches * BATCH / (time.perf_counter() - t0),
            "batches": n_batches, "shapes": sorted(shapes)}


def data_phases(dev, card, work, bench_line):
    """26. The training data path without the JAX package on the card's host:
    seeded PNG folders, the native transform's build and rate, the loader's
    rates, one Paeth-filtered 1024px PNG through read_png, prepare_data's
    uint8 cache against FFHQDataset, the train CLI from a folder with no
    cache (launches per phase against train_phase_launches), and
    SparsityTrainer.run from a 512px folder (float NCHW batches through the
    native transform). Returns the kernels line's launch counts."""
    import importlib.util
    import io

    from content_aware_gan_compression_torch import prepare_data
    from content_aware_gan_compression_torch.data import (
        FFHQDataset, data_loader, native_loader, open_dataset)
    from content_aware_gan_compression_torch.ops.cuda import reset_counts
    from content_aware_gan_compression_torch.train import loop as train_loop
    from content_aware_gan_compression_torch.train.__main__ import main as train_main
    from content_aware_gan_compression_torch.tools import bench_loader
    from content_aware_gan_compression_torch.train.sparsity import SparsityTrainer
    from content_aware_gan_compression_torch.utils import ExperimentLogger
    from content_aware_gan_compression_torch.utils.logging import read_png, write_png

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    threads = os.cpu_count()
    pillow = importlib.util.find_spec("PIL") is not None
    t0 = time.time()
    big = write_pngs(os.path.join(work, "png512"), 512, DATA_IMAGES, seed=11)
    small = write_pngs(os.path.join(work, "png256"), SIZE, DATA_IMAGES, seed=12)
    write_s = time.time() - t0

    # the native transform: its build, then 512 -> 256 at batch 16
    prebuilt = native_loader.library_path().exists()
    t0 = time.time()
    native_loader.build()
    build_s = time.time() - t0
    ds512 = FFHQDataset(big, SIZE)
    raw = np.stack([ds512.decode(i) for i in range(BATCH)])
    flips = (np.random.RandomState(0).rand(BATCH) < 0.5).astype(np.uint8)
    native_loader.transform_batch(raw, SIZE, flips, threads)
    t0 = time.perf_counter()
    for _ in range(5):
        out = native_loader.transform_batch(raw, SIZE, flips, threads)
    transform_ips = 5 * BATCH / (time.perf_counter() - t0)
    if out.shape != (BATCH, 3, SIZE, SIZE) or not (-1 <= out.min() <= out.max() <= 1):
        fail(f"transform_batch gave {out.shape} in [{out.min()}, {out.max()}]")

    # read_png on a Paeth-filtered 1024px PNG (Pillow's encoder picks
    # adaptive filters, mostly Paeth, for photos), against filter 0
    arr = np.random.RandomState(13).randint(0, 256, (1024, 1024, 3), dtype=np.uint8)
    decode_s = {}
    for name, ftype in (("none", 0), ("paeth", 4)):
        path = os.path.join(work, f"big_{name}.png")
        write_png(path, arr, filter_type=ftype)
        t0 = time.perf_counter()
        back = read_png(path)
        decode_s[name] = time.perf_counter() - t0
        if not np.array_equal(back, arr):
            fail(f"read_png of the filter-{ftype} 1024px PNG differs from what was written")

    # prepare_data's uint8 cache against FFHQDataset's reads
    caches = os.path.join(work, "caches")
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        prepare_data.main(["--out", caches, "--size", str(SIZE), "--format", "uint8",
                           "--n_worker", str(threads), small])
    prepare_s = time.time() - t0
    cache = os.path.join(caches, f"uint8_cache_{SIZE}.npy")
    ds256 = FFHQDataset(small, SIZE, random_flip=False)
    if not np.array_equal(np.load(cache), np.stack([ds256.load_uint8(i, None)
                                                    for i in range(len(ds256))])):
        fail("prepare_data's uint8 cache differs from FFHQDataset.load_uint8")

    # the loaders' rates, start-up included
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rates = {
            "float_512px_folder_to_256": loader_rate(data_loader(
                FFHQDataset(big, SIZE), BATCH, num_workers=threads), DATA_RATE_BATCHES),
            "uint8_256px_folder": loader_rate(data_loader(
                FFHQDataset(small, SIZE), BATCH, num_workers=threads, uint8_hwc=True),
                DATA_RATE_BATCHES),
            "uint8_cache": loader_rate(data_loader(
                open_dataset(cache, SIZE), BATCH, num_workers=threads, uint8_hwc=True),
                DATA_RATE_BATCHES)}
    loader_lines = log.getvalue().strip().splitlines()
    want_decoder = "Pillow" if pillow else "read_png"
    if sum(f"decoder {want_decoder}" in ln for ln in loader_lines) != 2:
        fail(f"the loaders' first lines do not name the decoder {want_decoder}: {loader_lines}")
    # the loader bench on the 512px folder: the native float path and the
    # uint8 cache, each a rate
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            contextlib.redirect_stderr(io.StringIO()):
        bench_loader.main(["--folder", big, "--size", str(SIZE), "--batch_size", str(BATCH),
                           "--paths", "native_float,uint8_cache", "--n_batches", "4",
                           "--num_workers", str(threads)])
    loader_bench = [json.loads(line) for line in out.getvalue().strip().splitlines()]
    loader_bench_s = time.time() - t0
    needed = {"pr8_full_kd_bf16": FULL_KD_ITERS_PER_S * BATCH,
              "this_run_bench": bench_line["value"] * BATCH}
    detail("data_path", card=card, host_threads=threads, pillow=pillow,
           png_write_s=round(write_s, 3), native_build_s=build_s, native_prebuilt=prebuilt,
           transform_512_to_256_images_per_s=transform_ips, loader=rates,
           loader_first_lines=loader_lines, read_png_1024px_s=decode_s,
           prepare_data_uint8_s=prepare_s, bench_loader=loader_bench,
           bench_loader_s=round(loader_bench_s, 1),
           images_per_s_needed_by_full_kd_bf16=needed,
           transform_over_needed=transform_ips / max(needed.values()))
    if ([line["path"] for line in loader_bench] != ["native_float", "uint8_cache"]
            or not all(line.get("img_per_sec", 0) > 0 for line in loader_bench)):
        fail(f"bench_loader on the 512px folder: {loader_bench}")

    # the train CLI from the 256px folder, no cache: launches per phase
    student, teacher = write_train_checkpoints(work, SIZE)
    want_phase = train_phase_launches(int(np.log2(SIZE)))
    phases = []
    run = train_loop.Trainer.run

    def counted_run(self, **kw):
        return run(self, **kw, phase_hook=phase_counter(phases))

    absent = os.path.join(work, "absent.pth")
    root = os.path.join(work, "cli_folder")
    out = io.StringIO()
    train_loop.Trainer.run = counted_run
    try:
        reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            train_main(["--path", small, "--size", str(SIZE), "--ckpt", student,
                        "--teacher_ckpt", teacher, "--batch_size", str(BATCH),
                        "--iter", str(DATA_TRAIN_ITERS), "--n_sample", "4",
                        "--val_sample_freq", "1000", "--model_save_freq", "1000",
                        "--parsing_ckpt", absent, "--lpips_vgg_ckpt", absent,
                        "--exp_root", root])
        torch.cuda.synchronize()
        cli_s = time.time() - t0
    finally:
        train_loop.Trainer.run = run
    keys = ("blur4", "blur4_backward", "blur4_vector", "fused_noise_bias_lrelu",
            "fused_noise_bias_lrelu_vector", "masked_scale")
    k, e = int(np.log2(SIZE)) - 2, 2 * int(np.log2(SIZE)) - 3
    bad, cli_launches = [], dict.fromkeys(keys, 0)
    for name, c in phases:
        want = ({**dict.fromkeys(keys, 0), "blur4": k, "fused_noise_bias_lrelu": e,
                 "fused_noise_bias_lrelu_vector": e}
                if name == "sample" else want_phase[name])
        if {kk: c[kk] for kk in keys} != want:
            bad.append((name, {kk: c[kk] for kk in keys}, want))
        for kk in keys:
            cli_launches[kk] += c[kk]
    (exp,) = [os.path.join(root, d) for d in os.listdir(root) if d.startswith("Exp_")]
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    names = [n for n, _ in phases]
    cli_lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("data_loader:")]
    detail("data_train_cli", size=SIZE, batch=BATCH, iterations=DATA_TRAIN_ITERS,
           seconds=round(cli_s, 3), phases=names, launches=cli_launches, bad_phases=bad,
           loader_line=cli_lines, metrics=[{kk: r[kk] for kk in ("iter", "d", "g", "kd_l1_loss")}
                                           for r in recs], tf32=torch.backends.cudnn.allow_tf32)
    if bad or names.count("d_reg") != 1 or names.count("g_reg") != 2:
        fail(f"train CLI from a folder: launches {bad}, phases {names}")
    if ([r["iter"] for r in recs] != list(range(DATA_TRAIN_ITERS))
            or not all(np.isfinite(v) for r in recs for v in r.values())):
        fail(f"train CLI from a folder: metrics {recs}")
    if os.path.exists(os.path.join(small, f"uint8_cache_{SIZE}.npy")) or len(cli_lines) != 1:
        fail(f"train CLI from a folder: a cache was written or the loader line is {cli_lines}")

    # SparsityTrainer.run from the 512px folder: float NCHW batches resized
    # 512 -> 256 by the native transform
    trainer = SparsityTrainer(sparsity_config(SIZE, BATCH, student, big, teacher=teacher),
                              {**SPARSITY_OPTS, "model_prune_freq": 1000}, device=dev,
                              lpips_params=seeded_lpips())
    phases = []
    logger = ExperimentLogger(work, name="sparsity_folder")
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        trainer.run(max_iters=2, logger=logger, phase_hook=phase_counter(phases))
    torch.cuda.synchronize()
    sparse_s = time.time() - t0
    logger.close()
    with open(os.path.join(logger.exp_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    want_sparse = sparse_phase_launches(int(np.log2(SIZE)), STUDENT_SHAPE)
    sparse_launches, bad = dict.fromkeys(keys, 0), []
    for name, c in phases:
        if name != "sample" and {kk: c[kk] for kk in keys} != want_sparse[name]:
            bad.append((name, {kk: c[kk] for kk in keys}, want_sparse[name]))
        for kk in keys:
            sparse_launches[kk] += c[kk]
    float_line = [ln for ln in out.getvalue().splitlines() if ln.startswith("data_loader:")]
    detail("data_sparsity_folder", size=SIZE, batch=BATCH, folder_px=512, iterations=2,
           seconds=round(sparse_s, 3), phases=[n for n, _ in phases], launches=sparse_launches,
           bad_phases=bad, loader_line=float_line,
           metrics=[{kk: r[kk] for kk in ("iter", "g", "sparse", "kd_percept_loss")}
                    for r in recs])
    if (bad or [r["iter"] for r in recs] != [0, 1] or len(float_line) != 1
            or "float32 [B, 3, H, W]" not in float_line[0]
            or not all(np.isfinite(v) for r in recs for v in r.values())):
        fail(f"SparsityTrainer from a 512px folder: {bad} {recs} {float_line}")
    shutil.rmtree(work)
    return {"train_cli_folder": cli_launches, "sparsity_folder": sparse_launches}


def profiler_phase(card, work):
    """27. train_time_profiler at 256px in bfloat16 over PROFILER_ITERS
    iterations with ``--trace_dir``: each phase's mean ms and calls (R1 and
    path length at iteration 0), every launch a bfloat16 one; then the
    trace through ``tools.trace_op_time``, whose launches of blur4 (forward
    and backward), the epilogue and masked_scale must equal the launch
    counts of the same window (the traced iterations, reset before them and
    read after), with a busy time > 0. Returns the window's launches."""
    import io

    from content_aware_gan_compression_torch import train_time_profiler
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts
    from content_aware_gan_compression_torch.tools import trace_op_time

    shutil.rmtree(work, ignore_errors=True)
    launched = {}

    @contextlib.contextmanager
    def window():
        reset_counts()
        yield
        torch.cuda.synchronize()
        launched.update(counts())

    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        report = train_time_profiler.main(["--size", str(SIZE), "--batch_size", str(BATCH),
                                           "--iters", str(PROFILER_ITERS),
                                           "--trace_dir", work], window=window)
    seconds = time.time() - t0
    t0 = time.time()
    lines = []
    summary = trace_op_time.report(trace_op_time.load_events(work, log=lines.append), top_n=12,
                                   iters=PROFILER_ITERS, log=lines.append)
    summary_s = time.time() - t0
    calls = {k: v["calls"] for k, v in report.items() if isinstance(v, dict) and "calls" in v}
    in_trace = {k: summary["categories"][k][3] for k in ("blur4", "epilogue", "masked_scale")}
    counted = {"blur4": launched["blur4"] + launched["blur4_backward"],
               "epilogue": launched["fused_noise_bias_lrelu"],
               "masked_scale": launched["masked_scale"]}
    detail("profiler_path", card=card, size=SIZE, batch=BATCH, dtype="bfloat16",
           iterations=PROFILER_ITERS, seconds=round(seconds, 1), report=report,
           launches=launched, trace_launches=in_trace, summary_seconds=round(summary_s, 1),
           busy_ms_per_iter=summary["busy_us"] / PROFILER_ITERS / 1e3,
           categories_ms_per_iter={k: v[0] / PROFILER_ITERS / 1e3
                                   for k, v in summary["categories"].items()},
           summary=lines, note="PyTorch's defaults (cuDNN TF32 on for float32 work)")
    print("\n".join(lines[:40]), flush=True)
    want_calls = {"data": PROFILER_ITERS, "d_step": PROFILER_ITERS, "d_reg_step": 1,
                  "g_step": PROFILER_ITERS, "g_reg_step": 1, "ema": PROFILER_ITERS}
    bf16_only = all(launched[k] == launched[f"{k}_bf16"] for k in
                    ("blur4", "blur4_backward", "fused_noise_bias_lrelu", "masked_scale"))
    if calls != want_calls or not bf16_only or not launched["blur4"]:
        fail(f"train_time_profiler: calls {calls}, want {want_calls}; launches {launched}")
    if in_trace != counted or not summary["busy_us"] > 0:
        fail(f"trace_op_time: launches in the trace {in_trace}, counted {counted}, busy "
             f"{summary['busy_us']} us")
    shutil.rmtree(work)
    return launched


BENCH_WORLD_CARDS = 2


def bench_world_phase(card):
    """27b. ``bench_world``: where the machine has BENCH_WORLD_CARDS cards or
    more, ``bench`` under ``torchrun --nproc_per_node=2`` (9 + 16
    iterations, bf16 full_kd at 256px, global batch 16), then
    ``train_time_profiler`` under the same for 4 iterations: each prints
    exactly one JSON object, from rank 0, with ``world_size`` 2 and finite
    values. On fewer cards it prints ``bench_world: not run``."""
    n = torch.cuda.device_count()
    if n < BENCH_WORLD_CARDS:
        print(f"bench_world: not run, {n} card(s)", flush=True)
        return None
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={BENCH_WORLD_CARDS}", "-m"]
    out = {}
    for name, argv in (("bench", ["content_aware_gan_compression_torch.bench", "--warmup", "9",
                                  "--iters", "16"]),
                       ("profiler", ["content_aware_gan_compression_torch.train_time_profiler",
                                     "--iters", "4"])):
        t0 = time.time()
        proc = subprocess.run(torchrun + argv, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            fail(f"bench_world: {name} under torchrun rc {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        text = proc.stdout.strip()
        try:
            line = json.loads(text)
        except json.JSONDecodeError:
            fail(f"bench_world: {name} printed not one JSON object: {text[-2000:]}")
        numbers = [v for v in line.values() if isinstance(v, (int, float))] + [
            x for v in line.values() if isinstance(v, dict) for x in v.values()
            if isinstance(x, (int, float))]
        if (line.get("world_size") != BENCH_WORLD_CARDS
                or not all(np.isfinite(v) for v in numbers)
                or (name == "bench" and len(text.splitlines()) != 1)):
            fail(f"bench_world: {name} printed {text[-2000:]}")
        out[name] = {"seconds": round(time.time() - t0, 1), "line": line}
    detail("bench_world", card=card, cards=BENCH_WORLD_CARDS, **out)
    return out


def tf_generator_vars(size, seed):
    """Seeded TF-StyleGAN2 generator variables under the official names, at
    the full widths of ``size``, with ``dlatent_avg``."""
    from content_aware_gan_compression_torch.models.stylegan2 import default_channels

    ch = default_channels(2)
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    vars = {}
    for i in range(8):
        vars[f"G_mapping/Dense{i}/weight"] = f32(512, 512)
        vars[f"G_mapping/Dense{i}/bias"] = f32(512)
    vars["G_synthesis/4x4/Const/const"] = f32(1, ch[4], 4, 4)

    def conv(name, cin, cout, k):
        vars.update({f"{name}/weight": f32(k, k, cin, cout), f"{name}/mod_weight": f32(512, cin),
                     f"{name}/mod_bias": f32(cin), f"{name}/bias": 0.2 * f32(cout)})
        if k == 3:
            vars[f"{name}/noise_strength"] = np.float32(rng.uniform(0, 0.5))

    conv("G_synthesis/4x4/Conv", ch[4], ch[4], 3)
    conv("G_synthesis/4x4/ToRGB", ch[4], 3, 1)
    for log in range(3, int(np.log2(size)) + 1):
        r = 2 ** log
        conv(f"G_synthesis/{r}x{r}/Conv0_up", ch[r // 2], ch[r], 3)
        conv(f"G_synthesis/{r}x{r}/Conv1", ch[r], ch[r], 3)
        conv(f"G_synthesis/{r}x{r}/ToRGB", ch[r], 3, 1)
    for i in range(2 * int(np.log2(size)) - 3):
        res = 2 ** ((i + 5) // 2)
        vars[f"G_synthesis/noise{i}"] = f32(1, 1, res, res)
    vars["dlatent_avg"] = 0.1 * f32(512)
    return vars


def convert_phase(dev, card, work):
    """28. convert_weight on seeded TF variables at 256px, full widths: the
    CLI's render of 16 images on the card (TF32 off, cuDNN deterministic)
    against the same CLI on the CPU to 1e-3, then the generate CLI on the
    converted .npz. Returns the render's launches."""
    import io

    from content_aware_gan_compression_torch import convert_weight
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.makedirs(os.path.join(work, "tf"))
    os.makedirs(os.path.join(work, "converted"))
    vars_path = os.path.join(work, "tf", "ffhq256.npz")
    np.savez(vars_path, **tf_generator_vars(SIZE, seed=21))
    cwd = os.getcwd()
    renders, seconds = {}, {}
    os.chdir(os.path.join(work, "converted"))  # the CLI writes <name>.npz and .png here
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            for device in ("cuda", "cpu"):
                reset_counts()
                t0 = time.time()
                with contextlib.redirect_stdout(io.StringIO()):
                    renders[device] = convert_weight.main([vars_path, "--device", device])
                seconds[device] = round(time.time() - t0, 3)
                if device == "cuda":
                    launched = counts()
    finally:
        os.chdir(cwd)
    err = (renders["cuda"] - renders["cpu"]).abs().max().item()
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "content_aware_gan_compression_torch.generate",
                           "--ckpt", os.path.join(work, "converted", "ffhq256.npz"),
                           "--sample", "4",
                           "--out_dir", os.path.join(work, "sample")],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    gen_s = time.time() - t0
    png = os.path.join(work, "sample", "000000.png")
    detail("convert_path", card=card, size=SIZE, images=list(renders["cuda"].shape),
           seconds=seconds, max_abs_err_vs_cpu=err, tolerance=1e-3, tf32=False,
           max_abs_value=renders["cpu"].abs().max().item(),
           launches={k: launched[k] for k in ("blur4", "blur4_vector",
                                              "fused_noise_bias_lrelu", "masked_scale")},
           generate_cli_s=round(gen_s, 3), generate_rc=proc.returncode)
    if (tuple(renders["cuda"].shape) != (16, 3, SIZE, SIZE) or not err <= 1e-3
            or not torch.isfinite(renders["cuda"]).all()):
        fail(f"convert_weight render: shape {tuple(renders['cuda'].shape)}, card vs CPU {err}")
    if launched["blur4"] != 6 or launched["fused_noise_bias_lrelu"] != 13:
        fail(f"convert_weight render launched {launched}; want blur4 6, epilogue 13")
    if proc.returncode != 0 or not os.path.exists(png):
        fail(f"generate CLI on the converted .npz: rc {proc.returncode} {proc.stderr[-3000:]}")
    shutil.rmtree(work)
    return launched


def down_vs_plain(dev):
    """29. ModulatedConv2d(downsample=True) on [16, 256, 256, 128] in float32
    and bfloat16 (cuDNN deterministic, TF32 off): blur4 (pad (2, 2), one
    launch each) against the same conv under plain_routes, float32 to 1e-5
    of the plain output's largest value, bfloat16 bit for bit (blur4's
    bounds). Returns the launches."""
    from content_aware_gan_compression_torch.models.stylegan2 import ModulatedConv2d
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts

    conv = ModulatedConv2d(128, 128, 3, 512, downsample=True,
                           generator=torch.Generator().manual_seed(31)).to(dev)
    gen = torch.Generator(dev).manual_seed(32)
    x = torch.randn(BATCH, SIZE, SIZE, 128, generator=gen, device=dev)
    style = torch.randn(BATCH, 512, generator=gen, device=dev)
    results, launched = {}, {}
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                     deterministic=True, allow_tf32=False):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            reset_counts()
            got, _ = conv(x.to(dtype), style.to(dtype))
            torch.cuda.synchronize()
            launched[name] = counts()
            with plain_routes():
                want, _ = conv(x.to(dtype), style.to(dtype))
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            results[name] = {"max_abs_err": err, "max_abs_value": scale,
                             "shape": list(got.shape)}
            tol = 1e-5 * scale if dtype == torch.float32 else 0.0
            if tuple(got.shape) != (BATCH, SIZE // 2, SIZE // 2, 128) or not err <= tol:
                fail(f"down conv {name}: max_abs_err {err} > {tol}, shape {tuple(got.shape)}")
            if launched[name]["blur4"] != 1 or launched[name]["blur4_vector"] != 1:
                fail(f"down conv {name}: blur4 launched {launched[name]}, want 1 on float4 "
                     "lanes")
    detail("down_vs_plain", pad=list(conv.blur_pad), results=results,
           launches={k: {kk: v[kk] for kk in ("blur4", "blur4_bf16", "blur4_vector")}
                     for k, v in launched.items()},
           tolerance="float32 1e-5 of the plain output's largest value; bfloat16 bit for bit")
    if tuple(conv.blur_pad) != (2, 2):
        fail(f"down conv blur pad {conv.blur_pad}, want (2, 2)")
    return {"blur4": launched["float32"]["blur4"] + launched["bfloat16"]["blur4"]}


# -- path_1024: the 1024px operating point, with remat -----------------------------

SIZE_1024 = 1024  # the reference's 1024px FFHQ generator; bench.py's batch 16, path batch 8
FID_1024_BATCHES = (32, 64)  # fid_batch sizes of the 1024px feature stream
FID_1024_N_BATCH = 2  # batches streamed at each


def net_shapes_1024():
    """(the full-width 1024px generator's net_shape, the 11x student's)."""
    from content_aware_gan_compression_torch.models import default_net_shape

    full = tuple(default_net_shape(SIZE_1024))
    return full, tuple(c - int(c * 0.7) for c in full)


def hold_epilogue_2_31(rng):
    """The epilogue at FID's [64, 1024, 1024, 32] (batch 64, the full-width
    generator's last epilogue): 2^31 elements, past 32-bit indexing. Held
    against the plain version in batch chunks of 8 to 1e-6 of its largest
    value, and timed against its bytes bound. Returns the details."""
    from content_aware_gan_compression_torch.bench_blur4 import bound, time_ms
    from content_aware_gan_compression_torch.ops.cuda import (
        counts, fused_noise_bias_lrelu, fused_noise_bias_lrelu_plain, reset_counts)

    dev = rng.device
    shape = (64, *student_epilogue_shapes(1, net_shapes_1024()[0])[-1][1:])
    x = torch.randn(shape, generator=rng, device=dev)
    noise = torch.randn((*shape[:3], 1), generator=rng, device=dev)
    bias = 0.5 * torch.randn(shape[3], generator=rng, device=dev)
    nw = torch.tensor([0.7], device=dev)
    reset_counts()
    got = fused_noise_bias_lrelu(x, noise, bias, nw)
    launched = counts()["fused_noise_bias_lrelu"]
    err, scale, negatives = 0.0, 0.0, 0
    for i in range(0, shape[0], 8):
        want = fused_noise_bias_lrelu_plain(x[i:i + 8], noise[i:i + 8], bias, nw)
        err = max(err, (got[i:i + 8] - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
        negatives += int((want < 0).sum().item())
        del want
    if launched != 1 or not err <= 1e-6 * scale:
        fail(f"epilogue at {shape} ({x.numel()} elements): {launched} launches, max_abs_err "
             f"{err} > 1e-6 * {scale}")
    del got
    t_bound, t_by = bound(4 * (2 * x.numel() + noise.numel() + shape[3]),
                          3 * x.numel() + negatives + noise.numel())
    ms = time_ms(lambda: fused_noise_bias_lrelu(x, noise, bias, nw), iters=5)
    del x, noise
    torch.cuda.empty_cache()
    return {"shape": list(shape), "elements": int(np.prod(shape)), "max_abs_err": err,
            "ms": ms, "bound_ms": t_bound, "bound_by": t_by, "bound_share": t_bound / ms,
            "plain_ms": "not measured: the plain version's temporaries at 2^31 elements"}


def times_1024(rng, dtype):
    """The three kernels in ``dtype`` at the 1024px path's largest shapes:
    ms against the bytes bound, the plain version and one PyTorch library
    call (F.conv2d depthwise on the channels-last view for blur4,
    aten.leaky_relu_backward for masked_scale; none for the epilogue)."""
    from content_aware_gan_compression_torch.bench_blur4 import blur4_bound, bound, time_ms
    from content_aware_gan_compression_torch.ops import make_kernel
    from content_aware_gan_compression_torch.ops.cuda import (
        blur4, blur4_plain, correlation_taps, fused_noise_bias_lrelu,
        fused_noise_bias_lrelu_plain, lane_width, masked_scale, masked_scale_plain)

    dev, size = rng.device, torch.tensor([], dtype=dtype).element_size()
    k4 = make_kernel([1, 3, 3, 1])
    full, student = net_shapes_1024()
    s_blurs, s_epilogues = student_blur_shapes(BATCH, student), student_epilogue_shapes(BATCH,
                                                                                          student)
    out = {"blur4": [], "fused_noise_bias_lrelu": [], "masked_scale": []}
    for shape, pad, gain, role in [
            (student_blur_shapes(BATCH, full)[-1], (1, 1), 4.0, "teacher's last up-blur"),
            (discriminator_blur_cases(SIZE_1024)[0][0], (2, 2), 1.0, "D's first conv blur"),
            (s_blurs[-2], (1, 1), 4.0, "11x student's next-to-last up-blur"),
            (s_blurs[-1], (1, 1), 4.0, "11x student's last up-blur")]:
        x = torch.randn(shape, generator=rng, device=dev).to(dtype)
        c, taps = shape[3], correlation_taps(k4, gain)
        w_dw = (k4 * gain).flip(0, 1).reshape(1, 1, 4, 4).repeat(c, 1, 1, 1).to(dev, dtype)
        x_nchw = x.permute(0, 3, 1, 2)
        t_bound, t_by = blur4_bound(shape, pad, itemsize=size)
        out["blur4"].append({
            "shape": list(shape), "pad": list(pad), "role": role,
            "lanes": lane_width(c, x.data_ptr(), 0, itemsize=size),
            "ms": time_ms(lambda: blur4(x, k4, pad, gain)),
            "plain_ms": time_ms(lambda: blur4_plain(x, taps, pad), iters=5),
            "bound_ms": t_bound, "bound_by": t_by,
            "library_ms": time_ms(lambda: torch.nn.functional.conv2d(
                x_nchw, w_dw, padding=pad[0], groups=c), iters=5)})
        del x, x_nchw
    for shape, role in [(student_epilogue_shapes(BATCH, full)[-1], "teacher's last epilogue"),
                        (s_epilogues[-1], "11x student's last epilogue")]:
        x = torch.randn(shape, generator=rng, device=dev).to(dtype)
        noise = torch.randn((*shape[:3], 1), generator=rng, device=dev).to(dtype)
        bias = (0.5 * torch.randn(shape[3], generator=rng, device=dev)).to(dtype)
        nw = torch.tensor([0.7], device=dev).to(dtype)
        negatives = int((fused_noise_bias_lrelu_plain(x, noise, bias, nw) < 0).sum().item())
        f_bound, f_by = bound(size * (2 * x.numel() + noise.numel() + shape[3]),
                              3 * x.numel() + negatives + noise.numel())
        out["fused_noise_bias_lrelu"].append({
            "shape": list(shape), "role": role,
            "ms": time_ms(lambda: fused_noise_bias_lrelu(x, noise, bias, nw)),
            "plain_ms": time_ms(lambda: fused_noise_bias_lrelu_plain(x, noise, bias, nw),
                                iters=5),
            "bound_ms": f_bound, "bound_by": f_by, "library_ms": None})
        del x, noise
    for shape in (s_epilogues[-1], student_epilogue_shapes(PATH_BATCH, student)[-1]):
        g_in = torch.randn(shape, generator=rng, device=dev).to(dtype)
        o = torch.randn(shape, generator=rng, device=dev).to(dtype)
        negatives = int((o < 0).sum().item())
        m_bound, m_by = bound(3 * size * o.numel(), 2 * o.numel() + negatives)
        out["masked_scale"].append({
            "shape": list(shape), "role": "11x student's last epilogue, backward",
            "ms": time_ms(lambda: masked_scale(g_in, o)),
            "plain_ms": time_ms(lambda: masked_scale_plain(g_in, o), iters=5),
            "bound_ms": m_bound, "bound_by": m_by,
            "library_ms": time_ms(lambda: torch.ops.aten.leaky_relu_backward(g_in, o, 0.2,
                                                                              True))})
        del g_in, o
    for rows in out.values():
        for t in rows:
            t["bound_share"] = t["bound_ms"] / t["ms"]
    torch.cuda.empty_cache()
    return out


def kernels_1024_vs_plain(rng, card):
    """Each kernel against its plain version at every shape the 1024px
    retraining path gives it, at batch 16 and the path batch 8, forward and
    backward, float32 and bfloat16, with phase 2's, 5's and 5b's bounds (the
    teacher's up-blurs and epilogues forward only: it runs without
    gradients); the epilogue at FID's [64, 1024, 1024, 32]; and the times at
    the largest shapes. Returns the details."""
    full, student = net_shapes_1024()
    d_cases = [(shape, pad, 1.0, False) for shape, pad in discriminator_blur_cases(SIZE_1024)]
    student_blurs = student_blur_shapes(BATCH, student) + student_blur_shapes(PATH_BATCH, student)
    blur_cases = [(s, (1, 1), 4.0, False) for s in student_blur_shapes(BATCH, full)
                  + student_blurs] + d_cases
    student_epilogues = (student_epilogue_shapes(BATCH, student)
                         + student_epilogue_shapes(PATH_BATCH, student))
    fused_cases = [(s, s[0]) for s in student_epilogue_shapes(BATCH, full) + student_epilogues]
    bw_blur = [(s, (1, 1), 4.0, False) for s in student_blurs] + d_cases
    bw_epilogue = [(s, s[0], False) for s in student_epilogues]
    t0 = time.time()
    blur_err, fused_err, ms_err = hold_forward(blur_cases, fused_cases, student_epilogues, rng)
    bw_blur_err, bw_fused_err = hold_backward(bw_blur, bw_epilogue, rng)
    torch.cuda.empty_cache()
    bf16_err, bf16_bw = hold_bf16(blur_cases, fused_cases, student_epilogues, bw_blur,
                                  bw_epilogue, rng)
    torch.cuda.empty_cache()
    held_s = time.time() - t0
    fid_epilogue = hold_epilogue_2_31(rng)
    times = {"float32": times_1024(rng, torch.float32),
             "bfloat16": times_1024(rng, torch.bfloat16)}
    out = {"cases": {"blur4": len(blur_cases), "epilogue": len(fused_cases),
                     "masked_scale": len(student_epilogues), "blur4_backward": len(bw_blur),
                     "epilogue_backward": len(bw_epilogue)},
           "float32": {"max_abs_err": {"blur4": blur_err, "fused_noise_bias_lrelu": fused_err,
                                       "masked_scale": ms_err},
                       "max_rel_err_backward": {"blur4": bw_blur_err,
                                                "fused_noise_bias_lrelu": bw_fused_err}},
           "bfloat16": {"max_abs_err": bf16_err, "max_rel_err_backward": bf16_bw},
           "epilogue_2_31": fid_epilogue, "times": times}
    detail("kernels_1024_vs_plain", size=SIZE_1024, student=list(student), seconds_held=round(
        held_s, 1), card=card, **out,
        tolerance="float32: blur4 1e-5 * max|x|, epilogue and masked_scale 1e-6 of the plain "
                  "version's largest value, backward and double backward 1e-5; bfloat16: "
                  "forward bit for bit, backward 2^-7")
    return out


def train_1024(dev, card, work):
    """bf16 full_kd retraining at 1024px (bench.py's configuration): the 11x
    student, the full-width teacher and D, batch 16, path batch 8, seeded
    full-width LPIPS-VGG16 and BiSeNet; iterations 0-4 (R1 at 0, path
    length at 0 and 4) with ``--remat``, each phase's launches against
    ``train_phase_launches(10, remat=True)`` and all of them bf16, finite
    losses, peak memory; the same without remat (it fits the card's 80 GB
    too), its launches against the plain form; then,
    beside the remat trainer's resident state, the extra memory of one
    feature batch of the in-loop FID (g_ema and a full-width Inception) at
    fid_batch 32. Returns (the remat run's launches, the details)."""
    from content_aware_gan_compression_torch.evaluation.fid import _draw_features
    from content_aware_gan_compression_torch.models import InceptionV3
    from content_aware_gan_compression_torch.ops.cuda import reset_counts
    from content_aware_gan_compression_torch.train import Trainer
    from content_aware_gan_compression_torch.utils import load_generator

    _, student_shape = net_shapes_1024()
    student, teacher = write_train_checkpoints(work, SIZE_1024)
    reals = np.random.RandomState(10).randint(0, 256, (2, BATCH, SIZE_1024, SIZE_1024, 3),
                                              dtype=np.uint8)
    torch.backends.cudnn.allow_tf32 = True
    t_net = load_generator(teacher, SIZE_1024, device=dev).eval()
    with torch.no_grad():
        pick_gen = torch.Generator(dev).manual_seed(7)
        t_img = t_net([torch.randn(BATCH, 512, generator=pick_gen, device=dev)],
                      noise=t_net.make_noise(BATCH, pick_gen), output_format="NHWC")
        parser, parser_seed, pick_share = pick_parser(t_img)
    del t_img, t_net
    out, remat_launches = {}, None
    for remat in (True, False):
        cfg = train_config(SIZE_1024, BATCH, student, teacher, "full_kd",
                           compute_dtype="bfloat16", remat=remat)
        tr = Trainer(cfg, device=dev, lpips_params=seeded_lpips(), parse_params=parser)
        if tr.g.config.net_shape != student_shape:
            fail(f"1024px student net_shape {tr.g.config.net_shape}, want {student_shape}")
        want_phase = train_phase_launches(int(np.log2(SIZE_1024)), remat=remat,
                                          student_vector=student_lanes(student_shape, 8))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mpl = torch.zeros((), device=dev)
        phases, metrics, iter_s, phase_peak = [], [], [], {}
        count = phase_counter(phases)

        def hook(name):
            count(name)
            phase_peak[name] = max(phase_peak.get(name, 0.0),
                                   torch.cuda.max_memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for it in range(5):
            t0 = time.time()
            m, mpl = tr.step(it, reals[it % 2], mpl, phase_hook=hook)
            torch.cuda.synchronize()
            iter_s.append(round(time.time() - t0, 3))
            metrics.append({k: v.item() for k, v in m.items()})
        peak = max(phase_peak.values())
        launches = {}
        for name, c in phases:
            want = dict(want_phase[name])
            got = {k: c[k] for k in want}
            got_bf16 = {k: c[f"{k}_bf16"] for k in want}
            if got != want or got_bf16 != want:
                fail(f"1024px bf16 train phase {name} (remat {remat}) launched {got} "
                     f"({got_bf16} in bf16), want {want}, all bf16")
            for k, v in c.items():
                launches[k] = launches.get(k, 0) + v
        if not all(np.isfinite(v) for m in metrics for v in m.values()):
            fail(f"1024px bf16 training (remat {remat}): a loss is not finite: {metrics}")
        if not all(m["kd_lpips_loss"] > 0 and m["kd_l1_loss"] > 0 for m in metrics):
            fail(f"1024px full_kd (remat {remat}): a KD term is not > 0: {metrics}")
        run = {"launches": launches, "per_phase_want": want_phase, "metrics": metrics,
               "iteration_seconds": iter_s, "peak_memory_gb": peak,
               "peak_memory_gb_per_phase": phase_peak, "phases": [n for n, _ in phases]}
        if remat:
            remat_launches = launches
            # the in-loop FID beside the resident trainer: g_ema (the student,
            # float32) and a full-width Inception at fid_batch 32
            inc = InceptionV3(device=dev, generator=torch.Generator().manual_seed(INCEPTION_SEED))
            inc = inc.eval()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _draw_features(tr.g_ema, inc, 32, torch.Generator(dev).manual_seed(0), 1.0, None)
            torch.cuda.synchronize()
            run["in_loop_fid_batch_32"] = {
                "resident_gb": base / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "above_resident_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "training_peak_gb": peak, "card_gb": torch.cuda.get_device_properties(
                    dev).total_memory / 1e9}
            del inc
        out["remat" if remat else "no_remat"] = run
        del tr
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    # the same draws and weights: the same losses (not held: cuDNN's default
    # algorithms may sum in another order from run to run)
    out["losses_remat_vs_no_remat_max_rel_diff"] = max(
        abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
        for a, b in zip(out["remat"]["metrics"], out["no_remat"]["metrics"]) for k in b)
    detail("train_1024", size=SIZE_1024, batch=BATCH, path_batch=PATH_BATCH,
           compute_dtype="bfloat16", objective="full_kd", student=list(student_shape),
           parser=f"BiSeNet, full width, seed {parser_seed} (mask keeps {pick_share:.4f} of "
                  f"the picking batch)",
           lpips="LPIPS-VGG16, full width, seed 5", card=card, **out,
           note="PyTorch's defaults (cuDNN TF32 on); iterations 0-4, R1 at 0, path length "
                "at 0 and 4; peak memory over the 5 iterations, and each phase's; the "
                "losses of the two runs compared, not held (cuDNN's default algorithms)")
    return remat_launches, out


def remat_vs_plain_64(dev, work):
    """Iteration 0 of the KD-L1 Trainer at 64px, batch 4, float32, TF32 off,
    cuDNN's deterministic algorithms, lr 0, with remat and without, on the
    same draws: each phase's gradient, tensor by tensor, within 1e-5 of its
    largest value (expected bit for bit: the replayed blocks run the same
    kernels on the same inputs). Returns the details."""
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts
    from content_aware_gan_compression_torch.train import Trainer

    student, teacher = write_train_checkpoints(work, 64)
    real = np.random.RandomState(11).randint(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    grads, launches, draws = {}, {}, None
    for remat in (False, True):
        tr = Trainer(train_config(64, 4, student, teacher, "kd_l1", init_lr=0.0, remat=remat),
                     device=dev)
        if draws is None:
            draws = tr.draw(0)
        got = {}

        def hook(name, tr=tr, got=got):
            if name in ("d", "d_reg", "g", "g_reg"):
                net = tr.d if name.startswith("d") else tr.g
                got[name] = {n: p.grad.clone() for n, p in net.named_parameters()
                             if p.grad is not None}
        reset_counts()
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                         allow_tf32=False):
            tr.step(0, real, torch.zeros((), device=dev), draws=draws, phase_hook=hook)
        torch.cuda.synchronize()
        grads[remat], launches[remat] = got, counts()
        del tr
    worst, bit_equal = {}, True
    for phase, ref in grads[False].items():
        if set(grads[True][phase]) != set(ref):
            fail(f"remat_vs_plain_64: phase {phase} gave gradients to other parameters")
        errs = [max_rel_err(grads[True][phase][n], t) for n, t in ref.items()]
        bit_equal &= all(torch.equal(grads[True][phase][n], t) for n, t in ref.items())
        worst[phase] = max(errs)
    out = {"max_rel_err_per_phase": worst, "bit_for_bit": bit_equal,
           "launches": {"no_remat": launches[False], "remat": launches[True]}}
    detail("remat_vs_plain_64", size=64, batch=4, dtype="float32", tf32=False, lr=0.0,
           cudnn_deterministic=True, **out,
           tolerance="each gradient tensor within 1e-5 of its largest value")
    if not all(v <= 1e-5 for v in worst.values()):
        fail(f"remat_vs_plain_64: gradients with remat differ from without: {worst}")
    if not launches[True]["blur4"] > launches[False]["blur4"]:
        fail(f"remat_vs_plain_64: remat replayed no blur: {launches}")
    return out


def generate_fid_1024(dev, card, work):
    """Generate and FID at 1024px on the full-width generator (seed 0):
    ``generate --size 1024`` on a seeded .npz writes its grid; a feature
    stream of FID_1024_N_BATCH batches at each of FID_1024_BATCHES through
    a full-width seeded Inception (at 64 the generator's last activation,
    [64, 1024, 1024, 32], has 2^31 elements), 8 blur4 (float4) and 17
    epilogue launches per batch, finite features; Inception's pool3
    features of a batch of 2 of the card's images on the card against the
    CPU's to 1e-3 of the largest, as eval_cuda_vs_cpu holds them, TF32 off.
    Returns the launches per batch size."""
    from content_aware_gan_compression_torch.evaluation import extract_feature_from_samples
    from content_aware_gan_compression_torch.models import (
        Generator, GeneratorConfig, InceptionV3)
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts
    from content_aware_gan_compression_torch.utils import save_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    cfg = GeneratorConfig(size=SIZE_1024)
    g = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    randomize_epilogues(g, 1)
    ckpt = os.path.join(work, "g1024_seed0.npz")
    save_checkpoint(ckpt, {"g_ema": g.state_dict()}, metadata={"size": SIZE_1024, "seed": 0})
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "content_aware_gan_compression_torch.generate",
                           "--ckpt", ckpt, "--size", str(SIZE_1024), "--out_dir",
                           os.path.join(work, "sample1024")],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.time() - t0
    png = os.path.join(work, "sample1024", "000000.png")
    if proc.returncode != 0 or not os.path.exists(png):
        fail(f"generate --size 1024 rc {proc.returncode}: {proc.stderr[-3000:]}")
    with open(png, "rb") as f:
        head = f.read(24)
    side = struct.unpack(">II", head[16:24])
    if head[:8] != b"\x89PNG\r\n\x1a\n" or side != (2 + 4 * (SIZE_1024 + 2),) * 2:
        fail(f"generate --size 1024 grid {side}")

    g_card = copy.deepcopy(g).to(dev).eval()
    inc = InceptionV3(device=dev, generator=torch.Generator().manual_seed(INCEPTION_SEED)).eval()
    stream = {}
    for batch in FID_1024_BATCHES:
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        feats = extract_feature_from_samples(g_card, inc, batch_size=batch,
                                             n_sample=batch * FID_1024_N_BATCH,
                                             generator=torch.Generator(dev).manual_seed(batch))
        seconds = time.perf_counter() - t0
        c = counts()
        k = int(np.log2(SIZE_1024)) - 2  # up-blurs per batch; 2k + 1 epilogues
        want = {"blur4": k * FID_1024_N_BATCH, "blur4_vector": k * FID_1024_N_BATCH,
                "fused_noise_bias_lrelu": (2 * k + 1) * FID_1024_N_BATCH, "masked_scale": 0,
                "blur4_backward": 0}
        got = {k: c[k] for k in want}
        stream[f"fid_batch_{batch}"] = {
            "launches": got, "samples": feats.shape[0], "seconds": seconds,
            "samples_per_s": feats.shape[0] / seconds,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "last_activation_elements": batch * SIZE_1024 * SIZE_1024 * cfg.net_shape[-1],
            "finite": bool(np.isfinite(feats).all())}
        if got != want or feats.shape != (batch * FID_1024_N_BATCH, 2048) \
                or not np.isfinite(feats).all():
            fail(f"1024px FID stream at batch {batch}: launches {got} (want {want}), features "
                 f"{feats.shape}")
    # card against the CPU, as eval_cuda_vs_cpu: Inception on a batch of 2 of
    # the card's 1024px images
    gen = torch.Generator(dev).manual_seed(4)
    z = torch.randn(2, cfg.style_dim, generator=gen, device=dev)
    inc_cpu = copy.deepcopy(inc).to("cpu")
    with torch.inference_mode():
        img = g_card([z], generator=gen)
        on_card = inc(img, normalize_input=False).cpu().numpy()
        on_cpu = inc_cpu(img.cpu(), normalize_input=False).numpy()
    feat_err = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    detail("generate_fid_1024", size=SIZE_1024, generate_cli_seconds=round(cli_s, 3),
           png=list(side), inception=f"full width, seeded {INCEPTION_SEED}", **stream,
           features_cuda_vs_cpu_max_rel_err=feat_err, tf32=False, card=card,
           tolerance="Inception's pool3 features of 2 of the card's images, card vs CPU, "
                     "1e-3 of the CPU's largest")
    if not feat_err <= 1e-3:
        fail(f"1024px pool3 features on the card vs the CPU: {feat_err} > 1e-3")
    del g_card, inc, inc_cpu, g, img
    torch.cuda.empty_cache()
    return {k: v["launches"] for k, v in stream.items()}


def path_1024_phases(dev, card, work):
    """The 1024px group: kernels_1024_vs_plain, train_1024, remat_vs_plain_64
    and generate_fid_1024. Returns what the kernels line reports of it."""
    t0 = time.time()
    os.makedirs(work, exist_ok=True)
    rng = torch.Generator(dev).manual_seed(1024)
    kernels = kernels_1024_vs_plain(rng, card)
    train_launches, train = train_1024(dev, card, work)
    remat64 = remat_vs_plain_64(dev, work)
    fid_launches = generate_fid_1024(dev, card, work)
    shutil.rmtree(work, ignore_errors=True)
    detail("path_1024", seconds=round(time.time() - t0, 1))
    return {"kernels": kernels, "train_launches": train_launches, "train": train,
            "remat64": remat64, "fid_launches": fid_launches}


BENCH_WARMUP, BENCH_ITERS = 9, 16  # bench's defaults are 33 and 64


# cut settings: 32 iterations, the first cadence of 16 left out (one whole
# cadence is steady, the FID and its checkpoint at its start), a folder of
# 256px PNGs (decoded per read; phase 26 reads a 512px folder through the
# resize), a width-1/8 Inception (pool3 256: the host's float64 FID takes
# seconds at 2048), the train CLI in process (the full runs start one
# interpreter for each run); the descent 20 iterations, the FID every 10
E2E = dict(iters=32, skip=16, n_images=64, src_size=256, fid_n_sample=256,
           inception_width_scale=0.125)
DESCENT = dict(size=64, n_images=256, iters=20, fid_every=10, fid_n_sample=256,
               prune_n_sample=100, ppl_n_sample=256, inception_width_scale=0.125)


def check_bench_line(out):
    """``bench``'s one JSON line: ``bench.py``'s keys (and ``remat`` off,
    peak memory) and the full objective."""
    keys = {"metric", "value", "unit", "vs_baseline", "mfu", "objective", "remat",
            "peak_memory_gb"}
    if (set(out) != keys or out["objective"] != "full_kd"
            or out["metric"] != "retrain_iters_per_sec" or not out["value"] > 0
            or out["remat"] is not False or not out["peak_memory_gb"] > 0):
        fail(f"bench printed {out}")


def e2e_checks(card, work):
    """25. ``e2e_checks``: the port's two end-to-end tools at cut settings.
    ``python -m content_aware_gan_compression_torch.tools.e2e_validation``
    in a subprocess, its train CLI in that process, at 256px, batch 16, bf16
    full_kd: the train CLI for E2E['iters'] iterations from a folder of
    E2E['src_size'] PNGs and from a 256px cache, one overlapped FID of 256
    samples at the middle, the steady rates from E2E['skip'] on, then bench
    in a fresh interpreter over BENCH_ITERS iterations after BENCH_WARMUP,
    whose one JSON line (the tool refuses any other output) is this smoke's
    bench line.
    ``tools.fid_descent_validation`` in this process with its CLIs in
    process, the launch counts reset before it and read after: 64px,
    DESCENT's sizes. Every step must exit cleanly, every rate, FID and PPL be
    finite and positive, and each kernel launch during the descent; the
    descent itself is reported, held only in the full run. Returns (bench's
    line, the e2e tool's seconds of bench, the descent's launch counts)."""
    from content_aware_gan_compression_torch.ops.cuda import counts, reset_counts
    from content_aware_gan_compression_torch.tools import fid_descent_validation

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    argv = [f"--{k}={v}" for k, v in E2E.items()] + [
        "--workdir", os.path.join(work, "e2e"), "--bench_warmup", str(BENCH_WARMUP),
        "--bench_iters", str(BENCH_ITERS), "--in_process"]
    proc = subprocess.run([sys.executable, "-m",
                           "content_aware_gan_compression_torch.tools.e2e_validation", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"e2e_validation rc {proc.returncode}: {proc.stderr[-3000:]}")
    e2e = json.loads(proc.stdout.strip().splitlines()[-1])
    e2e_s = time.time() - t0
    check_bench_line(e2e["bench"])
    rates = {name: {k: src[k] for k in ("window_median_iters_per_s", "median_iters_per_s",
                                        "mean_iters_per_s", "steady_iters", "wall_s",
                                        "loader", "image_size")}
             for name, src in e2e["sources"].items()}
    for name, src in e2e["sources"].items():
        fids = [f["fid"] for f in src["fid"]]
        if not (len(fids) == 1 and all(np.isfinite(v) and v > 0 for v in fids)
                and all(np.isfinite(src[k]) and src[k] > 0
                        for k in ("window_median_iters_per_s", "median_iters_per_s",
                                  "mean_iters_per_s"))
                and src["steady_iters"] == E2E["iters"] - E2E["skip"]):
            fail(f"e2e_validation, {name}: {src}")

    t0 = time.time()
    argv = [f"--{k}={v}" for k, v in DESCENT.items()] + [
        "--workdir", os.path.join(work, "descent"), "--in_process", "--no-require_descent"]
    torch.backends.cudnn.allow_tf32 = True  # a fresh process's default, as in the CLIs
    reset_counts()
    with open(os.path.join(work, "descent_tool.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        descent = fid_descent_validation.main(argv)
    torch.cuda.synchronize()
    descent_counts = counts()
    torch.backends.cudnn.allow_tf32 = False
    descent_s = time.time() - t0
    fids = [descent["teacher_fid_noise_floor"], descent["student_fid_iter0"],
            *(f["fid"] for f in descent["series"])]
    if (not all(np.isfinite(v) and v > 0 for v in fids + [descent["ppl_pruned_iter0"],
                                                           descent["ppl_retrained_final"]])
            or [f["iter"] for f in descent["series"]] != list(range(
                DESCENT["fid_every"], DESCENT["iters"] + 1, DESCENT["fid_every"]))):
        fail(f"fid_descent_validation: {descent}")
    if not all(total_launches(descent_counts, k) > 0
               for k in ("blur4", "fused_noise_bias_lrelu", "masked_scale")):
        fail(f"fid_descent_validation launched {descent_counts}")
    print(f"e2e_checks: train CLI it/s over iterations {E2E['skip']}-{E2E['iters'] - 1} "
          f"(all their time; the median 16-iteration window) folder "
          f"{rates['folder']['mean_iters_per_s']:.4f} "
          f"({rates['folder']['window_median_iters_per_s']:.4f}), cache "
          f"{rates['cache']['mean_iters_per_s']:.4f} "
          f"({rates['cache']['window_median_iters_per_s']:.4f}); bench "
          f"{e2e['bench_iters_per_s']:.4f} iter/s; FID descent (64px) pruned "
          f"{descent['student_fid_iter0']:.4g} -> {[round(f['fid'], 4) for f in descent['series']]}"
          f", teacher {descent['teacher_fid_noise_floor']:.4g}", flush=True)
    detail("e2e_checks", card=card, e2e_seconds=round(e2e_s, 1),
           descent_seconds=round(descent_s, 1),
           e2e={**{k: e2e[k] for k in ("value", "bench_iters_per_s", "gap_vs_bench",
                                       "gap_vs_bench_window", "gap_vs_bench_median",
                                       "pillow", "iters", "skip", "fid_n_sample")},
                "sources": rates, "fid": {k: v["fid"] for k, v in e2e["sources"].items()}},
           descent={k: descent[k] for k in (
               "teacher_fid_noise_floor", "student_fid_iter0", "series", "descending",
               "floor_ordering_ok", "ppl_pruned_iter0", "ppl_retrained_final", "seconds",
               "parser_seed")},
           descent_launches=descent_counts,
           note="cut settings; the descent is held only in the tool's full run")
    return e2e["bench"], e2e["bench_wall_s"], descent_counts


def main(argv=None):
    p = argparse.ArgumentParser(description="the port's smoke test on the card")
    p.add_argument("--dp_cards", default=None,
                   help="only dp_nccl_cards at these card counts, e.g. 1,2,4")
    p.add_argument("--bench_world", action="store_true",
                   help="only bench_world (bench and train_time_profiler under torchrun on 2 "
                        "cards)")
    args = p.parse_args(argv)
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    if args.dp_cards:
        return dp_cards_only([int(n) for n in args.dp_cards.split(",")])
    if args.bench_world:
        from content_aware_gan_compression_torch.ops.cuda import build

        card = card_line()
        print(card, flush=True)
        build.build()
        return 0 if bench_world_phase(card) else 1
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
    if os.path.exists(DETAILS):
        os.remove(DETAILS)
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
    # the projector's: batch 1 at full width
    one_blur_shapes, one_fused_shapes = generator_layer_shapes(1)
    blur_cases += [(s, (1, 1), 4.0, False) for s in one_blur_shapes]
    # the epilogue also at the student's training shapes (C = 154, 77, 39)
    fused_cases = [(s, s[0]) for s in fused_shapes + eval_fused_shapes + prune_fused_shapes
                   + student_epilogue_shapes(PRUNE_BATCH) + one_fused_shapes
                   + student_epilogue_shapes(BATCH) + student_epilogue_shapes(PATH_BATCH)] + [
        ((2, 5, 7, 3), 2), ((2, 6, 6, 130), 1), ((16, 8, 8, 512), 1)]
    # the student's training shapes, the full-width scoring batch's and the
    # projector's
    ms_cases = student_epilogue_shapes(BATCH) + student_epilogue_shapes(PATH_BATCH) + \
        prune_fused_shapes + one_fused_shapes + [(2, 5, 7, 3), (3, 9, 9, 39), (2, 6, 6, 130)]
    reset_counts()
    blur_err, fused_err, ms_err = hold_forward(blur_cases, fused_cases, ms_cases, rng)
    blur_counts = counts()
    detail("blur4_vs_plain", cases=len(blur_cases), max_abs_err=blur_err,
           launches=blur_counts["blur4"], vector_launches=blur_counts["blur4_vector"],
           tolerance="1e-5 * max|x| per case")
    detail("fused_vs_plain", cases=len(fused_cases), max_abs_err=fused_err,
           tolerance="1e-6 * max|plain| per case")
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
    # (shape, pad, gain, misaligned view)
    bw_cases = [(shape, (1, 1), 4.0, False)
                for shape in student_blur_shapes(BATCH) + student_blur_shapes(PATH_BATCH)
                + prune_blur_shapes + one_blur_shapes] + [
        (shape, pad, 1.0, False) for shape, pad in discriminator_blur_cases()] + [
        ((BATCH, 33, 33, 512), (1, 1), 4.0, True), ((PATH_BATCH, 129, 129, 77), (2, 2), 1.0, True)]
    # (shape, noise batch, noise gradient): training's (no noise gradient),
    # the noise gradient with a per-sample and a broadcast noise, and the
    # projector's at batch 1
    epilogue_cases = [(s, s[0], False) for s in student_epilogue_shapes(BATCH)] + [
        (s, nb, True) for s in student_epilogue_shapes(BATCH) for nb in (BATCH, 1)] + [
        (s, 1, True) for s in one_fused_shapes]
    reset_counts()
    bw_blur_err, bw_fused_err = hold_backward(bw_cases, epilogue_cases, rng)
    detail("backward_vs_plain", blur4_cases=len(bw_cases), blur4_max_rel_err=bw_blur_err,
           epilogue_cases=len(epilogue_cases), epilogue_max_rel_err=bw_fused_err,
           launches=counts(),
           tolerance="1e-5 of the plain version's largest value, first and second order")

    # -- 5b. the kernels in bfloat16 against their plain versions ---------------
    # G's and the student's up-blurs, D's blurs and a misaligned view; the
    # epilogue at the generator's and the student's shapes; masked_scale at
    # the student's (the largest [16,256,256,39]); backward and double
    # backward at the student's blurs, D's and a misaligned view, and the
    # epilogue at the student's shapes, with the noise gradient (per-sample
    # and broadcast) at the three largest
    bf16_blur_cases = [(s, (1, 1), 4.0, False) for s in blur_shapes + student_blur_shapes(BATCH)] \
        + [(shape, pad, 1.0, False) for shape, pad in discriminator_blur_cases()] \
        + [((BATCH, 129, 129, 154), (1, 1), 4.0, True)]
    bf16_fused_cases = [(s, s[0]) for s in fused_shapes + student_epilogue_shapes(BATCH)
                        + student_epilogue_shapes(PATH_BATCH)]
    bf16_bw_blur = [(s, (1, 1), 4.0, False) for s in student_blur_shapes(BATCH)] + [
        (shape, pad, 1.0, False) for shape, pad in discriminator_blur_cases()] + [
        ((PATH_BATCH, 129, 129, 77), (2, 2), 1.0, True)]
    bf16_epilogue = [(s, s[0], False) for s in student_epilogue_shapes(BATCH)] + [
        (s, nb, True) for s in student_epilogue_shapes(BATCH)[-3:] for nb in (BATCH, 1)]
    t0 = time.time()
    bf16_err, bf16_bw = hold_bf16(bf16_blur_cases, bf16_fused_cases,
                                  student_epilogue_shapes(BATCH), bf16_bw_blur, bf16_epilogue, rng)
    bf16_kernel_times = bf16_times(rng, blur_shapes[-1], fused_shapes[-1],
                                   (BATCH, SIZE, SIZE, STUDENT_SHAPE[-1]))
    detail("bf16_kernels_vs_plain", seconds=round(time.time() - t0, 1),
           blur4_cases=len(bf16_blur_cases), epilogue_cases=len(bf16_fused_cases),
           masked_scale_cases=len(student_epilogue_shapes(BATCH)), max_abs_err=bf16_err,
           backward_cases={"blur4": len(bf16_bw_blur), "epilogue": len(bf16_epilogue)},
           backward_max_rel_err=bf16_bw, times=bf16_kernel_times, card=card,
           tolerance="forward bit for bit; backward and double backward 2^-7 of the plain "
                     "version's largest value (the epilogue against its Function under "
                     "plain_routes; epilogue_vs_autograd_of_plain reported, not held)")

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

    # -- 7 and 7b. one iteration at 64px on the card against float64 on the
    # CPU, in float32 and bfloat16; beside phase 8 (``beside``) ------------------
    float64_checks = beside(deterministic(float64_phases), work, dev)

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
    # the resume runs in bf16 with nu stored in bf16, from the float32 run's
    # checkpoint: `train --dtype bfloat16` on the card
    for label, extra in (("train", ["--ckpt", student, "--iter", "2"]),
                         ("resume", ["--load_train_state", "True", "--iter", "3", "--dtype",
                                     "bfloat16", "--opt_state_dtype", "bfloat16"])):
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
                      "dtype": [ln.strip() for ln in proc.stdout.splitlines()
                                if "Compute dtype" in ln],
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
            or any(c["warnings"] for c in cli.values())
            or cli["resume"]["dtype"] != ["Compute dtype: bfloat16"]):
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

    small_checks, bf16_checks, bf16_seconds = float64_checks.result()
    detail("train_cuda_vs_cpu", size=64, batch=4, tf32=False, lr=0.0,
           cudnn_deterministic=True, **small_checks, beside="train_cli",
           measure="largest |a-b| / max|float64| over each phase's parameter tensors",
           tolerance="card <= 2 * cpu + 1e-4, per phase and for the losses")
    detail("train_bf16_vs_float64", size=64, batch=4, tf32=False, lr=0.0, compute_dtype="bfloat16",
           cudnn_deterministic=True, seconds=bf16_seconds, **bf16_checks, beside="train_cli",
           measure="|a-b| / |float64| over each phase's parameter gradients as one vector",
           tolerance="card <= 2 * cpu + 1e-3, per phase and for the losses")

    # -- 7c. the bfloat16 retraining path at 256px and its rate ------------------
    t0 = time.time()
    bf16_launches, bf16_rates = bf16_train_phases(student, teacher, parser, reals, want_phase,
                                                  dev)
    detail("train_rate_bf16", size=SIZE, batch=BATCH, path_batch=PATH_BATCH,
           compute_dtype="bfloat16", objective="full_kd", seconds=round(time.time() - t0, 1),
           launches=bf16_launches, per_phase_want={k: want_phase[k] for k in want_phase},
           **bf16_rates, window="iterations 16-31 as train_rate's full_kd window",
           note="PyTorch's defaults (cuDNN TF32 on, matmul TF32 off); full-width seeded "
                "LPIPS-VGG16 and BiSeNet; launches from iterations 0-4, opt_state float32, "
                "every one a bf16 launch")

    # -- 8b. data parallel: world size 1 over NCCL, 2 ranks on one card ---------
    dp_launches, dp_world1 = dp_world1_phase(student, teacher, parser, reals, want_phase, dev,
                                             work)
    detail("dp_world1_nccl", size=SIZE, batch=BATCH, path_batch=PATH_BATCH,
           compute_dtype="bfloat16", objective="full_kd", backend="nccl", world_size=1,
           launches=dp_launches, card=card, **dp_world1,
           window="iterations 16-31 as train_rate_bf16's, under its cuDNN flags; turns in "
                  "order; collectives off = the helpers' one-process path in the same "
                  "process, on = the NCCL group's; the instrumented window (CUDA events on "
                  "every all-reduce) comes last",
           note="iterations 0-4 under cuDNN's deterministic algorithms, one process and "
                "then the NCCL group, bit for bit")
    dp_two = dp_two_ranks_phase(dev, work)
    dp_cards = dp_cards_phase(work, cache, student, teacher, (vgg_file, lins_file, parsing_file))
    if dp_cards is not None:
        detail("dp_nccl_cards", card=card, **dp_cards)
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
    # the pair at the student's widths, both types
    pair_times = fused_pair_times(rng)
    detail("fused_pair_times", card=card, **pair_times,
           note="median ms of 20 launches, CUDA events; bound: the bytes each input read once "
                "and each output written once at 3.35 TB/s; library: "
                "aten.leaky_relu_backward for masked_scale, none for the epilogue")

    # -- training rate over one cadence window: iterations 16-31 --------------
    # full_kd over the whole window; KD-L1, for the cost of the full
    # objective beside it, over its first half (1 R1 and 2 path-length steps
    # in 8 iterations); under PyTorch's defaults only (the TF32-off windows
    # made room for path_1024; PERF.md keeps their last numbers)
    train_rate = {}
    torch.backends.cudnn.allow_tf32 = True
    for objective, tr, window in (("full_kd", full, range(16, 32)),
                                  ("kd_l1", trainer, range(16, 24))):
        train_rate[f"{objective}_pytorch_defaults"], _ = train_window(
            tr, reals, torch.zeros((), device=dev), window, profile=objective == "full_kd")
    torch.backends.cudnn.allow_tf32 = False
    detail("train_rate", size=SIZE, batch=BATCH, path_batch=PATH_BATCH, dtype="float32",
           window="full_kd iterations 16-31: 16 D and G steps, 1 R1, 4 path length; "
                  "kd_l1 iterations 16-23: 8 D and G steps, 1 R1, 2 path length; "
                  "device_time: iterations 16 (R1, path length), 17 (neither) and 20 (path "
                  "length) profiled, weighted by their kinds' counts in the window (full_kd "
                  "1, 12, 3; kd_l1 1, 6, 1)",
           **train_rate,
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
    sparsity_counts = sparsity_phases(g, dev, card, os.path.join(REPO, "build", "chip_smoke"))
    projector_counts = projector_phases(g, dev, card, os.path.join(REPO, "build", "chip_smoke"))

    # -- 25. e2e_checks: the train CLI's steady rate beside bench, whose line it
    # gives, and FID descent through the CLIs, both at cut settings ---------------
    bench_line, bench_s, descent_counts = e2e_checks(card, os.path.join(REPO, "build",
                                                                        "chip_smoke_e2e"))
    detail("bench", seconds=round(bench_s, 1), card=card, line=bench_line,
           note="run by tools.e2e_validation in e2e_checks")

    # -- 26-29. the data path, the profiler, the converter, the down conv ----------
    work = os.path.join(REPO, "build", "chip_smoke")
    data_counts = data_phases(dev, card, work, bench_line)
    profiler_counts = profiler_phase(card, os.path.join(REPO, "build", "chip_smoke_profile"))
    bench_world_phase(card)
    convert_counts = convert_phase(dev, card, work)
    down_counts = down_vs_plain(dev)

    # -- 30. path_1024: the 1024px operating point, with remat ---------------------
    p1024 = path_1024_phases(dev, card, os.path.join(REPO, "build", "chip_smoke_1024"))

    def new_paths(name, vector=False):
        """The kernels line's launches of ``name`` on the sparsity and
        projector paths (blur4: forward + backward)."""
        total = (lambda c: c["blur4"] + c["blur4_backward"]) if name == "blur4" else (
            lambda c: c[name])
        out = {"launches_sparsity_before_prune": total(sparsity_counts["before_prune"]),
               "launches_sparsity_after_prune": total(sparsity_counts["after_prune"]),
               "launches_projector_adam": total(projector_counts["Adam"]),
               "launches_projector_lbfgs": total(projector_counts["LBFGS"])}
        if vector:
            out["vector_launches_sparsity_after_prune"] = \
                sparsity_counts["after_prune"]["blur4_vector"]
        # the train CLI and SparsityTrainer from image folders,
        # the profiler (bfloat16), convert_weight's render and the down conv
        out["launches_train_cli_folder"] = total_launches(data_counts["train_cli_folder"], name)
        out["launches_sparsity_folder"] = total_launches(data_counts["sparsity_folder"], name)
        out["launches_profiler_bf16"] = total_launches(profiler_counts, name)
        out["launches_convert_render"] = total_launches(convert_counts, name)
        out["launches_e2e_descent"] = total_launches(descent_counts, name)
        if name == "blur4":
            out["launches_down_conv"] = down_counts["blur4"]
        return out

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
         **new_paths("blur4", vector=True),
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
         "launches_prune": prune_counts["fused_noise_bias_lrelu"],
         "vector_launches": full_launches["fused_noise_bias_lrelu_vector"],
         **new_paths("fused_noise_bias_lrelu"), "max_abs_err": fused_err,
         "max_rel_err_backward": bw_fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound,
         "bound_by": fused_by, "library_ms": None, "shape": list(f_shape),
         "shapes": pair_times["fused_noise_bias_lrelu"]},
        {"name": "masked_scale", "route": "cuda",
         "source": "content_aware_gan_compression_torch/csrc/masked_scale.cu",
         "replaces": "content_aware_gan_compression_tpu/ops/pallas/fused_act_pallas.py:73",
         "launches": full_launches["masked_scale"],
         "launches_kd_l1": train_launches["masked_scale"],
         "launches_fid": eval_launches["fid"]["masked_scale"],
         "launches_ppl": eval_launches["ppl"]["masked_scale"],
         "launches_prune": prune_counts["masked_scale"], **new_paths("masked_scale"),
         "max_abs_err": ms_err, "ms": ms_ms,
         "plain_ms": ms_plain_ms, "bound_ms": ms_bound, "bound_by": ms_by,
         "library_ms": ms_lib_ms, "library": "aten.leaky_relu_backward (no sqrt(2), mask > 0)",
         "shape": list(m_shape), "shapes": pair_times["masked_scale"]},
    ]
    # the bfloat16 forms: launches from the bfloat16 retraining path
    # (train_rate_bf16, iterations 0-4), errors and times from
    # bf16_kernels_vs_plain
    bf16_entry = {
        "blur4": {"launches": bf16_launches["blur4_bf16"] + bf16_launches["blur4_backward_bf16"],
                  "launches_forward": bf16_launches["blur4_bf16"],
                  "launches_backward": bf16_launches["blur4_backward_bf16"],
                  "vector_launches": bf16_launches["blur4_vector_bf16"],
                  "max_rel_err_backward": bf16_bw["blur4"]},
        "fused_noise_bias_lrelu": {
            "launches": bf16_launches["fused_noise_bias_lrelu_bf16"],
            "max_rel_err_backward": bf16_bw["epilogue"],
            "max_rel_err_backward_vs_autograd_of_plain": bf16_bw["epilogue_vs_autograd_of_plain"]},
        "masked_scale": {"launches": bf16_launches["masked_scale_bf16"],
                         "shapes": pair_times["masked_scale_bf16"]}}
    bf16_entry["fused_noise_bias_lrelu"]["shapes"] = pair_times["fused_noise_bias_lrelu_bf16"]
    bf16_entry["fused_noise_bias_lrelu"]["vector_launches"] = \
        bf16_launches["fused_noise_bias_lrelu_vector_bf16"]
    # the data-parallel paths: each rank's launches on 2 gloo ranks (64px,
    # float32) and the NCCL world-size-1 run's (256px, bfloat16)
    for entry in kernels:
        entry["launches_dp_two_ranks_per_rank"] = total_launches(
            dp_two["launches_per_rank"], entry["name"])
    for name in bf16_entry:
        bf16_entry[name]["launches_dp_world1_nccl"] = total_launches(
            {k[:-len("_bf16")]: v for k, v in dp_launches.items() if k.endswith("_bf16")}, name)
    # path_1024: float32 from the 1024px FID stream and the 64px remat check,
    # bfloat16 from the 1024px retraining; errors and times at the 1024px shapes
    k1024 = p1024["kernels"]
    for entry in kernels:
        name = entry["name"]
        for batch, c in p1024["fid_launches"].items():
            entry[f"launches_1024_{batch}"] = total_launches(c, name)
        entry["launches_remat_64"] = total_launches(p1024["remat64"]["launches"]["remat"], name)
        entry["max_abs_err_1024"] = k1024["float32"]["max_abs_err"][name]
        entry["times_1024"] = k1024["times"]["float32"][name]
        if name == "fused_noise_bias_lrelu":
            entry["epilogue_2_31"] = k1024["epilogue_2_31"]
    for name in bf16_entry:
        for run in ("remat", "no_remat"):
            bf16_entry[name][f"launches_train_1024_{run}"] = total_launches(
                {k[:-len("_bf16")]: v for k, v in p1024["train"][run]["launches"].items()
                 if k.endswith("_bf16")}, name)
        bf16_entry[name]["max_abs_err_1024"] = k1024["bfloat16"]["max_abs_err"][name]
        bf16_entry[name]["times_1024"] = k1024["times"]["bfloat16"][name]
    for entry in list(kernels):
        name = entry["name"]
        t = bf16_kernel_times[name]
        kernels.append({"name": f"{name}_bf16", "route": "cuda", "source": entry["source"],
                        "replaces": entry["replaces"], **bf16_entry[name],
                        "max_abs_err": bf16_err[name],
                        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "shape")}})
    detail("done", seconds=round(time.time() - t_start, 1))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
