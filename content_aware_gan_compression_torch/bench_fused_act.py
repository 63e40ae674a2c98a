"""Time the epilogue and masked_scale kernels on the card, in turns, at every
shape the paths launch them.

    python -m content_aware_gan_compression_torch.bench_fused_act \\
        [--other NAME=DIR[:noplan] ...] [--sweep] [--quick] \\
        [--out build/bench_fused_act.jsonl]

The shapes (``path_shapes``) are every epilogue of the generator, full-width
and the 11x student's, at 256px and 1024px, at batch 16 and the path batch 8
(training), 64 (FID, PPL), 10 (prune scoring) and 1 (the projector); the
epilogue takes each with per-sample noise, and the largest shapes also with a
[1, H, W, 1] noise buffer; masked_scale, the backward, each shape at the
batches that have one (all but 64). ``--quick`` keeps the largest student
and teacher shapes and three small ones only. For each kernel in float32 and bfloat16 the
package's ``csrc/`` source, cut by ``ops/cuda/lanes.py``'s plans, is timed
against each ``--other`` directory's ``fused_noise_bias_lrelu.cu`` and
``masked_scale.cu`` (whichever it holds; ``:noplan`` marks the C entries
without the plan's arguments, as the first versions had them), all built
with the package's nvcc flags into ``build/bench_fused_act/`` at once. At
each shape every kernel is first held against its plain version (bfloat16
bit for bit, float32 to 1e-6 of the largest value), then timed in turns:
the others, this one twice, the others in reverse order, each turn the
median of 20 launches timed with CUDA events (``bench_blur4.time_ms``), on
preallocated outputs; beside them the bytes bound, the plain version (not
above 2^30 elements, whose temporaries would not fit beside the inputs) and,
for masked_scale, ``aten.leaky_relu_backward``. ``--sweep`` also times this
source at every block size, lanes per thread and store kind of
``SWEEP`` at ``sweep_shapes``. One JSON line per (kernel, type, shape) goes
to ``--out``; a summary of each line to stdout. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import itertools
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .bench_blur4 import bound, build_sources, time_ms
from .models import default_net_shape
from .ops.cuda import build
from .ops.cuda.lanes import LANE_BYTES, LANES, epilogue_plan, lane_plan

# the wrappers' modules (the package's names are the wrapper functions)
epilogue_mod = importlib.import_module(f"{__package__}.ops.cuda.fused_noise_bias_lrelu")
masked_mod = importlib.import_module(f"{__package__}.ops.cuda.masked_scale")

SIZES = (256, 1024)
BATCHES = (16, 8, 64, 10, 1)  # training, path length, FID/PPL, prune scoring, projector
NO_BACKWARD = (64,)  # the evaluation batches run no backward
# threads, lanes per thread, streaming stores
SWEEP = list(itertools.product((128, 256, 512), (1, 2, 4), (False, True)))
KERNELS = ("fused_noise_bias_lrelu", "masked_scale")
ELEMENTS_PLAIN = 2 ** 30  # the most elements the plain version is timed at


def student_shape(net_shape):
    """The 11x student: int(c * 0.7) channels removed from every layer."""
    return tuple(c - int(c * 0.7) for c in net_shape)


def epilogue_shapes(batch: int, net_shape) -> list[tuple[int, int, int, int]]:
    """[B, H, W, C] of each StyledConv's epilogue, in the generator's order:
    conv1 at 4x4, then two per resolution."""
    return [(batch, 4, 4, net_shape[1])] + [
        (batch, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), net_shape[i + 1])
        for i in range(1, len(net_shape) - 1)]


def path_shapes() -> list[dict]:
    """Every (size, widths, batch)'s epilogue shapes, in the generator's
    order: {"size", "widths" ("full" or "student"), "batch", "shapes"}."""
    out = []
    for size in SIZES:
        full = tuple(default_net_shape(size))
        for widths, ns in (("full", full), ("student", student_shape(full))):
            for batch in BATCHES:
                out.append({"size": size, "widths": widths, "batch": batch,
                            "shapes": epilogue_shapes(batch, ns)})
    return out


def largest_shapes() -> list[tuple[int, int, int, int]]:
    """The teacher's and the student's last two epilogue widths at batch 16,
    at 256px and 1024px, and the student's C = 154 at 64x64: the shapes the
    bounds are held at."""
    out = []
    for size in SIZES:
        full = tuple(default_net_shape(size))
        for ns in (full, student_shape(full)):
            shapes = epilogue_shapes(16, ns)
            out += [shapes[-1], shapes[-3]]
        out.append(epilogue_shapes(16, student_shape(full))[8])  # 64x64 at C = 154
    return list(dict.fromkeys(out))


def sweep_shapes() -> list[tuple[int, int, int, int]]:
    """``largest_shapes`` and three a launch's latency dominates (the
    projector's first layer, the student's 8x8 and 32x32 at batch 16): the
    shapes ``--sweep`` and ``--quick`` take."""
    return largest_shapes() + [(1, 4, 4, 512), (16, 8, 8, 154), (16, 32, 32, 154)]


def cases(quick: bool) -> list[tuple[str, tuple, int]]:
    """(kernel, shape, noise batch) to time, each once: noise batch B for
    the epilogue, 1 too at the largest shapes; masked_scale where the batch
    has a backward (its noise batch unused, 0)."""
    largest, swept = largest_shapes(), sweep_shapes()
    shapes = {}
    for entry in path_shapes():
        for s in entry["shapes"]:
            shapes.setdefault(s, set()).add(entry["batch"])
    out = []
    for s, batches in shapes.items():
        if quick and s not in swept:
            continue
        out.append(("fused_noise_bias_lrelu", s, s[0]))
        if s in largest:
            out.append(("fused_noise_bias_lrelu", s, 1))
        if any(b not in NO_BACKWARD for b in batches):
            out.append(("masked_scale", s, 0))
    return out


def epilogue_bound(x, noise, c, negatives):
    """Bytes: x read, out written, noise and bias read once; operations: two
    adds and the gain per element, the slope where negative, one multiply
    per noise value."""
    return bound(x.element_size() * (2 * x.numel() + noise.numel() + c),
                 3 * x.numel() + negatives + noise.numel())


def masked_bound(o, negatives):
    """Bytes: g and out read, dx written; operations: the compare and the
    gain per element, the slope where out < 0."""
    return bound(3 * o.element_size() * o.numel(), 2 * o.numel() + negatives)


def entry(lib, kernel, dtype, plan_args: bool):
    """The C entry of ``kernel`` in ``dtype``, its argtypes set."""
    name = f"{kernel}_forward{'_bf16' if dtype == torch.bfloat16 else ''}"
    fn = getattr(lib, name)
    if plan_args:
        fn.argtypes = (epilogue_mod.ARGTYPES if kernel == "fused_noise_bias_lrelu"
                       else masked_mod.ARGTYPES)
    elif kernel == "fused_noise_bias_lrelu":  # (..., B, H, W, C, noise_batch, vec4, dev, stream)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    else:  # (g, out, dx, n, vec4, device, stream)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def caller(fn, plan_args, kernel, tensors, plan=None):
    """A no-argument launch of ``fn`` on fixed tensors: the epilogue's (x,
    noise, bias, nw, out) or masked_scale's (g, out, dx)."""
    first = tensors[0]
    dev, stream = first.device.index, torch.cuda.current_stream(first.device).cuda_stream
    ptrs = [t.data_ptr() for t in tensors]
    lanes = LANE_BYTES // first.element_size()
    if plan_args:
        args = ptrs + (epilogue_mod.epilogue_args(plan, dev, stream)
                       if kernel == "fused_noise_bias_lrelu"
                       else masked_mod.lane_args(plan, dev, stream))
    elif kernel == "fused_noise_bias_lrelu":
        x, noise, bias, _, out = tensors
        vec4 = x.shape[3] % lanes == 0 and all(t.data_ptr() % 16 == 0 for t in (x, bias, out))
        args = ptrs + [*x.shape, noise.shape[0], int(vec4), dev, stream]
    else:
        vec4 = all(p % 16 == 0 for p in ptrs)
        args = ptrs + [first.numel(), int(vec4), dev, stream]

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{kernel} returned CUDA error {err}")
    return call


def inputs(kernel, shape, noise_batch, dtype, gen):
    """Seeded inputs and a preallocated output; the epilogue's out last."""
    dev = gen.device
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    if kernel == "masked_scale":
        o = torch.randn(shape, generator=gen, device=dev).to(dtype)
        o.view(-1)[:3] = 0.0  # the mask is 1 at exactly 0
        return [x, o, torch.empty_like(o)]
    noise = torch.randn((noise_batch, *shape[1:3], 1), generator=gen, device=dev).to(dtype)
    bias = (0.5 * torch.randn(shape[3], generator=gen, device=dev)).to(dtype)
    nw = torch.tensor([0.7], device=dev).to(dtype)
    return [x, noise, bias, nw, torch.empty_like(x)]


def plain(kernel, tensors, rows=None):
    """The plain version on the inputs, optionally on batch rows ``rows``."""
    if kernel == "masked_scale":
        g, o = tensors[0], tensors[1]
        return masked_mod.masked_scale_plain(g, o) if rows is None else \
            masked_mod.masked_scale_plain(g[rows], o[rows])
    x, noise, bias, nw = tensors[:4]
    if rows is None:
        return epilogue_mod.fused_noise_bias_lrelu_plain(x, noise, bias, nw)
    return epilogue_mod.fused_noise_bias_lrelu_plain(
        x[rows], noise[rows] if noise.shape[0] > 1 else noise, bias, nw)


def held(kernel, tensors, call):
    """Run ``call`` on a NaN-filled output and hold it against the plain
    version, in chunks of 8 images: (max abs error, the plain version's
    largest value, negatives). bfloat16 must match bit for bit, float32 to
    1e-6 of the largest value."""
    got = tensors[-1]
    got.fill_(float("nan"))
    call()
    torch.cuda.synchronize()
    err = scale = 0.0
    negatives = 0
    for i in range(0, got.shape[0], 8):
        rows = slice(i, i + 8)
        want = plain(kernel, tensors, rows)
        err = max(err, (got[rows].float() - want.float()).abs().max().item())
        scale = max(scale, want.float().abs().max().item())
        negatives += int(((want if kernel == "fused_noise_bias_lrelu" else tensors[1][rows])
                          < 0).sum().item())
    tol = 0.0 if got.dtype == torch.bfloat16 else 1e-6 * scale
    if not err <= tol:
        raise SystemExit(f"bench_fused_act: {kernel} {got.dtype} {tuple(got.shape)}: "
                         f"max_abs_err {err} > {tol}")
    return err, negatives


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR[:noplan], a folder with other sources to time against")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="build/bench_fused_act.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fused_act needs a CUDA card", file=sys.stderr)
        return 2
    others = {}  # name -> (folder, plan arguments)
    for spec in args.other:
        name, path = spec.split("=", 1)
        path, _, kind = path.partition(":")
        others[name] = (Path(path), kind != "noplan")
    sources = {(k, "this"): build.CSRC / f"{k}.cu" for k in KERNELS}
    for name, (folder, _) in others.items():
        sources.update({(k, name): folder / f"{k}.cu" for k in KERNELS
                        if (folder / f"{k}.cu").exists()})
    built = build_sources({f"{k}__{name}": src for (k, name), src in sources.items()},
                          folder="bench_fused_act")
    libs = {(k, name): built[f"{k}__{name}"] for k, name in sources}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "ptxas": {f"{k}:{n}": libs[(k, n)][1] for k, n in libs}}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    swept = sweep_shapes()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for kernel, shape, noise_batch in cases(args.quick):
            for dtype in (torch.float32, torch.bfloat16):
                line = bench_case(kernel, shape, noise_batch, dtype, gen, libs, others, card,
                                  args.sweep and shape in swept and noise_batch != 1)
                f.write(json.dumps(line) + "\n")
                f.flush()
                k = line["kernels"]
                print(json.dumps({"kernel": kernel, "dtype": line["dtype"], "shape": list(shape),
                                  "noise_batch": noise_batch, "bound_ms": line["bound_ms"],
                                  **{n: round(v["ms"], 5) for n, v in k.items()},
                                  "plain_ms": line["plain_ms"],
                                  "library_ms": line["library_ms"],
                                  "best_sweep": line.get("best_sweep")}), flush=True)
                torch.cuda.empty_cache()
    return 0


def bench_case(kernel, shape, noise_batch, dtype, gen, libs, others, card, sweep):
    """One (kernel, type, shape): held, then timed in turns. Its JSON line."""
    tensors = inputs(kernel, shape, noise_batch, dtype, gen)
    first = tensors[0]
    aligned = all(t.data_ptr() % LANE_BYTES == 0 for t in (first, tensors[-1]))
    itemsize = first.element_size()
    plan = (epilogue_plan(shape, noise_batch, itemsize, aligned)
            if kernel == "fused_noise_bias_lrelu" else lane_plan(first.numel(), itemsize, aligned))
    calls = {"this": caller(entry(libs[(kernel, "this")][0], kernel, dtype, True), True, kernel,
                            tensors, plan)}
    for name, (_, plan_args) in others.items():
        if (kernel, name) in libs:
            calls[name] = caller(entry(libs[(kernel, name)][0], kernel, dtype, plan_args),
                                 plan_args, kernel, tensors, plan)
    errors = {}
    for name, call in calls.items():
        errors[name], negatives = held(kernel, tensors, call)
    rest = [n for n in calls if n != "this"]
    turns = {name: [] for name in calls}
    for name in [*rest, "this", "this", *reversed(rest)]:
        turns[name].append(time_ms(calls[name]))
    if kernel == "fused_noise_bias_lrelu":
        bound_ms, by = epilogue_bound(first, tensors[1], shape[3], negatives)
        library_ms = None
    else:
        bound_ms, by = masked_bound(tensors[1], negatives)
        g, o = tensors[0], tensors[1]
        library_ms = time_ms(lambda: torch.ops.aten.leaky_relu_backward(g, o, 0.2, True))
    plain_ms = (time_ms(lambda: plain(kernel, tensors), iters=5)
                if first.numel() <= ELEMENTS_PLAIN else
                f"not measured: {first.numel()} elements > 2^30")
    line = {"kernel": kernel, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
            "noise_batch": noise_batch if kernel == "fused_noise_bias_lrelu" else None,
            "card": card, "plan": {"threads": plan.threads, "vectors": plan.vectors,
                                   "streaming": plan.streaming, "blocks": plan.blocks,
                                   "vec": plan.vec,
                                   "wide_index": plan.wide_index, "lanes": LANES[itemsize]},
            "bound_ms": bound_ms, "bound_by": by, "plain_ms": plain_ms, "library_ms": library_ms,
            "kernels": {name: {"ms": statistics.median(t), "turns": t,
                               "bound_share": bound_ms / statistics.median(t),
                               "max_abs_err": errors[name]} for name, t in turns.items()}}
    if sweep:
        line["sweep"] = []
        for threads, vectors, streaming in SWEEP:
            p = (epilogue_plan(shape, noise_batch, itemsize, aligned, threads, vectors, streaming)
                 if kernel == "fused_noise_bias_lrelu"
                 else lane_plan(first.numel(), itemsize, aligned, threads, vectors, streaming))
            call = caller(entry(libs[(kernel, "this")][0], kernel, dtype, True), True, kernel,
                          tensors, p)
            err, _ = held(kernel, tensors, call)
            line["sweep"].append({"threads": threads, "vectors": vectors,
                                  "streaming": streaming, "max_abs_err": err,
                                  "ms": time_ms(call)})
        best = min(line["sweep"], key=lambda r: r["ms"])
        line["best_sweep"] = {k: best[k] for k in ("threads", "vectors", "streaming", "ms")}
    return line


if __name__ == "__main__":
    sys.exit(main())
