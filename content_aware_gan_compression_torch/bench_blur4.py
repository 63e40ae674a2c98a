"""Time blur4 kernels on the card, in turns, at the 256px paths' largest shapes.

    python -m content_aware_gan_compression_torch.bench_blur4 \\
        [--other NAME=PATH[:noplan] ...] [--sweep] [--out chiprun_out/bench_blur4.json]

The kernel of ``csrc/blur4.cu``, cut by ``launch_plan``, is timed against
each ``--other`` source with the same C entry, ``blur4_forward``. ``:noplan``
marks an entry without the launch plan's arguments: the one-thread-per-output
kernel this one replaced, as an earlier commit holds it. Every source is built
with the package's nvcc flags into ``build/bench_blur4/``, all at once. At each
shape every kernel is first held against ``blur4_plain`` (1e-5 * max|x|), then
timed in turns: the others, this one twice, the others in reverse order. A
turn is the median of 20 launches timed with CUDA events, on preallocated
outputs. ``--sweep`` also times this kernel at block sizes and strip heights
other than the plan's. One JSON line per shape goes to stdout and all of them
to ``--out``. Needs a CUDA card. ``chip_smoke.py`` takes its timer and
bounds from here.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .ops import make_kernel
from .ops.cuda import build
from .ops.cuda.blur4 import blur4_plain, correlation_taps, lane_width, launch_plan

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# (input shape, pad, gain, role): G's largest up-blur, whose backward runs at
# D's shape and pad below, and the other way round; the 11x student's largest
SHAPES = [((16, 257, 257, 128), (1, 1), 4.0, "G up-blur forward; D skip blur backward"),
          ((16, 256, 256, 128), (2, 2), 1.0, "D conv blur forward; G up-blur backward"),
          ((16, 257, 257, 39), (1, 1), 4.0, "11x student's largest up-blur forward")]
SWEEP = [(threads, rows) for threads in (128, 256, 512) for rows in (4, 8, 16, 32)]


def bound(nbytes, flops):
    """The least milliseconds for ``nbytes`` of memory traffic and ``flops``
    fp32 operations, and which of the two sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def in_bounds_taps(n_in, n_out, p0):
    """Taps of a 4-tap axis that land inside the input, summed over outputs."""
    return sum(1 for o in range(n_out) for d in range(4) if 0 <= o + d - p0 < n_in)


def blur4_bound(shape, pad, itemsize=4):
    """blur4's bound: the input read once and the output written once
    (``itemsize`` bytes per element: 4 float32, 2 bfloat16), or the
    float32 multiply-adds of the taps that land inside the input."""
    b, h, w, c = shape
    ho, wo = h + sum(pad) - 3, w + sum(pad) - 3
    return bound(itemsize * b * c * (h * w + ho * wo),
                 2 * b * c * in_bounds_taps(h, ho, pad[0]) * in_bounds_taps(w, wo, pad[0]))


def build_sources(sources: dict[str, Path], folder: str = "bench_blur4"
                  ) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile every source at once into ``build/<folder>/``; {name:
    (library, ptxas report)}. The hash covers the headers beside each
    source."""
    out_dir = Path(build.BUILD_DIR).parent / folder
    out_dir.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, src in sources.items():
        headers = b"".join(p.read_bytes() for p in sorted(src.parent.glob("*.cuh")))
        digest = hashlib.sha256(src.read_bytes() + headers).hexdigest()[:16]
        lib = out_dir / f"lib{name}-{digest}.so"
        running[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        report = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        built[name] = (ctypes.CDLL(str(lib)), "; ".join(report))
    return built


def launcher(lib, with_plan, x, out, taps, pad, plan):
    """A no-argument call of the library's blur4_forward on fixed tensors."""
    fn = lib.blur4_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)] \
        + [ctypes.c_int] * (15 if with_plan else 7) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = [x.data_ptr(), out.data_ptr(), (ctypes.c_float * 16)(*taps), *x.shape, *pad]
    if with_plan:
        args += [plan.vec, plan.cv_tile, plan.tw, plan.th, plan.n_ctiles, plan.grid[0],
                 plan.grid[1], plan.smem_bytes]
    args += [x.device.index, torch.cuda.current_stream(x.device).cuda_stream]

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"blur4_forward returned CUDA error {err}")
    return call


SPIN_CYCLES = 20_000_000  # about 10 ms of the card's clock


def time_ms(fn, iters=20, warmup=3):
    """Median milliseconds of ``fn`` on the card, CUDA events around each
    call. The calls queue behind a spin of ``SPIN_CYCLES`` on the stream, so
    the host has queued them before the card reaches the first: a kernel
    shorter than its host launch is timed without the launch's gap."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=PATH[:noplan], another blur4 source to time against")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default="chiprun_out/bench_blur4.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_blur4 needs a CUDA card", file=sys.stderr)
        return 2
    others = {}
    for spec in args.other:
        name, path = spec.split("=", 1)
        path, _, kind = path.partition(":")
        others[name] = (Path(path), kind != "noplan")
    libs = build_sources({"this": build.CSRC / "blur4.cu",
                          **{name: path for name, (path, _) in others.items()}})
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k4 = make_kernel([1, 3, 3, 1])
    rng = torch.Generator(dev).manual_seed(0)
    lines = []
    for shape, pad, gain, role in SHAPES:
        x = torch.randn(shape, generator=rng, device=dev)
        taps = correlation_taps(k4, gain)
        want = blur4_plain(x, taps, pad)
        out = torch.empty_like(want)
        plan = launch_plan(shape, pad, lane_width(shape[3], x.data_ptr(), out.data_ptr()), sms)
        calls = {name: launcher(libs[name][0], with_plan, x, out, taps, pad, plan)
                 for name, with_plan in [("this", True)]
                 + [(name, with_plan) for name, (_, with_plan) in others.items()]}
        errors = {}
        for name, call in calls.items():
            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            errors[name] = (out - want).abs().max().item()
            if not errors[name] <= 1e-5 * x.abs().max().item():
                raise SystemExit(f"bench_blur4: {name} at {shape} pad {pad}: "
                                 f"max_abs_err {errors[name]}")
        order = [*others, "this", "this", *reversed(others)]
        turns = {name: [] for name in calls}
        for name in order:
            turns[name].append(time_ms(calls[name]))
        bound_ms, by = blur4_bound(shape, pad)
        line = {"shape": list(shape), "pad": list(pad), "role": role, "card": card,
                "plan": {"vec": plan.vec, "block": list(plan.block), "th": plan.th,
                         "grid": list(plan.grid)},
                "bound_ms": bound_ms, "bound_by": by,
                "kernels": {name: {"ms": statistics.median(t), "turns": t,
                                   "bound_share": bound_ms / statistics.median(t),
                                   "max_abs_err": errors[name], "ptxas": libs[name][1]}
                            for name, t in turns.items()}}
        if args.sweep:
            line["sweep"] = []
            for threads, rows in SWEEP:
                p = launch_plan(shape, pad, plan.vec, sms, threads, rows)
                call = launcher(libs["this"][0], True, x, out, taps, pad, p)
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                ok = (out - want).abs().max().item() <= 1e-5 * x.abs().max().item()
                line["sweep"].append({"block_threads": threads, "strip_rows": rows,
                                      "block": list(p.block), "th": p.th, "right": ok,
                                      "ms": time_ms(call)})
        print(json.dumps(line), flush=True)
        lines.append(line)
        del x, want, out
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
