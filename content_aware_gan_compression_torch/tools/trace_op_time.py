"""Summarize the port's ``torch.profiler`` Chrome traces by kernel category,
by aten op with its input shapes, and by kernel (the port's counterpart of
the JAX round's ``tools/trace_op_time.py``, which reads ``jax.profiler``
traces):

    python -m content_aware_gan_compression_torch.tools.trace_op_time
        <trace_dir> [top_n] [--iters N]

Reads every ``*.json`` / ``*.json.gz`` Chrome trace under ``trace_dir`` (or
the one file given) and merges them, saying so: ``bench --trace_dir`` and
``train_time_profiler --trace_dir`` under torchrun write one per rank, so a
merged figure is the world's sum. The device events are the ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` ones; a device event of another category
(``gpu_user_annotation``: a ``record_function`` range drawn over the
kernels it holds) nests those and is left out, and its time is printed.

Each device event belongs to the innermost ``cpu_op`` that launched it:
the op whose ``External id`` the event carries (the profiler pushes each
op's id when the op starts, so a launch carries the innermost open op's).
The ops of each thread nest by time; that tree decides the rest.

Executed FLOPs are counted from the recorded input shapes and arguments
(``record_shapes=True``) of these ops, each where no op around it is
counted already (``aten::convolution`` holds ``aten::_convolution``;
``aten::linear`` holds ``aten::addmm``):

- ``aten::convolution`` / ``aten::_convolution``: 2 x N x C_out x H_out x
  W_out x C_in / groups x kh x kw, with stride, padding, dilation and
  groups; a transposed one 2 x N x C_in x H_in x W_in x C_out / groups x
  kh x kw;
- ``aten::convolution_backward``: that count for each of the input gradient
  and the weight gradient its output mask asks for (the bias gradient, a
  sum, counts none);
- ``aten::mm``, ``aten::addmm``, ``aten::bmm``, ``aten::linear``: 2 x the
  product's multiply-adds.

Every other op counts none; the report lists the ops it counted. The
profiler's own ``with_flops`` covers forward convolutions and matrix
products only, so the backward and double-backward convolutions of R1 and
path length would go uncounted; checkpointed blocks' replays are executed
work and count. A counted op's FLOPs go to the device events it launched,
by their share of its device time; an op's input bytes likewise to the
events it launched itself.

Prints the device busy time (the sum of the device events' durations, so
two streams' overlap counts twice; the union is printed beside it) over
the trace window, and per iteration with ``--iters``; then a table by
category (the port's three kernels by name, cuDNN convolution, GEMM, NCCL,
copies, reductions, elementwise, other), the top ``top_n`` aten ops with
their input shapes, and the top ``top_n`` kernels by name with their launch
counts. Each row: ms (per iteration with ``--iters``), % of the busy time,
TF/s of the FLOPs attributed to it and, where its ops' input tensors give
them, GB/s of those inputs. ``load_events`` and ``executed_flops`` are what
``bench --trace_dir`` uses. The JAX tool's xprof ``hlo_stats`` reader reads
TPU traces only and has no counterpart.
"""

from __future__ import annotations

import argparse
import ast
import collections
import dataclasses
import glob
import gzip
import json
import math
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CONV_OPS = ("aten::convolution", "aten::_convolution")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::linear")
COUNTED_OPS = CONV_OPS + ("aten::convolution_backward",) + MATMUL_OPS
# bytes per element of the profiler's "Input type" strings
ITEM_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2, "int": 4,
              "long int": 8, "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
              "c10::complex<float>": 8, "c10::complex<double>": 16}
# the port's kernels (csrc/*.cu), by a part of their mangled names
PORT_KERNELS = (("blur4_tiled", "blur4"), ("fnbl_kernel", "epilogue"),
                ("masked_scale_kernel", "masked_scale"))
CATEGORIES = ("blur4", "epilogue", "masked_scale", "cuDNN convolution", "GEMM", "NCCL",
              "copies", "reductions", "elementwise", "other")


@dataclasses.dataclass
class Op:
    """A ``cpu_op`` event: its name, input shapes and types, concrete
    arguments (as recorded: strings), the op around it on its thread, and
    its FLOPs and input bytes."""
    name: str
    ts: float
    end: float
    dims: list
    types: list
    concrete: list
    parent: "Op | None" = None
    flops: float = 0.0
    bytes: float = 0.0

    def shapes(self) -> str:
        tensors = [d for d in self.dims if d]
        dtype = next((t for t, d in zip(self.types, self.dims) if d), "")
        return f"{tensors} {dtype}".strip()

    def counted(self) -> "Op | None":
        """The outermost counted op this op lies in (itself included), if
        any: the one that holds the FLOPs (``aten::convolution_backward``
        may run ``aten::_convolution`` inside)."""
        out, op = None, self
        while op is not None:
            if op.name in COUNTED_OPS:
                out = op
            op = op.parent
        return out


@dataclasses.dataclass
class Trace:
    """The merged traces: ``device`` events (each a dict with ``op``, the
    innermost ``Op`` that launched it, or None) and every ``Op``."""
    device: list
    ops: list


def trace_files(path) -> list:
    """The Chrome traces under a folder (``*.json``, ``*.json.gz``), or the
    one file given."""
    if os.path.isfile(path):
        return [path]
    files = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
                   + glob.glob(os.path.join(path, "**", "*.json.gz"), recursive=True))
    if not files:
        raise SystemExit(f"no *.json or *.json.gz trace under {path}")
    return files


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _concrete(value):
    if not isinstance(value, str) or value == "":
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _input_bytes(dims, types) -> float:
    total = 0
    for d, t in zip(dims, types):
        if d and t in ITEM_BYTES:
            total += math.prod(d) * ITEM_BYTES[t]
    return float(total)


def _nest(ops):
    """Give each op of one thread the innermost op that encloses it."""
    stack = []
    for op in sorted(ops, key=lambda o: (o.ts, -o.end)):
        while stack and stack[-1].end < op.end:
            stack.pop()
        op.parent = stack[-1] if stack else None
        stack.append(op)


def load_events(path, log=print) -> Trace:
    """The device events and ops of every Chrome trace at ``path`` (a folder
    or a file), merged; says what it merged and what it left out."""
    files = trace_files(path)
    if len(files) > 1:
        log(f"# merging {len(files)} trace files under {path}")
    device, all_ops, excluded = [], [], collections.Counter()
    for path_i in files:
        events = _read(path_i)
        events = events["traceEvents"] if isinstance(events, dict) else events
        by_thread, by_id, mine = collections.defaultdict(list), {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args", {})
            if cat == "cpu_op":
                op = Op(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                        args.get("Input Dims", []), args.get("Input type", []),
                        args.get("Concrete Inputs", []))
                op.bytes = _input_bytes(op.dims, op.types)
                by_thread[(e.get("pid"), e.get("tid"))].append(op)
                if "External id" in args:
                    by_id[args["External id"]] = op
            elif cat in DEVICE_CATEGORIES:
                mine.append(e)
            elif cat.startswith("gpu_"):
                excluded[cat] += float(e.get("dur", 0))
        for ops in by_thread.values():
            _nest(ops)
            all_ops += ops
        for e in mine:
            e["op"] = by_id.get(e.get("args", {}).get("External id"))
        device += mine
    if excluded:
        log("# left out, device events that nest the ones counted: " + ", ".join(
            f"{c} {d / 1e3:.3f} ms" for c, d in excluded.most_common()))
    for op in all_ops:  # each counted op not inside another counted op
        op.flops = op_flops(op) if op.counted() is op else 0.0
    return Trace(device, all_ops)


# -- FLOPs ------------------------------------------------------------------------
def _per_dim(v, n):
    """A stride, padding or dilation for each of ``n`` spatial dims."""
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return v * n if len(v) == 1 else v


def conv_flops(x, w, stride, padding, dilation, transposed, groups) -> float:
    """Multiply-adds x 2 of one convolution: input dims ``x`` [N, C_in,
    *spatial], weight dims ``w``."""
    nd = len(x) - 2
    k = math.prod(w[2:])
    if transposed:  # weight [C_in, C_out / groups, *k]: each input pixel to k outputs
        return 2.0 * x[0] * x[1] * math.prod(x[2:]) * w[1] * k
    stride, padding, dilation = (_per_dim(v, nd) for v in (stride, padding, dilation))
    out = [(x[2 + i] + 2 * padding[i] - dilation[i] * (w[2 + i] - 1) - 1) // stride[i] + 1
           for i in range(nd)]
    return 2.0 * x[0] * w[0] * math.prod(out) * (x[1] // groups) * k


def op_flops(op: Op) -> float:
    """The executed FLOPs of one counted op from its recorded inputs."""
    d, c = op.dims, [_concrete(v) for v in op.concrete]
    if op.name in CONV_OPS:
        return conv_flops(d[0], d[1], c[3], c[4], c[5], bool(c[6]), int(c[8]))
    if op.name == "aten::convolution_backward":
        # (grad_output, input, weight, bias_sizes, stride, padding, dilation,
        # transposed, output_padding, groups, output_mask)
        one = conv_flops(d[1], d[2], c[4], c[5], c[6], bool(c[7]), int(c[9]))
        return one * sum(bool(m) for m in c[10][:2])
    if op.name == "aten::mm":
        return 2.0 * d[0][0] * d[0][1] * d[1][1]
    if op.name == "aten::addmm":
        return 2.0 * d[1][0] * d[1][1] * d[2][1]
    if op.name == "aten::bmm":
        return 2.0 * d[0][0] * d[0][1] * d[0][2] * d[1][2]
    if op.name == "aten::linear":
        return 2.0 * math.prod(d[0]) * d[1][0]
    return 0.0


def executed_flops(trace: Trace) -> float:
    """The executed FLOPs of every counted op of the trace."""
    return sum(op.flops for op in trace.ops)


def counted_ops(trace: Trace) -> dict:
    """{op name: (calls, FLOPs)} of the ops whose FLOPs were counted."""
    out = collections.defaultdict(lambda: [0, 0.0])
    for op in trace.ops:
        if op.flops:
            out[op.name][0] += 1
            out[op.name][1] += op.flops
    return {k: tuple(v) for k, v in sorted(out.items())}


# -- attribution ------------------------------------------------------------------
def category(event) -> str:
    """The table's category of one device event."""
    name, op = event.get("name", ""), event.get("op")
    for part, label in PORT_KERNELS:
        if part in name:
            return label
    lower = name.lower()
    if "nccl" in lower:
        return "NCCL"
    if event.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copies"
    chain = []
    while op is not None:
        chain.append(op.name)
        op = op.parent
    if any("conv" in n for n in chain) or "conv" in lower:
        return "cuDNN convolution"
    if any(n in MATMUL_OPS or n == "aten::matmul" for n in chain) or "gemm" in lower:
        return "GEMM"
    if "copy" in lower:
        return "copies"
    if "reduce" in lower:
        return "reductions"
    if "elementwise" in lower or "foreach" in lower:
        return "elementwise"
    return "other"


def attribute(trace: Trace) -> list:
    """One row per device event: (event, its category, us, FLOPs, bytes).
    A counted op's FLOPs split over the events launched inside it by their
    durations, an op's input bytes over the events it launched itself."""
    under_counted = collections.defaultdict(float)
    under_op = collections.defaultdict(float)
    for e in trace.device:
        op = e["op"]
        if op is not None:
            under_op[id(op)] += float(e.get("dur", 0))
            top = op.counted()
            if top is not None:
                under_counted[id(top)] += float(e.get("dur", 0))
    rows = []
    for e in trace.device:
        dur, op = float(e.get("dur", 0)), e["op"]
        flops = by = 0.0
        if op is not None:
            top = op.counted()
            if top is not None and under_counted[id(top)]:
                flops = top.flops * dur / under_counted[id(top)]
            if under_op[id(op)]:
                by = op.bytes * dur / under_op[id(op)]
        rows.append((e, category(e), dur, flops, by))
    return rows


def busy_union(device) -> float:
    """The time in us when at least one device event runs."""
    total, end = 0.0, -math.inf
    for ts, te in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                         for e in device):
        if te > end:
            total += te - max(ts, end)
            end = te
    return total


def summarize(trace: Trace) -> dict:
    """The report's figures: busy, window and union (us), and the three
    tables as {key: [us, FLOPs, bytes, count]}; counts are launches, or an
    op's calls in the op table."""
    rows = attribute(trace)
    cats = {c: [0.0, 0.0, 0.0, 0] for c in CATEGORIES}
    ops = collections.defaultdict(lambda: [0.0, 0.0, 0.0, set()])
    kernels = collections.defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    for e, cat, dur, fl, by in rows:
        for table, key in ((cats, cat), (kernels, e.get("name", "?"))):
            r = table[key]
            r[0] += dur
            r[1] += fl
            r[2] += by
            r[3] += 1
        op = e["op"]
        key = (op.name, op.shapes()) if op is not None else ("(no op)", "")
        r = ops[key]
        r[0] += dur
        r[1] += fl
        r[2] += by
        r[3].add(id(op))
    starts = [float(e["ts"]) for e in trace.device]
    ends = [float(e["ts"]) + float(e.get("dur", 0)) for e in trace.device]
    return {"busy_us": sum(r[2] for r in rows), "window_us": max(ends) - min(starts) if ends
            else 0.0, "union_us": busy_union(trace.device), "categories": cats,
            "ops": {k: [*v[:3], len(v[3])] for k, v in ops.items()}, "kernels": dict(kernels)}


def _short(name, width=110):
    return name if len(name) <= width else name[:width - 3] + "..."


def report(trace: Trace, top_n=20, iters=None, log=print) -> dict:
    """Prints the busy time, the counted ops, and the category, op and
    kernel tables; returns ``summarize``'s figures."""
    s = summarize(trace)
    total, div = s["busy_us"], iters or 1
    per = "/it" if iters else ""

    def row(t, f, b):
        tf = f / t / 1e6 if t else 0.0
        gb = f"{b / t / 1e3:8.1f}" if t and b else "       -"
        return (f"{t / div / 1e3:10.3f} ms{per} {100 * t / total if total else 0:5.1f}%  "
                f"{tf:7.2f} TF/s {gb} GB/s")

    if not trace.device:
        log("no device events (kernel, gpu_memcpy, gpu_memset) in the trace")
    log(f"device busy: {total / 1e3:.3f} ms over a {s['window_us'] / 1e3:.3f} ms window "
        f"(union of streams {s['union_us'] / 1e3:.3f} ms)"
        + (f" = {total / div / 1e3:.3f} ms/iter over {iters} iterations" if iters else ""))
    flops = executed_flops(trace)
    log(f"executed FLOPs: {flops / div:.6g}{per}, counted from "
        + (", ".join(f"{k} (n={n}, {f / div:.6g}{per})" for k, (n, f) in
                     counted_ops(trace).items()) or "no op") + "; every other op counts none")
    log("\n== by category ==")
    for c, (t, f, b, n) in sorted(s["categories"].items(), key=lambda kv: -kv[1][0]):
        log(f"{row(t, f, b)}  n={n:<7d} {c}")
    log(f"\n== top {top_n} aten ops with their input shapes (kernel time) ==")
    for (name, shapes), (t, f, b, n) in sorted(s["ops"].items(),
                                               key=lambda kv: -kv[1][0])[:top_n]:
        log(f"{row(t, f, b)}  calls={n:<6d} {name} {shapes}")
    log(f"\n== top {top_n} kernels ==")
    for name, (t, f, b, n) in sorted(s["kernels"].items(), key=lambda kv: -kv[1][0])[:top_n]:
        log(f"{row(t, f, b)}  n={n:<7d} {_short(name)}")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("top_n", nargs="?", type=int, default=20)
    ap.add_argument("--iters", type=int, default=None,
                    help="training iterations inside the trace window; every figure is "
                         "also given per iteration")
    args = ap.parse_args(argv)
    return report(load_events(args.trace_dir), args.top_n, args.iters)


if __name__ == "__main__":
    main()
