"""Reads a ``torch.profiler`` Chrome trace: a frozen copy of the program's
``tools/trace_op_time.py`` (``load_events``, the categories, the busy
union, each device event tied to the op that launched it; its executed-FLOP
count is left out, since the benchmark counts model FLOPs), with what the benchmark's readers add: the device time of one category, a
hand-written kernel's bytes from its call's recorded shapes, the idle gaps
labelled by what the host was doing, and the top device operations.

Each device event belongs to the innermost ``cpu_op`` that launched it: the
op whose ``External id`` the event carries.
"""

from __future__ import annotations

import ast
import bisect
import collections
import dataclasses
import glob
import gzip
import json
import math
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::linear")
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
    its input bytes."""
    name: str
    ts: float
    end: float
    dims: list
    types: list
    concrete: list
    parent: "Op | None" = None
    bytes: float = 0.0


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
    return Trace(device, all_ops)


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


def busy_union(device) -> float:
    """The time in us when at least one device event runs."""
    total, end = 0.0, -math.inf
    for ts, te in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                         for e in device):
        if te > end:
            total += te - max(ts, end)
            end = te
    return total


# -- what the benchmark's readers add ------------------------------------------------
def category_us(trace: Trace, categories) -> float:
    """The device time (us) of the events of ``categories``."""
    return sum(float(e.get("dur", 0)) for e in trace.device if category(e) in categories)


def _children(trace: Trace) -> dict:
    out = collections.defaultdict(list)
    for op in trace.ops:
        if op.parent is not None:
            out[id(op.parent)].append(op)
    return out


def _numel_bytes(dims, dtype) -> float:
    return float(math.prod(dims)) * ITEM_BYTES.get(dtype, 4) if dims else 0.0


def call_bytes(op: Op, children: dict) -> float | None:
    """The least bytes one call of a hand-written kernel's function moves:
    each input read once and the output written once, from the call's
    recorded shapes and types. blur4's output is the ``aten::empty`` its
    call allocates (its pads are not recorded); the epilogue's and
    masked_scale's output has the shape of their first input."""
    x_dims, x_type = (op.dims[0], op.types[0]) if op.dims else (None, None)
    if not x_dims:
        return None
    if op.name == "Blur4Fn":
        sizes = [_concrete(c.concrete[0]) for c in children.get(id(op), [])
                 if c.name == "aten::empty" and c.concrete]
        sizes = [s for s in sizes if isinstance(s, list) and len(s) == len(x_dims)]
        if not sizes:
            return None
        return _numel_bytes(x_dims, x_type) + _numel_bytes(sizes[0], x_type)
    if op.name in ("FusedNoiseBiasLReLUFn", "MaskedScaleFn"):
        return op.bytes + _numel_bytes(x_dims, x_type)
    return None


def roofline_percent(trace: Trace, categories, hbm_bytes_per_s: float) -> float | None:
    """100 x (the least time the calls' bytes allow at ``hbm_bytes_per_s``,
    summed) / (their launches' device time), over the device events of
    ``categories`` that a call with recorded shapes launched; None when
    there is none."""
    children = _children(trace)
    least = spent = 0.0
    launches = collections.Counter()
    events = []
    for e in trace.device:
        if category(e) not in categories:
            continue
        op = e["op"]
        while op is not None and call_bytes(op, children) is None:
            op = op.parent
        if op is None:
            continue
        launches[id(op)] += 1
        events.append((e, op))
    for e, op in events:
        least += call_bytes(op, children) / launches[id(op)] / hbm_bytes_per_s
        spent += float(e.get("dur", 0)) * 1e-6
    return 100.0 * least / spent if spent > 0 else None


def host_label(ops_by_ts: list, starts: list, t_us: float, scan: int = 2000) -> str:
    """What the host was doing at ``t_us``: the outermost and the innermost
    op open then (the latest-started one among the ``scan`` ops that began
    last before it), or '(no op)'. ``ops_by_ts`` is sorted by start, and
    ``starts`` holds its starts."""
    i = bisect.bisect_right(starts, t_us)
    inner = None
    for op in reversed(ops_by_ts[max(0, i - scan):i]):
        if op.end > t_us:
            inner = op
            break
    if inner is None:
        return "(no op)"
    outer = inner
    while outer.parent is not None:
        outer = outer.parent
    return inner.name if outer is inner else f"{outer.name} > {inner.name}"


def idle_gaps(trace: Trace, top: int = 10) -> list:
    """The device's idle gaps inside the trace window, summed by what the
    host was doing when each began: [[label, seconds], ...], longest first."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in trace.device)
    ops = sorted(trace.ops, key=lambda o: o.ts)
    starts = [o.ts for o in ops]
    gaps, end = collections.Counter(), None
    for ts, te in spans:
        if end is not None and ts > end:
            gaps[host_label(ops, starts, end)] += (ts - end) * 1e-6
        end = te if end is None else max(end, te)
    return [[k, v] for k, v in gaps.most_common(top)]


def top_device_ops(trace: Trace, top: int = 10) -> list:
    """The device operations (kernels, copies, sets) that took the most time:
    [[name, seconds], ...]."""
    by = collections.Counter()
    for e in trace.device:
        by[e.get("name", "?")] += float(e.get("dur", 0)) * 1e-6
    return [[k if len(k) <= 160 else k[:157] + "...", v] for k, v in by.most_common(top)]
