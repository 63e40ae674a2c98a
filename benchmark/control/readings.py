"""The readings a cell's limits are set from, on the card at the cell's own
size: the system under test against the reference over many seeds (the
lower readings), the control in the system's place (the upper readings),
and each planted fault (``faults.py``):

    python3 benchmark/control/readings.py --workload retrain-256 \\
        --seeds 12 --control 3 --faults half_batch [--out FILE]

Training cells run the benchmark's set-up and first iterations, which are
what ``correct`` compares; the control is the cell's ``control`` entry: the
reference computed in a lower precision (``reference:<kind>``) or the
system with its own lower-precision path (``program:<compute_dtype>``).
FID cells run ``--chunks`` chunks of the stream and compare every checked
row. One JSON line per reading on standard output and in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def detail(prog: dict, ref: dict) -> dict:
    """The numbers ``correct`` compares and, beside them, the first
    iteration's gap of each loss and the worst leaves of the gradient and of
    the change."""
    from benchmark.lib import compare

    first_p, first_r = prog["losses"][0], ref["losses"][0]
    out = {"numbers": compare.training_numbers(prog, ref),
           "loss_gaps": {k: compare.loss_gap(first_p, first_r, (k,)) for k in first_r}}
    for part in ("grad", "change"):
        gaps = []
        for net, leaves in ref[part].items():
            keep = compare.live_leaves(ref["grad"]["g" if net == "g_ema" else net])
            keys = [k for k in leaves if k in keep]
            med = statistics.median(leaves[k] for k in keys)
            gaps += [(abs(prog[part][net][k] - leaves[k]) / max(leaves[k], med, 1e-30),
                      f"{net}.{k}", prog[part][net][k], leaves[k]) for k in keys]
        out[f"{part}_worst"] = sorted(gaps, reverse=True)[:4]
    return out


def train_readings(args, cell, make_ctx, out):
    import torch

    from benchmark.control import faults
    from benchmark.lib import manifest

    ts = manifest.driver("train_step")
    traffic = manifest.traffic(cell["traffic"])
    control = cell["control"]
    for n, seed in enumerate(range(args.base_seed, args.base_seed + args.seeds)):
        ctx = make_ctx(seed)
        t = time.perf_counter()
        prep = ts.prepare(ctx, traffic)
        prog, pool, parser_seed = prep["readings"], prep["pool"], prep["parser_seed"]
        prep["trainer"] = None
        ts.free()
        t_ref = time.perf_counter()
        ref = (ts.reference_readings(ctx, traffic, pool, parser_seed) if ctx.rank == 0
               else None)
        out({"seed": seed, "kind": "program", "s": time.perf_counter() - t,
             "reference_s": time.perf_counter() - t_ref},
            lambda: detail(prog, ref))
        if n >= args.control:
            continue
        where, kind = control.split(":")
        if where == "reference":
            ctl = (ts.reference_readings(ctx, traffic, pool, parser_seed, kind)
                   if ctx.rank == 0 else None)
        else:
            p2 = ts.prepare(ctx, {**traffic, "compute_dtype": kind})
            ctl, p2["trainer"] = p2["readings"], None
            ts.free()
        out({"seed": seed, "kind": f"control {control}"}, lambda: detail(ctl, ref))
        for name in args.faults:
            with faults.plant(name):
                pf = ts.prepare(ctx, traffic)
            pf["trainer"] = None
            ts.free()
            out({"seed": seed, "kind": f"fault {name}"}, lambda: detail(pf["readings"], ref))
        torch.cuda.empty_cache()


def fid_readings(args, cell, make_ctx, out):
    import numpy as np
    import torch

    from benchmark.control import faults
    from benchmark.lib import manifest

    fs = manifest.driver("fid_stream")
    for n, seed in enumerate(range(args.base_seed, args.base_seed + args.seeds)):
        ctx = make_ctx(seed)
        t = ctx.traffic
        g, inc = fs.build_program(ctx)
        kept, altered = {}, {}
        for c in range(args.chunks):
            rows = fs.checked_rows(seed, c, t["chunk"], t["check_rows"])
            kept[c] = (rows, fs.extract(ctx, g, inc, t["chunk"],
                                        fs.chunk_generator(seed, c, ctx.device))[rows])
            if n < args.control and "altered_answer" in args.faults:
                with faults.plant("altered_answer"):
                    altered[c] = fs.extract(ctx, g, inc, t["chunk"],
                                            fs.chunk_generator(seed, c, ctx.device))[rows]
        del g, inc
        torch.cuda.empty_cache()
        rows = {c: v[0] for c, v in kept.items()}
        ref = fs.reference_features(ctx, rows)
        gaps = fs.feature_gaps({c: v[1] for c, v in kept.items()}, ref)
        out({"seed": seed, "kind": "program", "features": float(np.max(gaps)),
             "median": float(np.median(gaps)), "rows": len(gaps)})
        if n < args.control:
            kind = cell["control"].split(":")[1]
            ctl = fs.feature_gaps(fs.reference_features(ctx, rows, kind), ref)
            out({"seed": seed, "kind": f"control {cell['control']}",
                 "features": float(np.max(ctl)), "min_row": float(np.min(ctl)),
                 "median": float(np.median(ctl))})
            if altered:
                alt = fs.feature_gaps(altered, ref)
                out({"seed": seed, "kind": "fault altered_answer", "features": float(np.max(alt))})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--base-seed", type=int, default=2 ** 31 + 1000)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3, help="seeds that also run the control "
                   "and the faults")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--chunks", type=int, default=10, help="FID chunks a seed runs")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda:0", help="cpu rehearses the script at a "
                   "configuration's size, which only small configurations allow")
    args = p.parse_args(argv)

    import os

    import torch

    from benchmark.lib import manifest
    from benchmark.lib.context import Context

    cell = manifest.cell(args.workload)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    host_group, rank = None, 0
    if world > 1:
        import torch.distributed as dist

        from content_aware_gan_compression_torch import parallel

        device = parallel.initialize("cuda")
        host_group, rank = dist.new_group(backend="gloo"), dist.get_rank()
    else:
        device = torch.device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    sink = open(args.out, "a") if args.out and rank == 0 else None

    def out(record, more=None):
        """Rank 0 writes ``record`` and what ``more()`` adds to it."""
        if rank == 0:
            line = json.dumps({"workload": args.workload, **record, **(more() if more else {})})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()

    def make_ctx(seed):
        return Context(name=args.workload, cell=cell, config=manifest.config(cell["config"]),
                       traffic=manifest.traffic(cell["traffic"]), seed=seed, seconds=0.0,
                       trace=False, device=device, t0=time.time(), rank=rank, world=world,
                       host_group=host_group)

    driver = manifest.traffic(cell["traffic"])["driver"]
    (fid_readings if driver == "fid_stream" else train_readings)(args, cell, make_ctx, out)


if __name__ == "__main__":
    main()
