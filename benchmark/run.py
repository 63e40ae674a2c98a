"""Runs one cell of the benchmark of ``content_aware_gan_compression_torch``
and prints its result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by the names in ``BENCHMARK.json``
(``lib/manifest.py``). A cell on 4 cards is run by this script under
``torch.distributed.run``, one process per card; rank 0 hands its result back
and this process prints it. The run fails, and prints no result, without the
cards the cell asks for, and when JAX or the JAX package has been imported.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "content_aware_gan_compression_tpu")
T0_ENV, RESULT_ENV = "BENCHMARK_T0", "BENCHMARK_RESULT_FILE"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def launch(argv, chips: int) -> int:
    """This script under ``torch.distributed.run``, one process per card;
    prints rank 0's result. NCCL's shared-memory transport is off, so the
    run leaves nothing in /dev/shm: the cards talk over NVLink."""
    with tempfile.TemporaryDirectory(prefix="bench_ranks_") as tmp:
        result = os.path.join(tmp, "result.json")
        env = {**os.environ, T0_ENV: repr(T0), RESULT_ENV: result, "NCCL_SHM_DISABLE": "1"}
        rc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc_per_node={chips}", __file__, *argv], env=env).returncode
        if rc != 0 or not os.path.exists(result):
            print(f"the ranks ended with code {rc} and no result", file=sys.stderr)
            return rc or 1
        with open(result) as f:
            out = json.load(f)
    return emit(out)


def emit(out: dict) -> int:
    """The compared numbers with their limits as the last lines of standard
    error, then the result as the last line of standard output."""
    found = forbidden_modules()
    if found:
        print(f"refusing to report: loaded {found}", file=sys.stderr)
        return 3
    for name, v in out["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def result_line(args, cell, ctx, out) -> dict:
    from benchmark.lib import compare, gpu, manifest

    limits = ctx.limits
    numbers = out["numbers"]
    correct = (numbers is not None and out["failed"] == 0
               and compare.within(numbers, limits))
    if args.trace:
        metrics = {}
        for m in manifest.per_layer(args.workload):
            value = manifest.reader(m["name"])(out["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        name, value, unit = out["rate"]
        metrics = {name: {"value": value, "unit": unit},
                   "setup_s": {"value": out["setup_s"], "unit": "s"}}
    device = gpu.device_line(ctx.device, cell["chips"], out["peak_bytes"])
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = out["layer"]["busy_s"]
        device["window_s"] = out["layer"]["window_s"]
        line["breakdown"] = out["layer"]["breakdown"]
    line["compared"] = {k: {"value": v, "limit": limits.get(k)}
                        for k, v in (numbers or {}).items()}
    return line


def measure(args, cell) -> int:
    import torch

    from benchmark.lib import manifest
    from benchmark.lib.context import Context

    world = int(os.environ.get("WORLD_SIZE", "1"))
    t0 = float(os.environ.get(T0_ENV, repr(T0)))
    host_group = None
    if world > 1:
        import torch.distributed as dist

        from content_aware_gan_compression_torch import parallel

        device = parallel.initialize("cuda")
        host_group = dist.new_group(backend="gloo")
        rank = dist.get_rank()
    else:
        device, rank = torch.device("cuda", 0), 0
        torch.cuda.set_device(device)
    traffic = manifest.traffic(cell["traffic"])
    ctx = Context(name=args.workload, cell=cell, config=manifest.config(cell["config"]),
                  traffic=traffic, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t0=t0, rank=rank, world=world,
                  host_group=host_group)
    out = manifest.driver(traffic["driver"]).run(ctx)
    line = result_line(args, cell, ctx, out) if rank == 0 else None
    if world > 1:
        dist.barrier(group=host_group)  # the other ranks wait for rank 0's check
        parallel.finalize()
        if rank == 0:
            found = forbidden_modules()
            if found:
                print(f"refusing to report: loaded {found}", file=sys.stderr)
                return 3
            with open(os.environ[RESULT_ENV], "w") as f:
                json.dump(line, f)
        return 0
    return emit(line)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    from benchmark.lib import gpu, manifest

    cell = manifest.cell(args.workload)
    gpu.require(cell["chips"])
    if cell["chips"] > 1 and "LOCAL_RANK" not in os.environ:
        return launch(argv, cell["chips"])
    return measure(args, cell)


if __name__ == "__main__":
    sys.exit(main())
