"""The train CLI's steady-state rate beside ``bench`` (the port's counterpart
of the JAX round's ``tools/e2e_validation.py``):

    python -m content_aware_gan_compression_torch.tools.e2e_validation

Writes seeded files (``fixtures``: a PNG folder at ``--src_size``, a uint8
cache at ``--size``, the student and teacher checkpoints with D, the LPIPS,
BiSeNet and FID Inception files, a real-statistics pickle), then runs the
real ``python -m content_aware_gan_compression_torch.train`` twice, from the
folder and from the cache: bf16 ``full_kd``, logging, a sample grid,
checkpoints and one overlapped in-loop FID at ``--iters // 2``. Each run's
steady-state it/s is read from its own ``metrics.jsonl`` over the iterations
from ``--skip`` on, where each iteration's ``train_time`` is its
pass-boundary time (``train/loop.py``): the mean, all the steady
iterations over all their time, the FID's and the checkpoint's share
included (the JSON line's ``value``, from the cache, and ``gap_vs_bench``);
and two per-layer figures that leave those one-time costs out: the median
of whole windows of 16 iterations (one cadence of R1 and path length at the
defaults: the least common multiple of ``--d_reg_every`` and
``--g_reg_every``), and the median of single iterations (the JAX tool's
``steady_rate``, which reads the iterations without a regularizer here).
Then ``python -m content_aware_gan_compression_torch.bench`` at the same
size, batch and dtype, always in an interpreter of its own, as a user runs
it. Prints one JSON line: both sources' rates, the data loader each took
(the CLI's own ``data_loader:`` line), ``bench``'s iter/s and ``1 - e2e /
bench`` for each rate.

Without Pillow a folder image that needs a resize cannot be read as uint8
(``data/dataset.py``), so the folder is then written at ``--size`` and the
line says so. Runs on ``cuda`` unless ``--device cpu`` is given; the
``--*width_scale``, ``--latent`` and ``--n_mlp`` flags shrink the nets for a
quick check on the CPU, and ``--in_process`` calls the train CLI's
``main`` instead of starting an interpreter for each run. The seeded files
are written anew on every run. The JAX tool's ``--data_echo``
(a TPU transport's remedy) has no counterpart.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import statistics

from .cli import REPO, line_after, run_cli


def train_times(metrics_path, skip):
    """{iteration: train_time} of a run's ``metrics.jsonl``, iterations from
    ``skip`` on."""
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f]
    times = {r["iter"]: r["train_time"] for r in recs if "train_time" in r and r["iter"] >= skip}
    if not times:
        raise RuntimeError(f"no steady-state iterations in {metrics_path}")
    return times


def steady_rate(metrics_path, skip):
    """(median it/s, mean it/s, n) over the iterations >= ``skip`` of a
    run's ``metrics.jsonl`` (the JAX tool's ``steady_rate``). The median of
    single iterations reads the iterations without a regularizer (12 of
    16); the mean keeps every one-time cost of the window (the FID, a
    checkpoint)."""
    times = list(train_times(metrics_path, skip).values())
    return 1.0 / statistics.median(times), len(times) / sum(times), len(times)


def window_rate(metrics_path, skip, window):
    """(it/s, n): ``window`` / the median seconds of the whole windows of
    ``window`` iterations from ``skip`` on. With ``window`` the cadence of
    the lazy regularizers (R1 every 16, path length every 4: 16), each
    window holds one iteration of each kind in its share, so this is the
    amortized rate with the one-time costs left out, as the JAX loop's
    median over its 16-iteration windows read it."""
    times = train_times(metrics_path, skip)
    last = max(times)
    sums = [sum(times[i] for i in range(start, start + window))
            for start in range(skip, last - window + 2, window)]
    if not sums:
        raise RuntimeError(f"no whole window of {window} iterations from {skip} in "
                           f"{metrics_path}")
    return window / statistics.median(sums), len(sums)


def fid_series(metrics_path):
    """The in-loop FID records of a run's ``metrics.jsonl``, in order:
    [{'iter': the iteration whose g_ema was scored, 'fid': ...}]."""
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f]
    return [{"iter": r.get("iter"), "fid": r["fid"]} for r in recs if "fid" in r]


def train_run(args, files, path, exp_root, log):
    """The train CLI on ``path``; returns (its standard output, seconds,
    its experiment folder)."""
    shutil.rmtree(exp_root, ignore_errors=True)
    argv = ["--path", path, "--size", args.size, "--ckpt", files["student"],
            "--teacher_ckpt", files["teacher"], "--iter", args.iters,
            "--batch_size", args.batch_size, "--dtype", "bfloat16",
            "--latent", args.latent, "--n_mlp", args.n_mlp,
            "--d_reg_every", args.d_reg_every, "--g_reg_every", args.g_reg_every,
            "--lpips_vgg_ckpt", files["vgg16"], "--lpips_lins_ckpt", files["lins"],
            "--parsing_ckpt", files["bisenet"], "--exp_root", exp_root,
            # no sample grid in the window (one at iteration 0); one FID and
            # checkpoint mid-run
            "--val_sample_freq", args.iters + 1,
            "--model_save_freq", args.iters // 2 if args.fid else args.iters + 1,
            "--fid_n_sample", args.fid_n_sample, "--device", args.device]
    if args.fid:
        argv += ["--inception_ckpt", files["inception"], "--real_stats", files["real_stats"]]
    if args.fid_batch is not None:
        argv += ["--fid_batch", args.fid_batch]
    out, seconds = run_cli("train", argv, log, in_process=args.in_process,
                           timeout=args.timeout)
    return out, seconds, line_after(out, "logs, samples and checkpoints in")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default=os.path.join(REPO, "build", "e2e_validation"))
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--iters", type=int, default=520)
    p.add_argument("--skip", type=int, default=120,
                   help="iterations left out of the steady-state window")
    p.add_argument("--n_images", type=int, default=512)
    p.add_argument("--src_size", type=int, default=1024, help="the PNG folder's image size")
    p.add_argument("--remove_ratio", type=float, default=0.7)
    p.add_argument("--fid", action=argparse.BooleanOptionalAction, default=True,
                   help="one overlapped in-loop FID (and checkpoint) at --iters // 2")
    p.add_argument("--fid_n_sample", type=int, default=4096)
    p.add_argument("--fid_batch", type=int, default=None)
    p.add_argument("--d_reg_every", type=int, default=16, help="R1's cadence (train's default)")
    p.add_argument("--g_reg_every", type=int, default=4,
                   help="path length's cadence (train's default)")
    p.add_argument("--bench_warmup", type=int, default=33)
    p.add_argument("--bench_iters", type=int, default=64)
    p.add_argument("--bench_full_objective", action=argparse.BooleanOptionalAction,
                   default=True, help="bench's LPIPS and BiSeNet at full width (its default)")
    p.add_argument("--width_scale", type=float, default=1.0,
                   help="the teacher's, the student's and D's widths times this")
    p.add_argument("--aux_width_scale", type=float, default=1.0, help="LPIPS and BiSeNet")
    p.add_argument("--inception_width_scale", type=float, default=1.0)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--in_process", action="store_true",
                   help="call the train CLI's main(argv) here instead of a subprocess")
    p.add_argument("--timeout", type=int, default=5000, help="seconds per CLI subprocess")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .fixtures import write_cache, write_pngs, write_real_stats, write_run_files

    work = os.path.abspath(args.workdir)
    os.makedirs(work, exist_ok=True)
    pillow = importlib.util.find_spec("PIL") is not None
    src_size, folder_note = args.src_size, "decoded per read, resized from --src_size"
    if not pillow and src_size != args.size:
        src_size = args.size
        folder_note = (f"no Pillow: a uint8 image that needs a resize cannot be read, so the "
                       f"folder holds {args.size}px images (asked: {args.src_size}px)")
    folder = os.path.join(work, f"png{src_size}")
    shutil.rmtree(folder, ignore_errors=True)
    write_pngs(folder, src_size, args.n_images, seed=11)
    cache = os.path.join(work, f"cache{args.size}.npy")
    write_cache(cache, args.size, args.n_images, seed=12)
    files = write_run_files(os.path.join(work, "files"), args.size, args.device,
                            remove_ratio=args.remove_ratio, width_scale=args.width_scale,
                            latent=args.latent, n_mlp=args.n_mlp,
                            aux_width_scale=args.aux_width_scale,
                            inception_width_scale=args.inception_width_scale,
                            pick_batch=args.batch_size)
    files["real_stats"] = write_real_stats(os.path.join(work, "files", "real_stats.pkl"),
                                           files["pool3_dim"])

    cadence = math.lcm(args.d_reg_every, args.g_reg_every)
    sources = {}
    for name, path, side, note in (("folder", folder, src_size, folder_note),
                                   ("cache", cache, args.size, "uint8 .npy memmap")):
        out, seconds, exp = train_run(args, files, path, os.path.join(work, f"exp_{name}"),
                                      os.path.join(work, f"train_{name}.log"))
        metrics = os.path.join(exp, "metrics.jsonl")
        median, mean, n = steady_rate(metrics, args.skip)
        windowed, n_windows = window_rate(metrics, args.skip, cadence)
        fids = fid_series(metrics)
        if not all(math.isfinite(r) and r > 0 for r in (median, mean, windowed)):
            raise RuntimeError(f"{name}: steady-state rate {median} / {mean} / {windowed}")
        if args.fid and (len(fids) != 1 or not math.isfinite(fids[0]["fid"])):
            raise RuntimeError(f"{name}: in-loop FID records {fids}")
        sources[name] = {"path": path, "image_size": side, "note": note,
                         "loader": line_after(out, "data_loader:"),
                         "window_median_iters_per_s": windowed, "windows": n_windows,
                         "median_iters_per_s": median, "mean_iters_per_s": mean,
                         "steady_iters": n, "wall_s": seconds, "fid": fids, "exp": exp}

    bench_argv = ["--size", args.size, "--batch_size", args.batch_size, "--dtype", "bfloat16",
                  "--warmup", args.bench_warmup, "--iters", args.bench_iters,
                  "--device", args.device]
    if not args.bench_full_objective:
        bench_argv.append("--no-full_objective")
    out, bench_s = run_cli("bench", bench_argv, os.path.join(work, "bench.log"),
                           timeout=args.timeout)
    lines = out.strip().splitlines()
    bench = json.loads(lines[-1]) if len(lines) == 1 else {}
    rate = bench.get("value", math.nan)
    if not (math.isfinite(rate) and rate > 0):
        raise RuntimeError(f"bench printed not one JSON line with a positive rate: {out[-2000:]}")

    device = args.device
    if device.startswith("cuda"):
        import torch

        device = torch.cuda.get_device_name(0)
    result = {
        "metric": "e2e_train_iters_per_sec",
        "value": sources["cache"]["mean_iters_per_s"], "unit": "iter/s",
        "window": cadence, "sources": sources, "bench_iters_per_s": rate, "bench": bench,
        "bench_wall_s": bench_s,
        "gap_vs_bench": {k: 1 - v["mean_iters_per_s"] / rate for k, v in sources.items()},
        "gap_vs_bench_window": {k: 1 - v["window_median_iters_per_s"] / rate
                                for k, v in sources.items()},
        "gap_vs_bench_median": {k: 1 - v["median_iters_per_s"] / rate
                                for k, v in sources.items()},
        "size": args.size, "batch_size": args.batch_size, "dtype": "bfloat16",
        "objective": "full_kd", "iters": args.iters, "skip": args.skip,
        "fid_cycle": args.fid, "fid_n_sample": args.fid_n_sample, "n_images": args.n_images,
        "pillow": pillow, "parser_seed": files["parser_seed"], "device": device}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
