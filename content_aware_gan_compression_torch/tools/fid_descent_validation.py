"""Prune, then retrain, and the in-loop FID's descent, through the port's CLIs
(the port's counterpart of the JAX round's ``tools/fid_descent_validation.py``):

    python -m content_aware_gan_compression_torch.tools.fid_descent_validation

No released weights are in the repository, so a seeded full-width teacher
is the data distribution:

  1. the teacher {'g', 'g_ema', 'd'} and the seeded aux files (``fixtures``:
     LPIPS, the BiSeNet whose mask keeps 2-98% of the teacher's pixels, the
     FID Inception);
  2. ``--n_images`` teacher samples written to a PNG folder (lossless) and
     its uint8 cache (``build_uint8_cache``): the real data;
  3. ``calc_inception`` on the cache: the real statistics;
  4. ``prune --remove_ratio 0.7`` of the teacher, content-aware, with the
     seeded BiSeNet;
  5. ``get_fid`` of the teacher (the sampling-noise floor) and of the pruned
     student (its iteration-0 point);
  6. ``train`` in bf16 ``full_kd`` from the pruned checkpoint, the teacher
     distilling, with the in-loop FID every ``--fid_every`` iterations;
  7. the FID series read back from the run's ``metrics.jsonl``, whose FID
     records carry the iteration they scored;
  8. ``get_ppl --divide_eps_sq`` of the pruned student and of the last
     checkpoint.

Each step is the CLI in a subprocess (``--in_process``: its ``main``), its
output kept in ``logs/``. A new run first removes what an earlier run wrote
into ``--workdir`` (``OUTPUTS``) and nothing else there. Writes the result
JSON to ``fid_descent.json`` in ``--workdir`` and prints it. ``descending``
is the last in-loop FID below the pruned student's iteration-0 FID; the
tool exits non-zero when it is false (unless ``--no-require_descent``, for
a short run that only has to go through). ``floor_ordering_ok`` (the last
FID at least half the teacher's) is only reported. The seeded Inception's feature space is a random projection, so
FIDs read far above a real Inception's; the descent is the signal. Runs on
``cuda`` unless ``--device cpu``; ``--*width_scale``, ``--latent`` and
``--n_mlp`` shrink the nets for a check on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

from .cli import REPO, line_after, run_cli
from .e2e_validation import fid_series

# what a run writes into --workdir; a new run removes these and nothing else
OUTPUTS = ("files", "teacher_samples", "teacher_stats.pkl", "pruned", "exp", "logs",
           "fid_descent.json")


def sample_dataset(teacher_path, folder, args, batch=64, seed=1234):
    """``args.n_images`` samples of the teacher's g_ema (no truncation, fresh
    noise) as PNGs in ``folder``, then the folder's uint8 cache; returns the
    cache's path."""
    import torch

    from ..data import build_uint8_cache
    from ..utils import load_generator
    from ..utils.logging import write_png

    os.makedirs(folder)
    g = load_generator(teacher_path, args.size, args.latent, args.n_mlp,
                       device=args.device).eval()
    gen = torch.Generator(g.device).manual_seed(seed)
    with ThreadPoolExecutor(8) as pool, torch.inference_mode():
        for start in range(0, args.n_images, batch):
            n = min(batch, args.n_images - start)
            z = torch.randn(n, args.latent, generator=gen, device=g.device)
            img = g([z], generator=gen)
            u8 = ((img + 1) * 127.5 + 0.5).clamp(0, 255).to(torch.uint8)
            u8 = u8.permute(0, 2, 3, 1).cpu().numpy()
            list(pool.map(lambda i: write_png(os.path.join(folder, f"{start + i:06d}.png"),
                                              u8[i]), range(n)))
    return build_uint8_cache(folder, args.size)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workdir", default=os.path.join(REPO, "build", "fid_descent_validation"))
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iters", type=int, default=10000)
    p.add_argument("--fid_every", type=int, default=2000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--n_images", type=int, default=8192,
                   help="teacher samples in the dataset")
    p.add_argument("--fid_n_sample", type=int, default=4096)
    p.add_argument("--fid_batch", type=int, default=64)
    p.add_argument("--remove_ratio", type=float, default=0.7)
    p.add_argument("--prune_n_sample", type=int, default=400, help="prune's --n_sample")
    p.add_argument("--prune_batch", type=int, default=10, help="prune's --batch_size")
    p.add_argument("--ppl_n_sample", type=int, default=2048,
                   help="samples of the before/after PPL pair")
    p.add_argument("--require_descent", action=argparse.BooleanOptionalAction, default=True,
                   help="exit non-zero when the FID does not descend")
    p.add_argument("--width_scale", type=float, default=1.0,
                   help="the teacher's and D's widths times this")
    p.add_argument("--aux_width_scale", type=float, default=1.0, help="LPIPS and BiSeNet")
    p.add_argument("--inception_width_scale", type=float, default=1.0)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--in_process", action="store_true",
                   help="call each CLI's main(argv) here instead of a subprocess")
    p.add_argument("--timeout", type=int, default=14000, help="seconds per CLI subprocess")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .fixtures import write_run_files

    work = os.path.abspath(args.workdir)
    for name in OUTPUTS:
        path = os.path.join(work, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    os.makedirs(os.path.join(work, "logs"), exist_ok=True)
    nets = ["--latent", args.latent, "--n_mlp", args.n_mlp, "--device", args.device]
    seconds = {}

    def cli(step, module, argv, generator=True):
        """The CLI's standard output; its seconds go to ``seconds[step]``."""
        argv = [*argv, *nets] if generator else [*argv, "--device", args.device]
        out, seconds[step] = run_cli(module, argv, os.path.join(work, "logs", f"{step}.log"),
                                     in_process=args.in_process, timeout=args.timeout)
        return out

    t0 = time.time()
    files = write_run_files(os.path.join(work, "files"), args.size, args.device,
                            remove_ratio=args.remove_ratio, width_scale=args.width_scale,
                            latent=args.latent, n_mlp=args.n_mlp,
                            aux_width_scale=args.aux_width_scale,
                            inception_width_scale=args.inception_width_scale,
                            pick_batch=args.batch_size)
    teacher = files["teacher"]
    seconds["files"] = time.time() - t0
    t0 = time.time()
    folder = os.path.join(work, "teacher_samples")
    cache = sample_dataset(teacher, folder, args)
    seconds["dataset"] = time.time() - t0

    stats = os.path.join(work, "teacher_stats.pkl")
    cli("calc_inception", "calc_inception", [
        cache, "--size", args.size, "--batch", args.fid_batch,
        "--inception_ckpt", files["inception"], "--output", stats], generator=False)
    out = cli("prune", "prune", [
        "--ckpt", teacher, "--generated_img_size", args.size, "--remove_ratio",
        args.remove_ratio, "--parsing_ckpt", files["bisenet"], "--n_sample",
        args.prune_n_sample, "--batch_size", args.prune_batch,
        "--out_dir", os.path.join(work, "pruned")])
    pruned = line_after(out, "saved pruned checkpoint to")

    def fid(step, ckpt):
        return float(line_after(cli(step, "get_fid", [
            "--ckpt", ckpt, "--generated_img_size", args.size, "--n_sample", args.fid_n_sample,
            "--batch_size", args.fid_batch, "--real_stats", stats,
            "--inception_ckpt", files["inception"]]), "FID Scores:"))

    teacher_fid, student_fid0 = fid("get_fid_teacher", teacher), fid("get_fid_pruned", pruned)
    print(f"# teacher FID (the noise floor): {teacher_fid}; pruned student's at iteration 0: "
          f"{student_fid0}", flush=True)

    exp_root = os.path.join(work, "exp")
    out = cli("train", "train", [
        "--path", folder, "--size", args.size, "--ckpt", pruned, "--teacher_ckpt", teacher,
        "--iter", args.iters + 1, "--batch_size", args.batch_size, "--dtype", "bfloat16",
        "--lpips_vgg_ckpt", files["vgg16"], "--lpips_lins_ckpt", files["lins"],
        "--parsing_ckpt", files["bisenet"], "--inception_ckpt", files["inception"],
        "--real_stats", stats, "--exp_root", exp_root,
        "--val_sample_freq", args.fid_every, "--model_save_freq", args.fid_every,
        "--fid_n_sample", args.fid_n_sample, "--fid_batch", args.fid_batch])
    exp = line_after(out, "logs, samples and checkpoints in")
    series = fid_series(os.path.join(exp, "metrics.jsonl"))
    loader = line_after(out, "data_loader:")

    ckpt_dir = os.path.join(exp, "ckpt")
    final_ckpt = os.path.join(ckpt_dir, sorted(os.listdir(ckpt_dir))[-1])
    ppl = {name: float(line_after(cli(f"get_ppl_{name[4:]}", "get_ppl", [
        "--ckpt", ckpt, "--generated_img_size", args.size, "--n_sample", args.ppl_n_sample,
        "--batch_size", args.fid_batch, "--divide_eps_sq", "--lpips_vgg_ckpt", files["vgg16"],
        "--lpips_lins_ckpt", files["lins"]]), "PPL Scores:"))
        for name, ckpt in (("ppl_pruned_iter0", pruned), ("ppl_retrained_final", final_ckpt))}

    values = [teacher_fid, student_fid0, *(s["fid"] for s in series), *ppl.values()]
    if not series or not all(math.isfinite(v) and v > 0 for v in values):
        raise RuntimeError(f"an FID or PPL is not finite and positive, or no in-loop FID ran: "
                           f"teacher {teacher_fid}, pruned {student_fid0}, series {series}, "
                           f"{ppl}")
    device = args.device
    if device.startswith("cuda"):
        import torch

        device = torch.cuda.get_device_name(0)
    result = {
        "metric": "in_loop_fid_descent", "size": args.size, "remove_ratio": args.remove_ratio,
        "objective": "full_kd", "dtype": "bfloat16",
        "teacher_fid_noise_floor": teacher_fid, "student_fid_iter0": student_fid0,
        "series": series, "descending": series[-1]["fid"] < student_fid0,
        "floor_ordering_ok": series[-1]["fid"] >= 0.5 * teacher_fid,
        **ppl, "ppl_n_sample": args.ppl_n_sample, "ppl_divide_eps_sq": True,
        "ppl_final_ckpt": final_ckpt, "iters": args.iters, "fid_every": args.fid_every,
        "batch_size": args.batch_size, "dataset_images": args.n_images,
        "dataset_format": "png_lossless", "fid_n_sample": args.fid_n_sample,
        "prune_n_sample": args.prune_n_sample, "loader": loader,
        "parser_seed": files["parser_seed"], "parser_share": files["parser_share"],
        "train_wall_s": seconds["train"], "seconds": seconds, "device": device,
        "note": "seeded aux nets: the FID lives in a seeded Inception's random feature space; "
                "its descent toward the teacher samples' statistics is the signal"}
    with open(os.path.join(work, "fid_descent.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    if args.require_descent and not result["descending"]:
        raise SystemExit(f"the in-loop FID did not descend: {series[-1]['fid']} at iteration "
                         f"{series[-1]['iter']} against {student_fid0} at iteration 0")
    return result


if __name__ == "__main__":
    main()
