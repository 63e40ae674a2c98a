"""Data-parallel runs of the port on the CPU for the tests: ``spawn`` starts
``world`` processes joined over gloo through a ``file://`` store (no port,
so pytest-xdist workers do not collide), runs a worker function on each
rank and returns each rank's result. The workers import torch and the port
only; the JAX references run in the test's own process."""

import os

import numpy as np
import torch
import torch.multiprocessing as mp

from content_aware_gan_compression_torch import parallel

WORKER_THREADS = 1


def _entry(rank, world, store, out_dir, fn, args):
    torch.set_num_threads(WORKER_THREADS)
    parallel.initialize("cpu", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        parallel.finalize()


def spawn(fn, world, tmp_dir, *args):
    """``fn(*args)`` on each of ``world`` gloo ranks; the list of results,
    rank by rank."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_entry, args=(world, store, tmp_dir, fn, args), nprocs=world, join=True)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def shard_draws(draws):
    """A step's global draws -> this rank's rows (the mixing point is
    shared)."""
    out = {}
    for k, v in draws.items():
        if k == "inject_index":
            out[k] = v
        elif isinstance(v, list):
            out[k] = [parallel.shard_rows(t) for t in v]
        else:
            out[k] = parallel.shard_rows(v)
    return out


def state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def run_trainer(kw, batches, draws=None, aux=None, onednn=True):
    """The port's Trainer from ``TrainConfig(**kw)`` stepped through
    ``batches`` (global uint8 batches) with ``draws`` (each iteration's
    global draws; None: the Trainer's own, from its seeded stream), each
    rank on its rows. ``aux`` is (LPIPS tree, BiSeNet tree) or None.
    Returns the metrics averaged over ranks, the running mean path length,
    and the final weights."""
    from content_aware_gan_compression_torch import train

    lp, parse = aux or (None, None)
    pt = train.Trainer(train.TrainConfig(**kw), device="cpu", lpips_params=lp,
                       parse_params=parse)
    mpl = torch.zeros(())
    metrics = []
    with torch.backends.mkldnn.flags(enabled=onednn):
        for it, (batch, d) in enumerate(zip(batches, draws or [None] * len(batches))):
            local = parallel.shard_rows(torch.from_numpy(np.asarray(batch)))
            step_draws = None if d is None else {k: shard_draws(v) for k, v in d.items()}
            m, mpl = pt.step(it, local, mpl, draws=step_draws)
            keys = sorted(m)
            packed = parallel.mean_over_ranks(torch.stack([m[k].float() for k in keys]))
            metrics.append(dict(zip(keys, packed.tolist())))
    return {"metrics": metrics, "mpl": float(mpl), "g": state(pt.g), "d": state(pt.d),
            "g_ema": state(pt.g_ema)}


def r1_and_path_grads(d_state, d_cfg, real, g_state, g_cfg, train_kw, g_reg_draws):
    """One R1 step of a discriminator and one path-length step of a
    generator, both in float64 at lr 0, on this rank's rows of ``real`` and
    of ``g_reg_draws`` (global): D's scores on the rank's rows, and both
    steps' parameter gradients after their all-reduce."""
    from content_aware_gan_compression_torch.models import Discriminator, Generator
    from content_aware_gan_compression_torch.train import TrainConfig, d_reg_step, g_reg_step
    from content_aware_gan_compression_torch.train.steps import reg_ratio_adam

    cfg = TrainConfig(**train_kw)
    d = Discriminator(d_cfg, device="cpu").double()
    d.load_state_dict(d_state)
    real = parallel.shard_rows(real)
    with torch.no_grad():
        scores = d(real)
    d_reg_step(d, reg_ratio_adam(d.parameters(), 0.0, 1.0), real, cfg)
    g = Generator(g_cfg, device="cpu").double()
    g.load_state_dict(g_state)
    g_reg_step(g, reg_ratio_adam(g.parameters(), 0.0, 1.0), shard_draws(g_reg_draws),
               torch.zeros((), dtype=torch.float64), cfg)
    return {"scores": scores, "d_grads": _grads(d), "g_grads": _grads(g)}


def _grads(module):
    """Each parameter's gradient (zeros where the step gave none: R1 does
    not reach D's last bias)."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in module.named_parameters()}


def stddev_features(x, group_size, feat):
    """``minibatch_stddev`` on this rank's rows of ``x`` (global)."""
    from content_aware_gan_compression_torch.models.stylegan2 import minibatch_stddev

    return minibatch_stddev(parallel.shard_rows(x), group_size, feat)


def coupled_terms(f64_args, x, groups):
    """``r1_and_path_grads(*f64_args)``, with ``stddev_features(x, g, 1)``
    for each group ``g`` under ``"stddev"``: one spawn for both."""
    out = r1_and_path_grads(*f64_args)
    out["stddev"] = {g: stddev_features(x, g, 1) for g in groups}
    return out


def coupled_terms_and_trainer(coupled_args, trainer_args):
    """``coupled_terms(*coupled_args)`` with ``run_trainer(*trainer_args)``
    under ``"trainer"``: one spawn for both."""
    out = coupled_terms(*coupled_args)
    out["trainer"] = run_trainer(*trainer_args)
    return out


def fid_streams_and_sparsity_run(fid_args, sparsity_args):
    """``fid_streams(*fid_args)`` and ``sparsity_run(*sparsity_args)`` in one
    spawn: {"fid": ..., "sparsity": ...}."""
    return {"fid": fid_streams(*fid_args), "sparsity": sparsity_run(*sparsity_args)}


def fid_streams(ckpt, inception_file, size, style, n_mlp, stats):
    """The FID features and scores of ``ckpt``'s ``g_ema`` (seed 0): the
    feature stream at batch 4 (split over the ranks) and 3 (whole on every
    rank), ``get_model_fid_score``, ``OverlappedFIDEval`` and the get_fid
    CLI in-process."""
    from content_aware_gan_compression_torch import get_fid
    from content_aware_gan_compression_torch.evaluation import (
        OverlappedFIDEval, extract_feature_from_samples, get_model_fid_score)
    from content_aware_gan_compression_torch.models import load_fid_inception
    from content_aware_gan_compression_torch.utils import load_generator

    g = load_generator(ckpt, size, style, n_mlp, device="cpu")
    inc = load_fid_inception(inception_file, device="cpu")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    out = {f"features_{b}": extract_feature_from_samples(g, inc, batch_size=b, n_sample=10,
                                                         generator=gen()) for b in (4, 3)}
    out["fid"] = get_model_fid_score(g, inc, stats, batch_size=4, num_sample=10,
                                     generator=gen())
    ev = OverlappedFIDEval(g, inc, stats, batch_size=4, n_sample=10, generator=gen())
    score = None
    while score is None:
        score = ev.advance(1)
    out["overlapped"] = score
    out["cli"] = get_fid.main(["--ckpt", ckpt, "--generated_img_size", str(size), "--latent",
                               str(style), "--n_mlp", str(n_mlp), "--n_sample", "10",
                               "--batch_size", "4", "--inception_ckpt", inception_file,
                               "--real_stats", stats, "--device", "cpu"])
    return out


def sparsity_run(kw, opts, exp_root, iters):
    """``SparsityTrainer.run`` for ``iters`` iterations from
    ``TrainConfig(**kw)``: the widths after its prune events, rank 0's
    records, and the final student."""
    import json

    from content_aware_gan_compression_torch.train import TrainConfig
    from content_aware_gan_compression_torch.train.sparsity import SparsityTrainer
    from content_aware_gan_compression_torch.utils import ExperimentLogger

    tr = SparsityTrainer(TrainConfig(**kw), opts, device="cpu")
    logger = ExperimentLogger(exp_root, name="run") if parallel.is_main() else None
    logger = tr.run(max_iters=iters, logger=logger)
    records = []
    if logger.exp_dir is not None:
        logger.close()
        with open(os.path.join(logger.exp_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    return {"net_shape": tuple(tr.g.config.net_shape), "records": records, "g": state(tr.g)}
