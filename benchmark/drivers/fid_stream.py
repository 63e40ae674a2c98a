"""FID cells: ``evaluation.fid.extract_feature_from_samples`` of the system
under test, the student generator's images through FID's InceptionV3, in
chunks, each ending in its features' copy to the host.

Set-up seeds the student and Inception on the device from the run's seed and
runs one batch. The window runs whole chunks until ``--seconds`` have passed;
chunk ``c`` draws from a ``torch.Generator`` seeded from the run's seed and
``c``. ``extract_feature_from_samples`` draws each batch's z and then its
noise maps from that generator, so the reference draws the same inputs again
from the same seed. After the window a sample of rows drawn from the seed in
every chunk is recomputed by the reference and compared.

With ``--trace 1`` a few more batches run under ``torch.profiler`` after the
window.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.lib import flops, gpu, readers
from benchmark.lib import trace as trace_lib
from benchmark.lib import traffic as tf
from benchmark.lib import weights
from benchmark.reference import aux_nets as raux
from benchmark.reference import ops as rops
from benchmark.reference import stylegan2 as rsg


def networks(cfg: dict) -> dict:
    return {"student": (lambda: rsg.Generator(cfg["size"], cfg["student_net_shape"]),
                        rsg.init_rule),
            "inception": (raux.InceptionV3, raux.inception_rule)}


def state(cfg, name, seed, device):
    build, rule = networks(cfg)[name]
    return weights.draw(weights.spec(weights.meta_module(build), rule), seed, device)


def build_program(ctx):
    from content_aware_gan_compression_torch.models import (
        Generator, GeneratorConfig, InceptionV3)

    cfg, dev = ctx.config, ctx.device
    g = Generator(GeneratorConfig(size=cfg["size"], style_dim=cfg["style_dim"],
                                  n_mlp=cfg["n_mlp"], net_shape=tuple(cfg["student_net_shape"])),
                  device=dev)
    g.load_state_dict(state(cfg, "student", weights.sub_seed(ctx.seed, "student"), dev))
    inc = InceptionV3(device=dev)
    inc.load_state_dict(state(cfg, "inception", weights.sub_seed(ctx.seed, "inception"), dev))
    return g.requires_grad_(False).eval(), inc.requires_grad_(False).eval()


def chunk_generator(seed, c, device):
    return torch.Generator(device).manual_seed(weights.sub_seed(seed, f"chunk{c}"))


def checked_rows(seed, c, chunk, n):
    """The ``n`` rows of chunk ``c`` the check recomputes."""
    rng = np.random.default_rng(weights.sub_seed(seed, f"check{c}"))
    return np.sort(rng.choice(chunk, size=n, replace=False))


def extract(ctx, g, inc, n, generator):
    from content_aware_gan_compression_torch.evaluation.fid import extract_feature_from_samples

    t = ctx.traffic
    return extract_feature_from_samples(g, inc, truncation=t["truncation"],
                                        batch_size=t["batch"], n_sample=n, generator=generator)


def reference_features(ctx, chunks: dict, kind="float32") -> dict:
    """{chunk: features [rows, 2048]} of the checked rows, from the same
    draws: each batch's z, then its noise maps, from the chunk's
    generator."""
    cfg, t, dev = ctx.config, ctx.traffic, ctx.device
    g = weights.materialize(*networks(cfg)["student"], weights.sub_seed(ctx.seed, "student"),
                            dev)[0]
    inc = weights.materialize(*networks(cfg)["inception"],
                              weights.sub_seed(ctx.seed, "inception"), dev)[0]
    sides = tf.noise_sizes(cfg["size"])
    bs = t["batch"]
    out = {}
    with rops.strict_float32(), rops.precision(kind), torch.no_grad():
        for c, rows in chunks.items():
            gen = chunk_generator(ctx.seed, c, dev)
            zs, noises = [], [[] for _ in sides]
            for b in range(t["chunk"] // bs):
                z = torch.randn(bs, cfg["style_dim"], generator=gen, device=dev)
                noise = [torch.randn(bs, s, s, 1, generator=gen, device=dev) for s in sides]
                pick = torch.as_tensor(rows[(rows >= b * bs) & (rows < (b + 1) * bs)] - b * bs,
                                       device=dev)
                zs.append(z[pick])
                for k, n in enumerate(noise):
                    noises[k].append(n[pick])
            z = torch.cat(zs)
            noise = [torch.cat(n) for n in noises]
            feats = []
            for s in range(0, z.shape[0], bs):
                img = g([z[s:s + bs], z[s:s + bs]], torch.tensor(g.n_latent, device=dev),
                        [n[s:s + bs] for n in noise])
                feats.append(inc(img).double().cpu())
            out[c] = torch.cat(feats).numpy()
    return out


def feature_gaps(prog: dict, ref: dict) -> np.ndarray:
    """Each checked row's ||f_p - f_r|| / ||f_r||."""
    gaps = []
    for c, r in ref.items():
        p = prog[c]
        gaps.append(np.linalg.norm(p - r, axis=1) / np.maximum(np.linalg.norm(r, axis=1),
                                                               1e-30))
    return np.concatenate(gaps)


def run(ctx):
    t, cfg = ctx.traffic, ctx.config
    g, inc = build_program(ctx)
    ctx.stage("the networks")
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    extract(ctx, g, inc, t["batch"], chunk_generator(ctx.seed, -1, ctx.device))  # warm-up
    ctx.stage("one batch")
    ctx.fence()
    ctx.log("gpu before the window:", gpu.smi(ctx.device.index or 0))
    setup_s = ctx.setup_seconds()
    kept, c, marks = {}, 0, []
    t_start = time.perf_counter()
    while True:
        feats = extract(ctx, g, inc, t["chunk"], chunk_generator(ctx.seed, c, ctx.device))
        rows = checked_rows(ctx.seed, c, t["chunk"], t["check_rows"])
        kept[c] = (rows, feats[rows])
        c += 1
        marks.append(time.perf_counter() - t_start)
        if marks[-1] >= ctx.seconds:
            break
    elapsed = marks[-1]
    ctx.log("host clock at each chunk's end:", [round(m, 3) for m in marks])
    ctx.log("gpu after the window:", gpu.smi(ctx.device.index or 0))
    images = c * t["chunk"]
    batches_per_s = images / t["batch"] / elapsed

    layer = None
    if ctx.trace:
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            from torch.profiler import ProfilerActivity, profile
            ctx.fence()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                extract(ctx, g, inc, t["trace_batches"] * t["batch"],
                        chunk_generator(ctx.seed, c, ctx.device))
                torch.cuda.synchronize(ctx.device)
            path = os.path.join(tmp, "rank0.json")
            prof.export_chrome_trace(path)
            del prof
            layer = readers.from_trace(trace_lib.load_events(path, log=ctx.log),
                                       t["trace_batches"])
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del g, inc
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_features(ctx, {k: v[0] for k, v in kept.items()})
    gaps = feature_gaps({k: v[1] for k, v in kept.items()}, ref)
    limit = ctx.limits.get("features")
    macs = flops.infer_image_macs(cfg, t)
    return {
        "rate": (t["rate_metric"], images / elapsed, "img/s"), "setup_s": setup_s,
        "attempted": images,
        "failed": int(np.sum(~(gaps <= limit))) if limit is not None else len(gaps),
        "numbers": {"features": float(np.max(gaps))}, "peak_bytes": peak,
        "layer": None if layer is None else {
            **layer, "rate": batches_per_s, "flop_per_unit": 2 * macs * t["batch"],
            "chips": 1, "peak_tflops": flops.peak_tflops(t["dtype"]), "peak_bytes": peak}}
