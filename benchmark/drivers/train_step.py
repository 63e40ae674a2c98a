"""Retraining cells: ``Trainer.step`` of the system under test, on one card
or data parallel over the cards of one host.

Set-up builds one ``Trainer`` and seeds its networks on the device from the
run's seed: the student (the configuration's widths), its EMA copy, the
full-width teacher and D, LPIPS-VGG16 and the BiSeNet parser. The
``Trainer`` takes a student and a teacher only from checkpoint files, so its
own full-width generator becomes the teacher and the student, its EMA copy,
the aux nets and the optimizers are put in place before its first step.
Then the same object runs iterations 0, 1 and 2 through ``Trainer.step``
with the benchmark's real batches and draws (iteration 0 runs every phase, 1
and 2 neither regularizer): they warm up every shape the window uses and give
the readings that ``correct`` compares with the reference. The window runs
from iteration 16, a cadence boundary, in whole cadences of R1 and path
length until ``--seconds`` have passed, fenced at both ends.

With ``--trace 1`` the window records a CUDA event after each phase
(``Trainer.step``'s ``phase_hook``), and one more cadence runs under
``torch.profiler`` after it.
"""

from __future__ import annotations

import copy
import gc
import math
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from benchmark.lib import compare, flops, gpu, readers
from benchmark.lib import trace as trace_lib
from benchmark.lib import traffic as tf
from benchmark.lib import weights
from benchmark.reference import aux_nets as raux
from benchmark.reference import ops as rops
from benchmark.reference import stylegan2 as rsg
from benchmark.reference import train as rtrain

CHECK_STEPS = 3
# the program's loss metrics that ``correct`` compares (``lib/compare.py``),
# by the reference's names
LOSS_NAMES = {"d": "d", "g": "g", "r1": "r1", "path": "path", "kd_l1_loss": "kd_l1",
              "kd_lpips_loss": "kd_lpips"}


def networks(cfg: dict) -> dict:
    """name -> (reference builder, init rule) of every network a cell
    seeds."""
    size = cfg["size"]
    return {
        "student": (lambda: rsg.Generator(size, cfg["student_net_shape"]), rsg.init_rule),
        "teacher": (lambda: rsg.Generator(size, cfg["teacher_net_shape"]), rsg.init_rule),
        "d": (lambda: rsg.Discriminator(size, cfg["channel_multiplier"]), rsg.init_rule),
        "lpips": (raux.LPIPS, raux.lpips_rule),
        "parser": (raux.BiSeNet, raux.bisenet_rule),
    }


def state(cfg, name, seed, device):
    build, rule = networks(cfg)[name]
    return weights.draw(weights.spec(weights.meta_module(build), rule), seed, device)


def reference_net(cfg, name, seed, device):
    build, rule = networks(cfg)[name]
    return weights.materialize(build, rule, seed, device)[0]


def hyper(traffic: dict) -> rtrain.Hyper:
    return rtrain.Hyper(lr=traffic["lr"], r1=traffic["r1"], path_weight=traffic["path_weight"],
                        path_batch_shrink=traffic["path_batch_shrink"],
                        d_reg_every=traffic["d_reg_every"], g_reg_every=traffic["g_reg_every"],
                        kd_l1_lambda=traffic["kd_l1_lambda"],
                        kd_lpips_lambda=traffic["kd_lpips_lambda"])


def pick_parser_seed(ctx, draws0) -> tuple[int, float]:
    """The first parser seed, counting from the run's, whose KD mask of the
    teacher's images of iteration 0 keeps 2-98% of the pixels (a seeded
    BiSeNet can parse one class everywhere), decided by the reference in
    float32 on rank 0."""
    choice = torch.zeros(2, dtype=torch.float64)
    if ctx.rank == 0:
        with rops.strict_float32(), torch.no_grad():
            teacher = reference_net(ctx.config, "teacher", weights.sub_seed(ctx.seed, "teacher"),
                                    ctx.device)
            dg = draws0["g"]
            img = teacher(dg["z"], dg["inject_index"], dg["teacher_noise"])
            del teacher
            for k in range(64):
                seed = weights.sub_seed(ctx.seed, f"parser{k}")
                parser = reference_net(ctx.config, "parser", seed, ctx.device)
                share = raux.coi_mask(parser, img).mean().item()
                if 0.02 <= share <= 0.98:
                    choice = torch.tensor([float(k), share], dtype=torch.float64)
                    break
            else:
                raise RuntimeError("no parser seed of 64 parses the teacher's images into a "
                                   "mixed mask")
    if ctx.world > 1:
        dist.broadcast(choice, 0, group=ctx.host_group)
    k, share = int(choice[0]), float(choice[1])
    return weights.sub_seed(ctx.seed, f"parser{k}"), share


def build_program(ctx, traffic, parser_seed):
    """The ``Trainer`` with the seeded networks in place."""
    from content_aware_gan_compression_torch.models import (
        BiSeNet, Generator, GeneratorConfig, LPIPS)
    from content_aware_gan_compression_torch.train import TrainConfig, Trainer
    from content_aware_gan_compression_torch.train.steps import make_optimizers

    cfg = ctx.config
    tcfg = TrainConfig(
        generated_img_size=cfg["size"], latent=cfg["style_dim"], n_mlp=cfg["n_mlp"],
        channel_multiplier=cfg["channel_multiplier"], batch_size=traffic["batch"],
        init_lr=traffic["lr"], discriminator_r1=traffic["r1"],
        generator_path_reg_weight=traffic["path_weight"],
        path_reg_batch_shrink=traffic["path_batch_shrink"], g_reg_freq=traffic["g_reg_every"],
        d_reg_freq=traffic["d_reg_every"], noise_mixing=traffic["mixing"],
        kd_l1_lambda=traffic["kd_l1_lambda"], kd_lpips_lambda=traffic["kd_lpips_lambda"],
        kd_mode="Output_Only", content_aware_KD=True, compute_dtype=traffic["compute_dtype"],
        opt_state_dtype=traffic["opt_state_dtype"], remat=traffic["remat"],
        seed=weights.sub_seed(ctx.seed, "trainer"))
    tr = Trainer(tcfg, device=ctx.device)
    dev = ctx.device
    teacher = tr.g  # full width: the configuration's teacher
    teacher.load_state_dict(state(cfg, "teacher", weights.sub_seed(ctx.seed, "teacher"), dev))
    tr.teacher = teacher.requires_grad_(False)
    tr.d.load_state_dict(state(cfg, "d", weights.sub_seed(ctx.seed, "d"), dev))
    student = Generator(GeneratorConfig(size=cfg["size"], style_dim=cfg["style_dim"],
                                        n_mlp=cfg["n_mlp"],
                                        net_shape=tuple(cfg["student_net_shape"])), device=dev)
    student.load_state_dict(state(cfg, "student", weights.sub_seed(ctx.seed, "student"), dev))
    tr.g = student
    tr.g_ema = copy.deepcopy(student).requires_grad_(False)
    tr.lpips = LPIPS(device=dev)
    tr.lpips.load_state_dict(state(cfg, "lpips", weights.sub_seed(ctx.seed, "lpips"), dev))
    tr.lpips.requires_grad_(False).eval()
    tr.parser = BiSeNet(device=dev)
    tr.parser.load_state_dict(state(cfg, "parser", parser_seed, dev))
    tr.parser.requires_grad_(False).eval()
    tr.g_opt, tr.d_opt = make_optimizers(tr.g, tr.d, tcfg)
    return tr


def first_grad_norms(opt, net, b2: float) -> dict:
    """Each leaf's gradient norm after the optimizer's first step, worked
    out from its second moment: nu = (1 - b2) g^2."""
    out = {}
    for name, p in net.named_parameters():
        st = opt.state.get(p, {})
        nu = next((v for v in st.values() if torch.is_tensor(v) and v.shape == p.shape), None)
        out[name] = 0.0 if nu is None else math.sqrt(nu.double().sum().item() / (1 - b2))
    return out


def change_norms(net, theta0: dict) -> dict:
    return {k: (p.detach() - theta0[k]).norm().item() for k, p in net.named_parameters()}


def sizes(g, d) -> dict:
    """Each leaf's element count, by network (``compare``)."""
    return {n: {k: p.numel() for k, p in net.named_parameters()} for n, net in (("g", g), ("d", d))}


def betas(traffic):
    rg = traffic["g_reg_every"] / (traffic["g_reg_every"] + 1)
    rd = traffic["d_reg_every"] / (traffic["d_reg_every"] + 1)
    return 0.99 ** rg, 0.99 ** rd


def first_steps(ctx, tr, traffic, pool, draws):
    """Iterations 0 .. CHECK_STEPS-1 through ``Trainer.step``: the warm-up,
    and the readings ``correct`` compares. Returns (readings, the mean path
    length)."""
    b2_g, b2_d = betas(traffic)
    theta0 = {"g": {k: p.detach().clone() for k, p in tr.g.named_parameters()},
              "d": {k: p.detach().clone() for k, p in tr.d.named_parameters()}}
    grads = {}

    def hook(name):
        if name == "d" and "d" not in grads:
            grads["d"] = first_grad_norms(tr.d_opt, tr.d, b2_d)
        if name == "g" and "g" not in grads:
            grads["g"] = first_grad_norms(tr.g_opt, tr.g, b2_g)

    mpl = torch.zeros((), device=ctx.device)
    losses = []
    for i in range(CHECK_STEPS):
        d = tf.rows(draws.iteration(i), ctx.rank, ctx.world)
        m, mpl = tr.step(i, tf.rows(pool[i], ctx.rank, ctx.world), mpl, draws=d,
                         phase_hook=hook)
        keys = sorted(k for k in m if k in LOSS_NAMES)
        vals = torch.stack([m[k].float() for k in keys])
        if ctx.world > 1:
            dist.all_reduce(vals)
            vals /= ctx.world
        losses.append({LOSS_NAMES[k]: v for k, v in zip(keys, vals.tolist())})
    change = {"g": change_norms(tr.g, theta0["g"]), "d": change_norms(tr.d, theta0["d"]),
              "g_ema": change_norms(tr.g_ema, theta0["g"])}
    return {"losses": losses, "grad": grads, "change": change, "sizes": sizes(tr.g, tr.d)}, mpl


class PhaseSpans:
    """CUDA events at each iteration's start and after each phase; the
    device time between consecutive events, summed by phase."""

    def __init__(self):
        self.marks = []

    def _record(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def start(self):
        self._record(None)

    def __call__(self, name):
        self._record(name)

    def totals_ms(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            if name is not None:
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def iterations(ctx, tr, pool, draws, start, count, mpl, spans=None):
    """``count`` iterations from ``start``; returns (mpl, a device count of
    non-finite losses)."""
    bad = torch.zeros((), device=ctx.device)
    for i in range(start, start + count):
        d = tf.rows(draws.iteration(i), ctx.rank, ctx.world)
        if spans is not None:
            spans.start()
        m, mpl = tr.step(i, tf.rows(pool[i % len(pool)], ctx.rank, ctx.world), mpl, draws=d,
                         phase_hook=spans)
        bad += (~torch.isfinite(torch.stack([v.float() for v in m.values()]))).sum()
    return mpl, bad


def reference_readings(ctx, traffic, pool, parser_seed, kind="float32"):
    """The reference's readings of the first ``CHECK_STEPS`` iterations over
    the whole batch, computed in float32 without TF32 (``kind``: lower, for
    the control)."""
    cfg, dev, seed = ctx.config, ctx.device, ctx.seed
    g = reference_net(cfg, "student", weights.sub_seed(seed, "student"), dev)
    d = reference_net(cfg, "d", weights.sub_seed(seed, "d"), dev)
    nets = (g, d, copy.deepcopy(g).requires_grad_(False),
            reference_net(cfg, "teacher", weights.sub_seed(seed, "teacher"),
                          dev).requires_grad_(False),
            reference_net(cfg, "lpips", weights.sub_seed(seed, "lpips"),
                          dev).requires_grad_(False),
            reference_net(cfg, "parser", parser_seed, dev).requires_grad_(False))
    theta0 = {n: {k: p.detach().clone() for k, p in net.named_parameters()}
              for n, net in (("g", g), ("d", d))}
    hp = hyper(traffic)
    opts = rtrain.optimizers(g, d, hp)
    draws = tf.Draws(seed, traffic, cfg, dev)
    grads, losses, seconds = {}, [], []
    mean_path = torch.zeros((), device=dev)
    with rops.strict_float32(), rops.precision(kind):
        for i in range(CHECK_STEPS):
            t = time.perf_counter()
            out, mean_path = rtrain.iteration(i, nets, opts, pool[i].to(dev), draws.iteration(i),
                                              mean_path, hp, grads)
            losses.append(out)
            seconds.append(time.perf_counter() - t)
    ctx.log("the reference's iterations took", [round(x, 2) for x in seconds], "s")
    change = {"g": change_norms(g, theta0["g"]), "d": change_norms(d, theta0["d"]),
              "g_ema": change_norms(nets[2], theta0["g"])}
    return {"losses": losses, "grad": grads, "change": change, "sizes": sizes(g, d)}


def device_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free():
    """Give the card back the memory of what the caller has let go."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def prepare(ctx, traffic):
    """Set-up: the inputs, the parser seed, the ``Trainer`` and its first
    steps. Returns a dict of what the window and the check use. The parser
    seed is the reference's choice, off the set-up's clock; the libraries it
    would load first are loaded on the clock before it."""
    cfg = ctx.config
    pool = tf.real_pool(ctx.seed, traffic["real_pool"], traffic["batch"], cfg["size"],
                        ctx.device)
    draws = tf.Draws(ctx.seed, traffic, cfg, ctx.device)
    gpu.warm_libraries(ctx.device)
    ctx.stage("the inputs")
    with ctx.off_clock():
        parser_seed, share = pick_parser_seed(ctx, tf.Draws(ctx.seed, traffic, cfg,
                                                            ctx.device).iteration(0))
    ctx.log(f"parser seed {parser_seed}: the KD mask keeps {share:.4f} of the pixels; the "
            f"search took {ctx.off_clock_s:.2f} s off the set-up's clock")
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    tr = build_program(ctx, traffic, parser_seed)
    ctx.stage("the Trainer")
    readings, mpl = first_steps(ctx, tr, traffic, pool, draws)
    ctx.stage("iterations 0-2")
    return {"pool": pool, "draws": draws, "parser_seed": parser_seed, "trainer": tr,
            "readings": readings, "mpl": mpl}


def check(ctx, traffic, prep):
    """The numbers ``correct`` compares (rank 0; None on the others)."""
    if ctx.rank != 0:
        return None
    ref = reference_readings(ctx, traffic, prep["pool"], prep["parser_seed"])
    return compare.training_numbers(prep["readings"], ref)


def run(ctx):
    traffic = ctx.traffic
    cadence = math.lcm(traffic["d_reg_every"], traffic["g_reg_every"])
    prep = prepare(ctx, traffic)
    tr, pool, draws = prep["trainer"], prep["pool"], prep["draws"]
    start = cadence * math.ceil(CHECK_STEPS / cadence)
    spans = PhaseSpans() if ctx.trace else None
    ctx.fence()
    ctx.log("gpu before the window:", gpu.smi(ctx.device.index or 0))
    setup_s = ctx.setup_seconds()
    mpl, bad, count = prep["mpl"], torch.zeros((), device=ctx.device), 0
    t_start = time.perf_counter()
    marks = []
    while True:
        mpl, b = iterations(ctx, tr, pool, draws, start + count, cadence, mpl, spans)
        bad += b
        count += cadence
        marks.append(time.perf_counter() - t_start)
        if ctx.any_rank(marks[-1] >= ctx.seconds):
            break
    ctx.fence()
    elapsed = time.perf_counter() - t_start
    ctx.log("host clock at each cadence's end:", [round(m, 3) for m in marks], "fenced", elapsed)
    ctx.log("gpu after the window:", gpu.smi(ctx.device.index or 0))
    rate = count / elapsed
    failed = int(ctx.reduce(bad.item(), dist.ReduceOp.SUM))

    layer = None
    if ctx.trace:
        layer = {"spans_ms": {k: v / count for k, v in spans.totals_ms().items()}}
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            from torch.profiler import ProfilerActivity, profile
            ctx.fence()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                iterations(ctx, tr, pool, draws, start + count, cadence, mpl)
                torch.cuda.synchronize(ctx.device)
            path = os.path.join(tmp, f"rank{ctx.rank}.json")
            prof.export_chrome_trace(path)
            del prof
            layer.update(readers.from_trace(trace_lib.load_events(path, log=ctx.log), cadence))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    peak = ctx.reduce(device_peak(ctx.device), dist.ReduceOp.MAX)
    del tr
    prep["trainer"] = None
    free()
    numbers = check(ctx, traffic, prep)
    macs = flops.retrain_iteration_macs(ctx.config, traffic)
    return {
        "rate": (traffic["rate_metric"], rate, "it/s"), "setup_s": setup_s,
        "attempted": count, "failed": failed, "numbers": numbers, "peak_bytes": peak,
        "layer": None if layer is None else {
            **layer, "rate": rate, "flop_per_unit": 2 * macs, "chips": ctx.world,
            "peak_tflops": flops.peak_tflops(traffic["compute_dtype"]), "peak_bytes": peak,
            "busy_s": ctx.reduce(layer["busy_s"], dist.ReduceOp.SUM) / ctx.world}}
