"""The training driver over ranks on the CPU: 2 gloo ranks at 32px run the
set-up, the window and the check as a 4-card cell's ranks do, agreeing on
the window's length and reducing the readings; the reference follows the
whole batch. Without the gradients' exchange the check fails."""

from __future__ import annotations

import os
import time

import torch
import torch.multiprocessing as mp

from benchmark.reference.stylegan2 import channels, full_net_shape

SIZE = 32
TINY = {"size": SIZE, "style_dim": 512, "n_mlp": 8, "channel_multiplier": 2,
        "teacher_net_shape": list(full_net_shape(SIZE)),
        "student_net_shape": [64, 64, 48, 48, 32, 32, 16, 16],
        "discriminator_channels": {str(k): v for k, v in channels(2).items() if k <= SIZE}}


def _rank(rank, world, port, fault, queue):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(2)
    import contextlib

    import torch.distributed as dist

    from benchmark.control import faults
    from benchmark.lib import manifest
    from benchmark.lib.context import Context
    from content_aware_gan_compression_torch import parallel

    device = parallel.initialize("cpu")
    group = dist.new_group(backend="gloo")
    traffic = {**manifest.traffic("retrain-bf16-b16"), "compute_dtype": "float32", "batch": 4,
               "d_reg_every": 2, "g_reg_every": 2, "real_pool": 3}
    ctx = Context(name="ranks", cell={"limits": {}}, config=TINY, traffic=traffic,
                  seed=2 ** 31 + 5, seconds=0.0, trace=False, device=device, t0=time.time(),
                  rank=rank, world=world, host_group=group)
    with faults.plant(fault) if fault else contextlib.nullcontext():
        out = manifest.driver("train_step").run(ctx)
    dist.barrier(group=group)
    if rank == 0:
        queue.put((out["attempted"], out["numbers"]))
    parallel.finalize()


def run_ranks(fault=None, world=2, port=29571):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, port, fault, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    result = queue.get(timeout=900)
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    return result


def test_ranks_follow_the_whole_batch_and_fail_without_the_exchange():
    attempted, sound = run_ranks()
    assert attempted == 2  # one cadence of iterations 4 and 5
    assert max(sound.values()) < 0.05, sound
    _, broken = run_ranks("no_exchange", port=29572)
    assert broken["grad_d"] > 10 * sound["grad_d"], (sound, broken)
