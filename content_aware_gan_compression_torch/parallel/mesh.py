"""Data parallel across processes, one process per card (the JAX package's
parallel/mesh.py).

The JAX package runs one SPMD program over a 1-D device mesh: batch arrays
live in ``P('data')``, parameters are replicated, and XLA inserts the psum
of every replicated parameter's gradient. Here each process holds a replica
and the contiguous rows ``[r*B/R, (r+1)*B/R)`` of every global batch of B
(``shard_rows``), and the steps call the collectives themselves:
``all_reduce_grads`` after each phase's backward (the psum), ``global_mean``
and ``gather_rows`` where the loss couples samples across the batch (the
path-length mean, the minibatch stddev, the sparsity penalty's batch mean).
DDP's reducer does not fit: R1 and path length differentiate through
``autograd.grad(create_graph=True)``, and each step differentiates one
network of several.

The process group comes from ``initialize``: torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or explicit arguments; NCCL on cards, gloo on the CPU. Without a process
group every helper is the identity and launches nothing.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


def active() -> bool:
    """Whether a process group is up (then every helper runs its collective,
    at world size 1 too)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """Rank 0, which writes logs, sample grids and checkpoints."""
    return rank() == 0


def device_for_rank(device="cuda") -> torch.device:
    """``cuda:LOCAL_RANK`` for a CUDA device without an index (LOCAL_RANK 0
    outside torchrun); a CUDA device with an index, and the CPU, as given.
    Raises when LOCAL_RANK names a card that is not there."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(f"LOCAL_RANK {local} but this host has {n} CUDA device(s); run "
                           f"at most {n} processes per node")
    return torch.device("cuda", local)


def initialize(device="cuda", *, backend=None, init_method=None, world_size=None,
               rank=None) -> torch.device:
    """Join the process group and return this rank's device
    (``device_for_rank``): the counterpart of ``initialize_multihost``.

    ``world_size`` and ``rank`` default to torchrun's ``WORLD_SIZE`` and
    ``RANK``; with neither given nor set, this returns ``device`` and starts
    no group (one process). ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``); give ``file://...`` or
    ``tcp://localhost:<port>`` otherwise. ``backend`` defaults to ``nccl``
    for a CUDA device and ``gloo`` for the CPU; gloo on a card is taken only
    when named. A failed init, NCCL's included, raises: nothing falls back
    to another backend. With a group already up this joins nothing and
    returns the rank's device."""
    from ..utils.runtime import resolve_device

    if active():
        return device_for_rank(resolve_device(device))
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return resolve_device(device)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    dev = device_for_rank(resolve_device(device))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev  # the communicator is built here, so a failure raises here
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    probe = torch.ones((), device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"{backend} all-reduce over {world_size} ranks gave {probe.item()}")
    return dev


def finalize() -> None:
    """Leave the process group, if one is up."""
    if active():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device="cuda"):
    """An entry point's process group: ``initialize(device)`` (torchrun's
    environment, or one process), this rank's device yielded, and the group
    left at the end if this started it."""
    started = not active()
    dev = initialize(device)
    try:
        yield dev
    finally:
        if started:
            finalize()


def main_print(*args, **kw) -> None:
    """``print`` on rank 0 only."""
    if is_main():
        print(*args, **kw)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def shard_rows(x):
    """This rank's contiguous rows of a global batch (``P('data')``; the
    JAX package's ``shard_batch``). Raises when the world size does not
    divide the batch."""
    n = world_size()
    if n == 1:
        return x
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split over {n} ranks")
    k = b // n
    r = rank()
    return x[r * k:(r + 1) * k]


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks, on every rank. Under the convention that the
    objective is the sum of the ranks' losses, the adjoint of this map is
    itself, so the backward is the same all-reduce, differentiable again."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def gather_rows(x):
    """The global batch from every rank's rows, differentiable to any order:
    the rank's rows are placed in zeros and summed over ranks, so the
    backward all-reduces the full gradient and takes the rank's slice. The
    sum with zeros is exact."""
    if not active():
        return x
    n, r = world_size(), rank()
    zeros = torch.zeros_like(x)
    return _AllReduceSum.apply(torch.cat([zeros] * r + [x] + [zeros] * (n - 1 - r)))


def mean_over_ranks(x):
    """``x`` averaged over ranks, differentiable (the logged metrics, and
    ``global_mean``)."""
    if not active():
        return x
    return _AllReduceSum.apply(x) / world_size()


def global_mean(x, dim=None):
    """The mean over every rank's rows (over all elements, or over ``dim``),
    differentiable: the mean of the ranks' means, which the equal shards
    make the global batch's."""
    return mean_over_ranks(x.mean() if dim is None else x.mean(dim))


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """The psum that XLA inserts for replicated parameters: every gradient
    summed over ranks and divided by the world size, in one all-reduce of
    one flat bucket, written back into ``.grad``. Parameters without a
    gradient take no part (every rank runs the same graph, so every rank
    has the same set)."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    if world_size() > 1:
        flat.div_(world_size())
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """The check of ``replicate``: every rank must hold rank 0's parameters
    and buffers. Each rank builds them from the same seed or checkpoint, so
    a difference is a fault, and raises on every rank."""
    if not active():
        return
    flat = torch.cat([t.reshape(-1) for t in (*module.parameters(), *module.buffers())])
    theirs = flat.clone()
    dist.broadcast(theirs, 0)
    same = torch.tensor(float(torch.equal(flat, theirs)), device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if same.item() != 1.0:
        raise RuntimeError(f"{type(module).__name__}: the ranks built different weights")


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]
