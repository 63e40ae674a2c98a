"""What a driver gets from ``run.py``: the cell's files, the run's
arguments, its device and rank, and the helpers every driver shares."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Context:
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # wall clock (time.time()) of the command's start
    rank: int = 0
    world: int = 1
    host_group: object = None  # a gloo group for host-side agreement across ranks
    off_clock_s: float = 0.0  # set-up seconds spent on the reference's work

    def log(self, *parts) -> None:
        print(f"[{self.name} rank {self.rank}]", *parts, file=sys.stderr, flush=True)

    @property
    def limits(self) -> dict:
        return self.cell.get("limits", {})

    def fence(self) -> None:
        """Every rank's queued work done: a barrier, then this card's."""
        if self.world > 1:
            dist.barrier()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def any_rank(self, flag: bool) -> bool:
        """``flag`` or'ed over the ranks on the host, without touching the
        card's queue."""
        if self.world == 1:
            return flag
        t = torch.tensor([1.0 if flag else 0.0])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def setup_seconds(self) -> float:
        """Seconds since the command's start, less the reference's work in
        the set-up (``off_clock``)."""
        return time.time() - self.t0 - self.off_clock_s

    @contextlib.contextmanager
    def off_clock(self):
        """Keeps the work inside out of ``setup_seconds``: the benchmark's
        reference work that the set-up needs, which no change of the
        system under test can shorten."""
        t = time.time()
        try:
            yield
        finally:
            self.off_clock_s += time.time() - t

    def stage(self, name: str) -> None:
        """Logs how far into the run a stage of the set-up ends."""
        self.log(f"{name} done at {self.setup_seconds():.2f} s")

    def reduce(self, value: float, op=dist.ReduceOp.MAX) -> float:
        """``value`` reduced over the ranks (on the host)."""
        if self.world == 1:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=op, group=self.host_group)
        return float(t.item())
