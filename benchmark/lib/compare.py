"""The numbers that decide ``correct``, each a gap between what the system
produced and what the reference computes from the same inputs, and the
check of each against the cell's limit.

Training (the first steps of the object the window then drives):
- ``loss``: the larger relative gap of the first iteration's D and G
  losses;
- ``r1_path_kd``: the largest relative gap of the first iteration's R1
  penalty, path-length penalty, KD L1 and KD LPIPS terms: the double
  backward's two objectives and the content-aware distillation;
- ``grad_d`` and ``grad_g``: the first gradient D's and G's optimizer
  received, leaf by leaf: the gap between the two norms over the larger of
  the reference's norm of that leaf and of the median leaf; the worst leaf.
  D's comes first in the iteration, from the weights as drawn; G's comes
  after D's first two steps (the D step and R1), and Adam's first step
  moves each weight by about lr * sign(g), so a D gradient that rounding
  flips moves G's first gradient too: the two are held apart. The leaves
  are those of more than one element: the one-element leaves, the noise
  strengths, take as gradient a cancelling sum over a whole feature map,
  which the system's compute type rounds far more than any other leaf's
  (PERF.md);
- ``change``: the same for each leaf's change over the steps, of the
  student, D and the EMA, every leaf but those whose reference gradient is
  under a thousandth of the median leaf's: Adam moves those by round-off
  alone.
The later iterations' losses are left out: Adam's first steps move each
weight by about lr * sign(g), so a gradient that rounding flips moves the
two runs apart from the second step on, whatever the precision.
Inference: ``features``, the largest relative L2 gap of a checked row.
"""

from __future__ import annotations

import math
import statistics

DEAD_LEAF = 1e-3
REG_KD = ("r1", "path", "kd_l1", "kd_lpips")


def loss_gap(prog: dict, ref: dict, names=("d", "g")) -> float:
    return max(abs(prog[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in names)


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |norm_p - norm_r| / max(norm_r, median leaf's)."""
    keys = [k for k in ref if keep is None or k in keep]
    if not keys:
        return 0.0
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def live_leaves(first_grad: dict) -> set:
    """The leaves whose gradient is at least ``DEAD_LEAF`` of the median's."""
    med = statistics.median(first_grad.values())
    return {k for k, v in first_grad.items() if v >= DEAD_LEAF * med}


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {'losses': [per step], 'grad': {net: {leaf:
    norm}}, 'change': {net: {leaf: norm}}, 'sizes': {net: {leaf: elements}}};
    the EMA's leaves follow the student's rule."""
    grads = {}
    for n in ("d", "g"):
        multi = {k for k, size in ref["sizes"][n].items() if size > 1}
        grads[f"grad_{n}"] = leaf_gap(prog["grad"][n], ref["grad"][n], multi)
    change = 0.0
    for net, leaves in ref["change"].items():
        keep = live_leaves(ref["grad"]["g" if net == "g_ema" else net])
        change = max(change, leaf_gap(prog["change"][net], leaves, keep))
    first_p, first_r = prog["losses"][0], ref["losses"][0]
    return {"loss": loss_gap(first_p, first_r), "r1_path_kd": loss_gap(first_p, first_r, REG_KD),
            **grads, "change": change}


def within(numbers: dict, limits: dict) -> bool:
    """Every number finite and at most its limit; a number without a limit
    fails."""
    return all(math.isfinite(v) and limits.get(k) is not None and v <= limits[k]
               for k, v in numbers.items())


def lines(numbers: dict, limits: dict) -> list[str]:
    return [f"{k} {v:.6g} limit {limits.get(k)}" for k, v in numbers.items()]
