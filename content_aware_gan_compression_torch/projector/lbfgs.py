"""L-BFGS with a zoom line search: ``optax.lbfgs(learning_rate=None)`` (optax
0.2.6) in PyTorch, the optimizer of the JAX package's projector.

``optax.lbfgs`` chains three transformations, each kept here in its order of
operations:

- ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: the two-loop
  recursion over a ring of the last 10 (dw, du) pairs, on an identity scaled
  by ``dw.du / du.du`` of the newest pair (by ``min(1, 1/|g|)`` on the first
  step);
- ``scale(-1)``: the search direction is minus the preconditioned gradient;
- ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')``: Nocedal and Wright's algorithms 3.5/3.6
  with Hager and Zhang's approximate decrease test, cubic then quadratic
  interpolation with safeguards, then bisection, and a fall back to the best
  step with a sufficient decrease (or, with none, to the last one tried)
  when 20 steps pass or the interval shrinks below 1e-5.

As with ``optax.value_and_grad_from_state``, an iteration reuses the value
and gradient of the line search's accepted step, so it costs only the line
search's evaluations (the first iteration one more).

The optimizer works on one flat vector. Scalar arithmetic runs on the host
in the vector's dtype (numpy scalars, multiplied into tensors as Python
floats), as JAX runs it in the parameters' dtype; the dot products run where
the vector lives. ``torch.optim.LBFGS`` has
another line search, first step and stopping rule, so it is not used.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class LineSearchResult:
    stepsize: float
    value: float
    grad: torch.Tensor
    steps: int  # evaluations of the objective


def _nan_to_inf(x):
    return np.inf if np.isnan(x) else x


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when it has none (optax's ``_cubicmin``)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the parabola through (a, fa), (b, fb) with slope
    fpa at a (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


MEMORY_SIZE = 10  # optax.lbfgs's (dw, du) pairs
# scale_by_zoom_linesearch's defaults (optax.lbfgs passes only the first)
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4  # sufficient decrease (Armijo)
CURV_RTOL = 0.9  # small curvature
APPROX_DEC_RTOL = 1e-6  # Hager and Zhang's approximate decrease
INTERVAL_THRESHOLD = 1e-5  # stepsize_precision
TOL = 0.0


class ZoomLineSearch:
    """optax's ``zoom_linesearch`` as ``optax.lbfgs`` configures it: 20
    steps, no maximal step, a first guess of 1 on every call, and
    ``scale_by_zoom_linesearch``'s other defaults (the constants above)."""

    def _decrease_error(self, st, stepsize, value, slope):
        err = value - st["value_init"] - SLOPE_RTOL * stepsize * st["slope_init"]
        approx = slope - (2 * SLOPE_RTOL - 1.0) * st["slope_init"]
        delta = value - st["value_init"] - APPROX_DEC_RTOL * np.abs(st["value_init"])
        err = np.minimum(np.maximum(approx, delta), err)
        return _nan_to_inf(np.maximum(err, 0.0))

    def _curvature_error(self, st, slope):
        err = np.abs(slope) - CURV_RTOL * np.abs(st["slope_init"])
        return _nan_to_inf(np.maximum(err, 0.0))

    def _evaluate(self, st, stepsize):
        value, grad = st["fn"](st["params"] + float(stepsize) * st["updates"])
        slope = st["dtype"](torch.dot(grad, st["updates"]).item())
        return st["dtype"](value), grad, slope

    def _search_interval(self, st):
        """Algorithm 3.5 of Nocedal and Wright: grow the step until an
        interval holding a good one is found."""
        it = st["count"]
        new = st["dtype"](st["stepsize_guess"] if it == 0 else INCREASE_FACTOR * st["stepsize"])
        value, grad, slope = self._evaluate(st, new)
        dec = self._decrease_error(st, new, value, slope)
        curv = self._curvature_error(st, slope)
        error = np.maximum(dec, curv)
        if dec <= TOL:
            st.update(safe_stepsize=new, safe_value=value, safe_grad=grad)
        high_to_new = dec > 0.0 or (value >= st["value"] and it > 0)
        low_to_new = slope >= 0.0 and not high_to_new
        prev = (st["stepsize"], st["value"], st["slope"])
        if low_to_new:
            (st["low"], st["value_low"], st["slope_low"]), (
                st["high"], st["value_high"], st["slope_high"]) = (new, value, slope), prev
        else:
            (st["low"], st["value_low"], st["slope_low"]), (
                st["high"], st["value_high"], st["slope_high"]) = prev, (new, value, slope)
        done = error <= TOL  # without a maximal step, nothing else ends the search
        st.update(count=it + 1, stepsize=new, value=value, grad=grad, slope=slope,
                  decrease_error=dec, interval_found=high_to_new or low_to_new or done, done=done,
                  failed=it + 1 >= MAX_LINESEARCH_STEPS and not done,
                  cubic_ref=st["low"], value_cubic_ref=st["value_low"])

    def _zoom_into_interval(self, st):
        """Algorithm 3.6 of Nocedal and Wright: shrink the interval around a
        cubic, quadratic or bisection point."""
        it = st["count"]
        low, value_low, slope_low = st["low"], st["value_low"], st["slope_low"]
        high, value_high, slope_high = st["high"], st["value_high"], st["slope_high"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        too_small = delta <= INTERVAL_THRESHOLD
        with np.errstate(all="ignore"):
            cubic = _cubicmin(low, value_low, slope_low, high, value_high, st["cubic_ref"],
                              st["value_cubic_ref"])
            quad = _quadmin(low, value_low, slope_low, high, value_high)
        if left + 0.2 * delta < cubic < right - 0.2 * delta:
            middle = cubic
        elif left + 0.1 * delta < quad < right - 0.1 * delta:
            middle = quad
        else:
            middle = (low + high) / 2.0
        middle = st["dtype"](middle)
        value, grad, slope = self._evaluate(st, middle)
        dec = self._decrease_error(st, middle, value, slope)
        curv = self._curvature_error(st, slope)
        error = np.maximum(dec, curv)
        if dec <= TOL and value < st["safe_value"]:
            st.update(safe_stepsize=middle, safe_value=value, safe_grad=grad)
        done = error <= TOL
        high_to_middle = dec > 0.0 or value >= value_low
        high_to_low = slope * (high - low) >= 0.0 and not high_to_middle
        if high_to_middle:
            st.update(high=middle, value_high=value, slope_high=slope)
        if high_to_low:
            st.update(high=low, value_high=value_low, slope_high=slope_low)
        if not high_to_middle:
            st.update(low=middle, value_low=value, slope_low=slope)
        if high_to_middle or high_to_low:
            st.update(cubic_ref=high, value_cubic_ref=value_high)
        else:
            st.update(cubic_ref=low, value_cubic_ref=value_low)
        failed = it + 1 >= MAX_LINESEARCH_STEPS or (too_small and st["safe_stepsize"] > 0.0)
        st.update(count=it + 1, stepsize=middle, value=value, grad=grad, slope=slope,
                  decrease_error=dec, done=done,
                  failed=failed and not done)

    def __call__(self, fn, params, updates, value, grad) -> LineSearchResult:
        """A step along ``updates`` from ``params``, where ``fn(x)`` returns
        (value, gradient) and ``value``, ``grad`` are its result at
        ``params``."""
        dtype = np.float64 if params.dtype == torch.float64 else np.float32
        value = dtype(value)
        slope = dtype(torch.dot(updates, grad).item())
        zero = dtype(0.0)
        st = dict(fn=fn, params=params, updates=updates, dtype=dtype, count=0,
                  stepsize_guess=dtype(1.0), stepsize=zero, value=value, grad=grad, slope=slope,
                  value_init=value, slope_init=slope, decrease_error=np.inf,
                  interval_found=False, done=False, failed=False,
                  low=zero, value_low=value, slope_low=slope, high=zero, value_high=value,
                  slope_high=slope, cubic_ref=zero, value_cubic_ref=value, safe_stepsize=zero,
                  safe_value=value, safe_grad=grad)
        while not (st["done"] or st["failed"]):
            if st["interval_found"]:
                self._zoom_into_interval(st)
            else:
                self._search_interval(st)
            if st["failed"] and (st["safe_stepsize"] > 0.0 or np.isinf(st["decrease_error"])):
                # the best step with a sufficient decrease, or none when even
                # the last one left the domain
                st.update(stepsize=st["safe_stepsize"], value=st["safe_value"],
                          grad=st["safe_grad"])
        return LineSearchResult(float(st["stepsize"]), st["value"], st["grad"], st["count"])


class LBFGS:
    """``optax.lbfgs(learning_rate=None)`` on a flat vector.

    ``step(x, fn)`` takes the current point and ``fn(x) -> (value, grad)``
    (a scalar and a flat tensor like ``x``) and returns ``(new x, value at
    x)``; ``last`` holds the line search's result of the step."""

    def __init__(self):
        self.linesearch = ZoomLineSearch()
        self.count = 0
        self.params = self.updates = None
        self.memory = [None] * MEMORY_SIZE  # (dw, du, rho) per slot; None: rho 0
        self.value, self.grad = math.inf, None  # the last accepted step's
        self.last = None
        self.evaluations = 0

    def _counted(self, fn):
        def wrapped(x):
            self.evaluations += 1
            value, grad = fn(x)
            return float(value), grad.detach()
        return wrapped

    def direction(self, params, grad):
        """``scale_by_lbfgs`` then ``scale(-1)``: minus the L-BFGS
        preconditioned gradient, after storing the newest (dw, du) pair."""
        dtype = np.float64 if params.dtype == torch.float64 else np.float32
        m, count = MEMORY_SIZE, self.count
        memory_idx = count % m
        if count > 0:
            dw, du = params - self.params, grad - self.updates
            vdot = dtype(torch.dot(du, dw).item())
            rho = dtype(0.0) if vdot == 0.0 else dtype(1.0) / vdot
            self.memory[(count - 1) % m] = (dw, du, rho) if rho != 0.0 else None
            denom = dtype(torch.dot(du, du).item())
            gamma = vdot / denom if denom > 0.0 else dtype(1.0)
        else:
            self.memory[m - 1] = None
            norm = dtype(math.sqrt(torch.dot(grad, grad).item()))
            gamma = np.minimum(dtype(1.0), dtype(1.0) / norm)
        # the two-loop recursion, newest pair first; a slot with rho == 0 is
        # an exact no-op in optax's loops, so it is skipped
        order = [(memory_idx + j) % m for j in range(m)]
        vec, alphas = grad, {}
        for idx in reversed(order):
            if self.memory[idx] is not None:
                dw, du, rho = self.memory[idx]
                alphas[idx] = rho * dtype(torch.dot(dw, vec).item())
                vec = vec + float(-alphas[idx]) * du
        vec = float(gamma) * vec
        for idx in order:
            if self.memory[idx] is not None:
                dw, du, rho = self.memory[idx]
                beta = rho * dtype(torch.dot(du, vec).item())
                vec = vec + float(alphas[idx] - beta) * dw
        self.count += 1
        self.params, self.updates = params, grad
        return -vec

    def step(self, x, fn):
        fn = self._counted(fn)
        x = x.detach()
        if math.isinf(self.value) or math.isnan(self.value):
            self.value, self.grad = fn(x)
        value, grad = self.value, self.grad
        updates = self.direction(x, grad)
        self.last = self.linesearch(fn, x, updates, value, grad)
        self.value, self.grad = float(self.last.value), self.last.grad
        return x + self.last.stepsize * updates, value
