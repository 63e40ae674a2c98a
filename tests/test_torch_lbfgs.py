"""The port's L-BFGS (projector/lbfgs.py) against ``optax.lbfgs()`` (memory
10, the zoom line search with 20 steps and a first guess of 1, the value and
gradient reused from the line search through
``optax.value_and_grad_from_state``), in float64 on the CPU, 15 iterations:

- a 10-D Rosenbrock from a seeded start;
- a steep quartic (a double well per coordinate, 100 (x^2 - 1)^2 + x/2),
  where the first guess often fails: from this start the search grows the
  step up to 13 and the zoom takes up to 6 evaluations.

Iterates agree to 1e-10 relative (measured 1e-14), the accepted steps to
1e-10 relative, and the evaluations per iteration exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from content_aware_gan_compression_torch.projector import LBFGS
from torch_train_util import torch_threads  # noqa: F401

N_ITERS = 15
RTOL = 1e-10


def _rosenbrock(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()


def _double_well(x):
    return (100.0 * (x ** 2 - 1) ** 2 + 0.5 * x).sum()


PROBLEMS = {
    "rosenbrock": (_rosenbrock, lambda: np.random.RandomState(0).randn(10)),
    "steep_quartic": (_double_well, lambda: np.random.RandomState(9).randn(10) * 2.0),
}


def _optax_run(fn, x0):
    """Iterates, accepted steps and line-search evaluations of optax.lbfgs."""
    with jax.enable_x64(True):
        tx = optax.lbfgs()
        value_and_grad = optax.value_and_grad_from_state(fn)

        @jax.jit  # one compile for the 15 iterations, not one dispatch per op
        def iterate(x, state):
            value, grad = value_and_grad(x, state=state)
            updates, state = tx.update(grad, state, x, value=value, grad=grad, value_fn=fn)
            return optax.apply_updates(x, updates), state

        x = jnp.asarray(x0, jnp.float64)
        state = tx.init(x)
        xs, steps, evals = [], [], []
        for _ in range(N_ITERS):
            x, state = iterate(x, state)
            xs.append(np.asarray(x))
            steps.append(float(state[2].learning_rate))
            evals.append(int(state[2].info.num_linesearch_steps))
    return xs, steps, evals


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_lbfgs_matches_optax(name):
    fn, start = PROBLEMS[name]
    x0 = start()
    want_x, want_steps, want_evals = _optax_run(fn, x0)

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        value = fn(x)
        (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad

    opt = LBFGS()
    x = torch.from_numpy(x0.copy())
    got_evals = []
    for i in range(N_ITERS):
        before = opt.evaluations
        x, _ = opt.step(x, value_and_grad)
        # the first iteration also evaluates the starting point
        got_evals.append(opt.evaluations - before - (i == 0))
        np.testing.assert_allclose(x.numpy(), want_x[i], rtol=0,
                                   atol=RTOL * np.abs(want_x[i]).max(), err_msg=f"iterate {i}")
        np.testing.assert_allclose(opt.last.stepsize, want_steps[i], rtol=RTOL,
                                   err_msg=f"step {i}")
        assert opt.last.steps == got_evals[-1]
    assert got_evals == want_evals
    if name == "steep_quartic":  # the search grows the step, and the zoom takes several
        assert max(want_evals) >= 4 and any(s > 1.0 for s in want_steps)


def test_lbfgs_float32():
    """A float32 vector stays float32, and the values decrease."""
    opt = LBFGS()
    x = torch.full((4,), 2.0)

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        value = _double_well(x)
        (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad

    values = []
    for _ in range(5):
        x, value = opt.step(x, value_and_grad)
        values.append(value)
    assert x.dtype == torch.float32 and values == sorted(values, reverse=True)
