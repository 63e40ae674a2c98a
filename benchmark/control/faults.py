"""Faults planted in the system under test, to show that ``correct`` comes
out false when the timed path is broken. Each is a context manager that
patches the program while it is open; none is used by a benchmark run.

- ``unchanged_state``: the optimizers' step returns leaving every parameter
  and its state as they were;
- ``half_batch``: the GAN losses take the mean over the first half of the
  batch and leave the rest out;
- ``no_exchange``: the gradients are not all-reduced over the ranks;
- ``altered_answer``: the FID stream's features of each batch's first row
  are altered where they are produced.
"""

from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = ("unchanged_state", "half_batch", "no_exchange", "altered_answer")


def _half(fn):
    def wrapped(*preds):
        return fn(*[p[: max(1, p.shape[0] // 2)] for p in preds])
    return wrapped


@contextlib.contextmanager
def plant(name: str):
    from content_aware_gan_compression_torch import parallel
    from content_aware_gan_compression_torch.evaluation import fid
    from content_aware_gan_compression_torch.train import steps

    with contextlib.ExitStack() as stack:
        if name == "unchanged_state":
            stack.enter_context(mock.patch.object(steps.AdamNoMu, "step",
                                                  lambda self, closure=None: None))
        elif name == "half_batch":
            stack.enter_context(mock.patch.object(steps, "d_logistic_loss",
                                                  _half(steps.d_logistic_loss)))
            stack.enter_context(mock.patch.object(steps, "g_nonsaturating_loss",
                                                  _half(steps.g_nonsaturating_loss)))
        elif name == "no_exchange":
            stack.enter_context(mock.patch.object(parallel, "all_reduce_grads",
                                                  lambda params: None))
        elif name == "altered_answer":
            step = fid._feature_step

            def altered(*args, **kw):
                feats = step(*args, **kw).clone()
                feats[0] = feats[0] * 1.01 + 0.01
                return feats
            stack.enter_context(mock.patch.object(fid, "_feature_step", altered))
        else:
            raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
        yield
