"""main_ms.train: device ms per window iteration of the D step, the G step and
the EMA, from CUDA events at ``Trainer.step``'s phase boundaries."""

from benchmark.lib import readers


def read(data):
    return readers.phase_ms(data, ("d", "g", "ema"))
