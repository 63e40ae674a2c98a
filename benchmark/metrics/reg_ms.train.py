"""reg_ms.train: device ms per window iteration of R1 and path length, from CUDA
events at ``Trainer.step``'s phase boundaries."""

from benchmark.lib import readers


def read(data):
    return readers.phase_ms(data, ("d_reg", "g_reg"))
