"""peak_gb.train: the run's largest ``torch.cuda.max_memory_allocated`` over the
ranks, in GB."""

from benchmark.lib import readers


def read(data):
    return readers.peak_gb(data)
