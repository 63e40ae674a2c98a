"""eltwise_ms.train: device ms per iteration (or batch) of the profiled window's
ATen elementwise, copy and reduction kernels."""

from benchmark.lib import readers


def read(data):
    return readers.category_ms(data, readers.ELTWISE)
