"""idle_share.train: % of the window the card is idle: 1 - its busy time per
iteration (or batch) in the profiled window, the union over streams, x the
window's rate."""

from benchmark.lib import readers


def read(data):
    return readers.idle_percent(data)
