"""mfu.train: % of the chips' dense peak for the cell's compute type that the
window's model FLOPs per second reach (no recomputation counted)."""

from benchmark.lib import readers


def read(data):
    return readers.mfu_percent(data)
