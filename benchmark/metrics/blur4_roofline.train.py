"""blur4_roofline.train: % of the bytes bound reached by the blur4 kernel's launches: the
least time each call's input and output bytes take at 3.35 TB/s, summed,
over the launches' device time."""

from benchmark.lib import readers


def read(data):
    return readers.roofline(data, ("blur4",))
