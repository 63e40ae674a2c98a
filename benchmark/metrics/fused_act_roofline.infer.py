"""fused_act_roofline.infer: % of the bytes bound reached by the StyledConv epilogue's and
masked_scale's launches together, as ``blur4_roofline``."""

from benchmark.lib import readers


def read(data):
    return readers.roofline(data, ("epilogue", "masked_scale"))
