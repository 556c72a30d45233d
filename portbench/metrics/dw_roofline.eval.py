"""A serving forward's depthwise work at its roofline over the port's depthwise
kernels' device time, in %."""

from portbench import layers


def read(rec):
    return layers.dw_roofline(rec)
