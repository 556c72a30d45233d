"""The training step's depthwise work (the forwards it needs, both gradients)
at its roofline, over the port's depthwise kernels' device time, in %."""

from portbench import layers


def read(rec):
    return layers.dw_roofline(rec)
