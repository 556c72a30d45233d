"""A serving batch's model FLOPs a second over the dense peak of the
configuration's dtype, in %."""

from portbench import layers


def read(rec):
    return layers.mfu(rec)
