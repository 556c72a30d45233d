"""Device ms a training step in kernels that are neither the library's
convolutions (`portbench/convs.py`) nor the port's own (`trace.PORT_KERNELS`):
normalisation, activations, concatenations, casts, the losses and the
optimizers, the step's memory-bound part. None where no convolution kernel
ran."""

from portbench import layers
from portbench.convs import conv_seconds
from portbench.trace import port_seconds


def read(rec):
    kernels = rec["trace"]["kernels"]
    conv_s = conv_seconds(kernels)
    if not conv_s:
        return None
    rest = sum(kernels.values()) - conv_s - port_seconds(kernels)
    return layers.per_unit_ms(rest, rec["trace"]["units"])
