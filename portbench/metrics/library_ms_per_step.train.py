"""Device ms a training step in kernels that are not the port's (cuDNN, cuBLAS,
ATen elementwise and reductions), from the profiler."""

from portbench import layers


def read(rec):
    return layers.library_ms(rec)
