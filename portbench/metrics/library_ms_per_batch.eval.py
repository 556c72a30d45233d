"""Device ms a serving batch in kernels that are not the port's (cuDNN's
dilated ASPP convs, cuBLAS 1x1x1, eval BatchNorm, upsampling), from the
profiler."""

from portbench import layers


def read(rec):
    return layers.library_ms(rec)
