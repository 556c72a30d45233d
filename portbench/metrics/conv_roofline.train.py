"""The training step's dense convolution work at the bf16 (or f32) tensor
peak, over the device seconds a step in the library's convolution kernels
(`portbench/convs.py`), in %. The work is three forwards
(`forward_flops`) less the first conv's input gradient, which training
does not compute. None where no convolution kernel ran or the architecture
does not count that gradient."""

from portbench import archs, flops
from portbench.convs import conv_seconds


def read(rec):
    tr = rec["trace"]
    conv_s = conv_seconds(tr["kernels"])
    module = archs.load(rec["arch"])
    if not conv_s or not tr["units"] or not hasattr(module, "first_input_grad_flops"):
        return None
    args = (rec["arch"], rec["batch"], rec["spatial"])
    work = 3 * module.forward_flops(*args) - module.first_input_grad_flops(*args)
    return 100.0 * work / flops.TENSOR_FLOP_PER_S[rec["dtype"]] / (conv_s / tr["units"])
