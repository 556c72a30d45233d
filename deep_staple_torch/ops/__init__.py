from .conv3d_dw import depthwise_conv3d, depthwise_conv3d_plain
from .dice import dice_from_int_labels
from .resample import interpolate_sample, resize_nd

__all__ = [
    "depthwise_conv3d", "depthwise_conv3d_plain", "dice_from_int_labels",
    "interpolate_sample", "resize_nd",
]
