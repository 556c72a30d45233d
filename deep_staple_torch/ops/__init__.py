from .conv3d_dw import depthwise_conv3d, depthwise_conv3d_plain
from .dice import dice_from_int_labels
from .morphology import dilate_label_class
from .resample import interpolate_sample, resize_nd

__all__ = [
    "depthwise_conv3d", "depthwise_conv3d_plain", "dice_from_int_labels", "dilate_label_class",
    "interpolate_sample", "resize_nd",
]
