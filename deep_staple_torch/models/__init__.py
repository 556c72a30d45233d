from .lraspp2d import LRASPPMobileNetV3Large2D
from .lraspp3d import MobileNetASPP3D, MobileNetLRASPP3D, count_params, init_weights
from .norm import BatchNorm
from .plainconvunet3d import PlainConvUNet3D

__all__ = ["BatchNorm", "LRASPPMobileNetV3Large2D", "MobileNetASPP3D", "MobileNetLRASPP3D",
           "PlainConvUNet3D", "count_params", "init_weights"]
