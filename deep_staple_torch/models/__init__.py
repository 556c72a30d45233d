from .lraspp2d import LRASPPMobileNetV3Large2D
from .lraspp3d import MobileNetASPP3D, MobileNetLRASPP3D, count_params, init_weights
from .norm import BatchNorm

__all__ = ["BatchNorm", "LRASPPMobileNetV3Large2D", "MobileNetASPP3D", "MobileNetLRASPP3D",
           "count_params", "init_weights"]
