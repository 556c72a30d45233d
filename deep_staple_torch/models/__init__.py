from .lraspp3d import MobileNetASPP3D, MobileNetLRASPP3D, count_params, init_weights
from .norm import BatchNorm

__all__ = ["BatchNorm", "MobileNetASPP3D", "MobileNetLRASPP3D", "count_params", "init_weights"]
