from .config import DataParamMode, LabelDisturbanceMode, TrainConfig
from .device import resolve_device

__all__ = ["DataParamMode", "LabelDisturbanceMode", "TrainConfig", "resolve_device"]
