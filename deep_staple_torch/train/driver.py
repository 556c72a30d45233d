"""Training driver. This slice ports `make_model` only
(`deep_staple_tpu/train/driver.py:75-99`); `train_dl` comes later."""

from __future__ import annotations

import torch

from ..core.config import TrainConfig
from ..models import MobileNetLRASPP3D


def make_model(config: TrainConfig, num_classes: int):
    """-> (model, input channels). The 3D model only for now."""
    if config.use_2d_normal_to is not None:
        raise NotImplementedError("the 2D model comes with a later slice of the port")
    in_ch = 12 if config.use_mind else 1
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else None
    model = MobileNetLRASPP3D(
        num_classes=num_classes,
        use_checkpointing=config.use_checkpointing,
        dtype=dtype,
        bn_mode=config.bn_mode,
        in_channels=in_ch,
    )
    return model, in_ch
