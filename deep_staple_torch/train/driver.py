"""Training driver: the models (`deep_staple_tpu/train/driver.py:75-99`) and
the slab-warmup model of the async-BatchNorm schedule (`:393-418`).
`train_dl` comes with slice 4 of the port."""

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


def make_warmup_model(model, config: TrainConfig, num_classes: int):
    """The model of the first `bn_warmup_epochs` under async BatchNorm: the
    same network with slab BatchNorm, sharing every parameter and buffer
    (`count` included) with `model`, so that one optimizer and one set of
    running statistics serve both phases (`driver.py:393-418`)."""
    warm, _ = make_model(config.replace(bn_mode="slab"), num_classes)
    mods = dict(model.named_modules())
    for name, mod in warm.named_modules():
        mod._parameters = mods[name]._parameters
        mod._buffers = mods[name]._buffers
    return warm
