"""Eval step (`deep_staple_tpu/train/step.py:251-285`); the train step comes
with the training slice."""

from __future__ import annotations

import torch

from ..core.config import TrainConfig
from ..ops.dice import dice_from_int_labels
from ..ops.resample import interpolate_sample


def make_eval_step(model, config: TrainConfig, num_classes: int, eval_scale_factor: float = 2.0):
    """Validation forward on full 3D volumes at the reference's x2.0 eval
    scale (`HybridIdLoader.py:336`).

    Returns `eval_step(batch) -> (pred, dice)`: `batch["image"]` (B, D, H, W)
    float32 and `batch["label"]` (B, D, H, W) int on the model's device; pred
    is the int32 argmax at the eval scale and dice (B, num_classes) float32
    against the label interpolated the same way.
    """
    if config.use_2d_normal_to is not None:
        raise NotImplementedError("the 2D eval path comes with a later slice of the port")
    if config.use_mind:
        raise NotImplementedError("MIND features come with a later slice of the port")

    def eval_step(batch):
        with torch.inference_mode():
            img, lbl = interpolate_sample(batch["image"], batch["label"], eval_scale_factor, False)
            logits = model(img[..., None], train=False)["out"]
            pred = logits.argmax(dim=-1).to(torch.int32)
            b_dice = dice_from_int_labels(pred, lbl, num_classes)
        return pred, b_dice

    return eval_step
