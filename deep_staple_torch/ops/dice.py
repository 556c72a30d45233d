"""Hard Dice metrics (`deep_staple_tpu/ops/dice.py`).

Per sample and class, Dice = 2*TP / (|pred==c| + |target==c|), NaN where
both are empty when ``nan_for_unlabeled_target`` (the reference's bare
division, `deep_staple/metrics.py:68-111`), else with a 1e-10 epsilon.
"""

from __future__ import annotations

import numpy as np
import torch


def _ratio(tp, pc, tc, nan_for_unlabeled_target: bool):
    denom = pc + tc
    if nan_for_unlabeled_target:
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        return torch.where(denom > 0, 2.0 * tp / safe, torch.full_like(denom, float("nan")))
    return 2.0 * tp / (denom + 1e-10)


def _dice_nd(predicted_lbls, target_lbls, one_hot_torch_style: bool,
             nan_for_unlabeled_target: bool):
    if predicted_lbls.shape != target_lbls.shape:
        raise ValueError(f"shapes differ: {tuple(predicted_lbls.shape)} and {tuple(target_lbls.shape)}")
    if one_hot_torch_style:
        predicted_lbls = torch.movedim(predicted_lbls, -1, 1)
        target_lbls = torch.movedim(target_lbls, -1, 1)
    p = predicted_lbls == 1
    t = target_lbls == 1
    axes = tuple(range(2, p.dim()))
    return _ratio((p & t).sum(dim=axes).float(), p.sum(dim=axes).float(),
                  t.sum(dim=axes).float(), nan_for_unlabeled_target)


def dice2d(predicted_lbls, target_lbls, one_hot_torch_style: bool,
           nan_for_unlabeled_target: bool = True):
    """Per-sample, per-class hard Dice of 2D one-hot labels: (B, C, H, W),
    or (B, H, W, C) when ``one_hot_torch_style`` -> (B, C) float32.
    Reference: `deep_staple/metrics.py:7-29`, `deep_staple_tpu/ops/dice.py:38`."""
    if predicted_lbls.dim() != 4:
        raise ValueError(f"2D dice input must be 4D but is {tuple(predicted_lbls.shape)}")
    return _dice_nd(predicted_lbls, target_lbls, one_hot_torch_style, nan_for_unlabeled_target)


def dice3d(predicted_lbls, target_lbls, one_hot_torch_style: bool,
           nan_for_unlabeled_target: bool = True):
    """Per-sample, per-class hard Dice of 3D one-hot labels: (B, C, D, H, W),
    or (B, D, H, W, C) when ``one_hot_torch_style`` -> (B, C) float32.
    Reference: `deep_staple/metrics.py:37-60`."""
    if predicted_lbls.dim() != 5:
        raise ValueError(f"3D dice input must be 5D but is {tuple(predicted_lbls.shape)}")
    return _dice_nd(predicted_lbls, target_lbls, one_hot_torch_style, nan_for_unlabeled_target)


def dice_from_int_labels(pred, target, num_classes: int, nan_for_unlabeled_target: bool = True):
    """(B, *spatial) integer maps -> (B, num_classes) float32 Dice."""
    reduce_axes = tuple(range(1, pred.dim()))
    outs = []
    for c in range(num_classes):
        p = pred == c
        t = target == c
        outs.append(_ratio((p & t).sum(dim=reduce_axes).float(), p.sum(dim=reduce_axes).float(),
                           t.sum(dim=reduce_axes).float(), nan_for_unlabeled_target))
    return torch.stack(outs, dim=-1)


def _host(b_dice) -> np.ndarray:
    if isinstance(b_dice, torch.Tensor):
        b_dice = b_dice.detach().cpu().numpy()
    return np.asarray(b_dice)


def batch_dice_over_all(b_dice, exclude_bg: bool = True) -> float:
    """NaN-mean of a (B, C) Dice array over all samples and classes
    (`deep_staple/utils/torch_utils.py:272-277`, `deep_staple_tpu/ops/dice.py:90`)."""
    sub = _host(b_dice)[:, 1 if exclude_bg else 0:]
    if np.all(np.isnan(sub)):
        return float("nan")
    return float(np.nanmean(sub))


def batch_dice_per_class(b_dice, class_tags, exclude_bg: bool = True) -> dict:
    """Per-class NaN-mean dict (`deep_staple/utils/torch_utils.py:255-268`,
    `deep_staple_tpu/ops/dice.py:105`)."""
    arr = _host(b_dice)
    score = {}
    for cls_idx, tag in enumerate(class_tags):
        if exclude_bg and cls_idx == 0:
            continue
        col = arr[:, cls_idx]
        score[tag] = float("nan") if np.all(np.isnan(col)) else float(np.nanmean(col))
    return score
