"""Hard Dice metrics (`deep_staple_tpu/ops/dice.py:17-87`).

Per sample and class, Dice = 2*TP / (|pred==c| + |target==c|), NaN where
both are empty when ``nan_for_unlabeled_target`` (the reference's bare
division, `deep_staple/metrics.py:68-111`), else with a 1e-10 epsilon.
"""

from __future__ import annotations

import torch


def _ratio(tp, pc, tc, nan_for_unlabeled_target: bool):
    denom = pc + tc
    if nan_for_unlabeled_target:
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        return torch.where(denom > 0, 2.0 * tp / safe, torch.full_like(denom, float("nan")))
    return 2.0 * tp / (denom + 1e-10)


def dice3d(predicted_lbls, target_lbls, one_hot_torch_style: bool,
           nan_for_unlabeled_target: bool = True):
    """Per-sample, per-class hard Dice of 3D one-hot labels: (B, C, D, H, W),
    or (B, D, H, W, C) when ``one_hot_torch_style`` -> (B, C) float32.
    Reference: `deep_staple/metrics.py:37-60`."""
    if predicted_lbls.dim() != 5:
        raise ValueError(f"3D dice input must be 5D but is {tuple(predicted_lbls.shape)}")
    if predicted_lbls.shape != target_lbls.shape:
        raise ValueError(f"shapes differ: {tuple(predicted_lbls.shape)} and {tuple(target_lbls.shape)}")
    if one_hot_torch_style:
        predicted_lbls = torch.movedim(predicted_lbls, -1, 1)
        target_lbls = torch.movedim(target_lbls, -1, 1)
    p = predicted_lbls == 1
    t = target_lbls == 1
    axes = (2, 3, 4)
    return _ratio((p & t).sum(dim=axes).float(), p.sum(dim=axes).float(),
                  t.sum(dim=axes).float(), nan_for_unlabeled_target)


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
