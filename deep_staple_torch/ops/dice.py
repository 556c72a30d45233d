"""Hard Dice from integer label maps (`deep_staple_tpu/ops/dice.py:66-87`).

Per sample and class, Dice = 2*TP / (|pred==c| + |target==c|), NaN where
both are empty when ``nan_for_unlabeled_target`` (the reference's bare
division, `deep_staple/metrics.py:68-111`), else with a 1e-10 epsilon.
"""

from __future__ import annotations

import torch


def dice_from_int_labels(pred, target, num_classes: int, nan_for_unlabeled_target: bool = True):
    """(B, *spatial) integer maps -> (B, num_classes) float32 Dice."""
    reduce_axes = tuple(range(1, pred.dim()))
    outs = []
    for c in range(num_classes):
        p = pred == c
        t = target == c
        tp = (p & t).sum(dim=reduce_axes).float()
        pc = p.sum(dim=reduce_axes).float()
        tc = t.sum(dim=reduce_axes).float()
        denom = pc + tc
        if nan_for_unlabeled_target:
            safe = torch.where(denom > 0, denom, torch.ones_like(denom))
            outs.append(torch.where(denom > 0, 2.0 * tp / safe, torch.full_like(denom, float("nan"))))
        else:
            outs.append(2.0 * tp / (denom + 1e-10))
    return torch.stack(outs, dim=-1)
