"""Loss functions of the DeepSTAPLE training objective
(`deep_staple_tpu/train/losses.py:22-80`).

  * class-weighted CE with torch `CrossEntropyLoss(weight)` weighted-mean
    reduction (`main_deep_staple.py:716`),
  * per-sample voxel-mean CE for the DP loss (:738-739),
  * data-parameter weighting: sigmoid, batch-mean normalization (:741-744),
    optional fixed-weighting divide (:747-748),
  * risk regularization -w * |pred > 0| / numel (:750-757).

Logits are channels-last (B, *spatial, C) float32.

With a data group (`parallel/mesh.py`) each rank holds its rows of the
global batch, and a loss returns this rank's share: the shares sum over the
ranks to the loss of the global batch, and the sum of the ranks' gradients
is its gradient. The CE's denominator sum(w[t]) and the DP weights' batch
mean are taken over the global batch (the mean through an all-reduce that
carries its gradient to every rank's DP rows).

With a space group as well (`parallel/spatial.py`) a rank holds a slab of
H of its data rank's samples, and its share is its slab's: the CE's
denominator is summed over data x space; a sample's voxel-mean CE is the
slab's NLL sum over the sample's whole voxel count (`voxels`), and the risk
term's count of `pred > 0` the slab's over the same count, so that the DP
loss's shares sum over the space group to the sample's terms with no
collective; the DP weights' batch mean spans the data group only, because
the ranks of a space group hold the same samples.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _nll(logits, targets):
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long().unsqueeze(-1)).squeeze(-1)


def weighted_cross_entropy(logits, targets, class_weights, data=None, space=None):
    """sum(w[t] * nll) / sum(w[t]), as nn.CrossEntropyLoss(weight=w); with a
    data group (and a space group), this rank's numerator over the global
    denominator."""
    w = class_weights[targets.long()]
    den = w.sum()
    for group in (data, space):
        den = den if group is None else group.sum(den)
    return (_nll(logits, targets) * w).sum() / den


def per_sample_cross_entropy(logits, targets, voxels=None):
    """Unweighted CE, voxel mean per batch sample -> (B,); with `voxels`
    (a sample's whole voxel count, of which the logits hold a slab) this
    slab's NLL sum over it."""
    nll = _nll(logits, targets).reshape(logits.shape[0], -1)
    return nll.mean(dim=-1) if voxels is None else nll.sum(dim=-1) / voxels


def dp_weights_from_params(bare_params_batch, fixed_weighting_batch=None, data=None):
    """sigmoid -> batch-mean normalize (over the global batch with a data
    group) -> optional fixed-weighting divide."""
    w = torch.sigmoid(bare_params_batch)
    w = w / (w.mean() if data is None else data.mean(w.mean()))
    if fixed_weighting_batch is not None:
        w = w / fixed_weighting_batch
    return w


def dp_loss_fn(dp_logits, targets, bare_params_batch, fixed_weighting_batch=None,
               use_risk_regularization: bool = True, data=None, voxels=None):
    """The full data-parameter loss, sum-reduced (reference :738-759); with a
    data group, this rank's rows' share of it; with `voxels` (the logits a
    slab of samples of that many voxels), this slab's share."""
    ce = per_sample_cross_entropy(dp_logits, targets, voxels)
    w = dp_weights_from_params(bare_params_batch, fixed_weighting_batch, data)
    loss = (ce * w).sum()
    if use_risk_regularization:
        pred = dp_logits.detach().argmax(dim=-1)
        p_pred_num = (pred > 0).reshape(pred.shape[0], -1).sum(dim=-1).float()
        numel = float(math.prod(pred.shape[1:]) if voxels is None else voxels)
        loss = loss + (-w * p_pred_num / numel).sum()
    return loss
