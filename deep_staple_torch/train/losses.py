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

Deep supervision (`deep_supervision_ce`, for a model whose train forward
returns "aux" heads: nnU-Net v2's `PlainConvUNet`, `models/
plainconvunet3d.py`): nnU-Net's `DeepSupervisionWrapper` over DeepSTAPLE's
class-weighted CE,

    L = sum_k w_k CE_k,   w = [1, 1/2, 1/4, ...] with the last weight 0,
                          normalised to sum 1 ([1, 1/2, 1/4, 1/8, 0] / 1.875
                          for the five heads of the 3d_fullres network),

where CE_k is `weighted_cross_entropy` of head k against the label selected
at that head's grid by order 0 (nearest): `lbl[:, ::sD, ::sH, ::sW]` at the
head's cumulative stride. A head of weight 0 is computed by the model, but
its loss is skipped, as the wrapper skips it. Departures from nnU-Net: no
Dice term (DeepSTAPLE's objective is the CE alone, and the data parameters
weight a per-sample CE), and the targets are strided selections where
nnU-Net resamples the segmentation with order 0 (the same voxels where the
extent divides by the stride).
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


def deep_supervision_weights(heads: int) -> list:
    """nnU-Net's weights of `heads` outputs: 1 / 2^k, the last 0, normalised."""
    w = [0.5**k for k in range(heads)]
    w[-1] = 0.0
    return [x / sum(w) for x in w]


def deep_supervision_ce(logits, targets, class_weights):
    """sum_k w_k CE_k over the heads `logits` (full resolution first, each
    (B, D_k, H_k, W_k, C)) against order-0 selections of `targets` (B, D,
    H, W) at each head's stride; heads of weight 0 are skipped. -> (loss,
    the number of heads whose CE was computed)."""
    total, used = None, 0
    for w, head in zip(deep_supervision_weights(len(logits)), logits):
        if w == 0.0:
            continue
        step = [n // m for n, m in zip(targets.shape[1:], head.shape[1:4])]
        tgt = targets[:, ::step[0], ::step[1], ::step[2]]
        ce = w * weighted_cross_entropy(head, tgt, class_weights)
        total = ce if total is None else total + ce
        used += 1
    return total, used
