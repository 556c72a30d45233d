"""MIND-SSC self-similarity descriptors (Heinrich et al., MICCAI 2013), the
12-channel features the network sees with `use_mind`
(`deep_staple_tpu/ops/mind.py`, after `deep_staple/mindssc.py:250-292` as
fixed there).

The 12 pairs of voxel offsets of the 6-neighbourhood at squared distance 2,
the replication-padded image shifted by each offset (a slice of the padded
volume, not a convolution), the Gaussian-smoothed squared difference of each
pair (separable, replicate padding), the minimum over the channels
subtracted, a variance-normalized exponential and the channel order of the
original C++ code. The variance clamp takes the mean over the whole batch,
so the samples of a batch are coupled, as in the JAX version (`mind.py:112`).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _ssc_shift_pairs():
    """The 12 (shift1, shift2) voxel-offset pairs (reference :256-276)."""
    six = np.array([[0, 1, 1], [1, 1, 0], [1, 0, 1], [1, 1, 2], [2, 1, 1], [1, 2, 1]], np.int64)
    dist = ((six[None, :, :] - six[:, None, :]) ** 2).sum(-1)
    x, y = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    mask = (x > y).reshape(-1) & (dist == 2).reshape(-1)
    return six[np.repeat(np.arange(6), 6)][mask], six[np.tile(np.arange(6), 6)][mask]


# The channel order of the original C++ code (reference :290).
_CPP_ORDER = (6, 8, 1, 11, 2, 10, 0, 7, 9, 4, 5, 3)


def _replicate_pad(x, pad: int, axis: int):
    """nn.ReplicationPad semantics along one axis: `pad` copies of the first
    and the last slice."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1).repeat_interleave(pad, dim=axis)
    last = x.narrow(axis, n - 1, 1).repeat_interleave(pad, dim=axis)
    return torch.cat([first, x, last], dim=axis)


def _gauss_kernel(sigma: float):
    n = int(math.ceil(sigma * 3.0 / 2.0)) * 2 + 1
    xs = np.linspace(-(n // 2), n // 2, n)
    w = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (w / w.sum()).astype(np.float32)


def _smooth(x, sigma: float):
    """Separable Gaussian with replicate padding on (B, C, D, H, W)
    (`mind.py:63-81`): a weighted sum of shifted slices along each axis."""
    w = [float(v) for v in _gauss_kernel(sigma)]
    pad = len(w) // 2
    for axis in (2, 3, 4):
        xp = _replicate_pad(x, pad, axis)
        n = x.shape[axis]
        acc = 0.0
        for k, wk in enumerate(w):
            acc = acc + wk * xp.narrow(axis, k, n)
        x = acc
    return x


def mindssc(img, delta: int = 1, sigma: float = 0.8):
    """img (B, 1, D, H, W) float -> (B, 12, D, H, W) MIND-SSC features."""
    if img.dim() != 5 or img.shape[1] != 1:
        raise ValueError(f"expect (B, 1, D, H, W), got {tuple(img.shape)}")
    idx1, idx2 = _ssc_shift_pairs()
    D, H, W = img.shape[2:]
    padded = img
    for axis in (2, 3, 4):
        padded = _replicate_pad(padded, delta, axis)

    def shifted(offsets):
        return torch.cat([padded[:, :, o[0] * delta:o[0] * delta + D,
                                 o[1] * delta:o[1] * delta + H,
                                 o[2] * delta:o[2] * delta + W] for o in offsets], dim=1)

    diff = shifted(idx1) - shifted(idx2)
    ssd = _smooth(diff * diff, sigma)
    mind = ssd - ssd.amin(dim=1, keepdim=True)
    mind_var = mind.mean(dim=1, keepdim=True)
    mean_var = mind_var.mean()
    mind_var = torch.minimum(torch.maximum(mind_var, mean_var * 0.001), mean_var * 1000)
    mind = torch.exp(-mind / mind_var)
    return mind[:, list(_CPP_ORDER)]
