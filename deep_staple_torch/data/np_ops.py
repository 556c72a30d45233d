"""Host-side numpy resize and pad with PyTorch `F.interpolate` coordinate
semantics, for the ingest and write-out paths.

The port's own copy of `deep_staple_tpu/data/np_ops.py`; tested equal to it.
"""

from __future__ import annotations

import numpy as np


def _axis_linear(x, axis, out_size, align_corners):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = dst * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = np.maximum((dst + 0.5) * in_size / out_size - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (src - i0).astype(x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w.reshape(shape)
    a = np.take(x, i0, axis=axis)
    b = np.take(x, i1, axis=axis)
    return a * (1 - w) + b * w


def _axis_nearest(x, axis, out_size):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip(np.floor(dst * in_size / out_size).astype(np.int64), 0, in_size - 1)
    return np.take(x, src, axis=axis)


def resize_nd_np(x, out_spatial, mode="linear", align_corners=False):
    """Resize the trailing ``len(out_spatial)`` axes: 'linear' or 'nearest'."""
    n = len(out_spatial)
    for k in range(n):
        axis = x.ndim - n + k
        if mode == "nearest":
            x = _axis_nearest(x, axis, int(out_spatial[k]))
        elif mode == "linear":
            x = _axis_linear(x, axis, int(out_spatial[k]), align_corners)
        else:
            raise ValueError(mode)
    return x


def pad_to_size_np(x, size):
    """Symmetric zero-pad trailing 3 axes to `size` (CrossmodaHybridIdLoader.py:191-194)."""
    pads = [(0, 0)] * (x.ndim - 3)
    for k in range(3):
        dif = size[k] - x.shape[x.ndim - 3 + k]
        lo = dif // 2
        pads.append((max(lo, 0), max(dif - lo, 0)))
    return np.pad(x, pads)
