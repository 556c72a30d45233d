"""CrossMoDa volume preparation (the port's copy of the part serving needs).

`_prep_volume` is `deep_staple_tpu/data/crossmoda.py:53-72`: resample to the
canonical size (nearest for labels, linear align_corners=False for images),
symmetric zero-pad, crop W, z-normalise. The dataset loader comes with the
training slice.
"""

from __future__ import annotations

import numpy as np

from .np_ops import pad_to_size_np, resize_nd_np


def _prep_volume(vol, size, resample, crop_3d_w_dim_range, is_label, normalize=False):
    vol = np.asarray(vol)
    if is_label:
        if resample:
            vol = resize_nd_np(vol, size, mode="nearest")
        if vol.shape != tuple(size):
            vol = pad_to_size_np(vol, size)
        if crop_3d_w_dim_range:
            vol = vol[..., crop_3d_w_dim_range[0] : crop_3d_w_dim_range[1]]
        vol = np.where(vol == 2, 0, vol)  # drop cochlea class (reference :199-200)
        return vol.astype(np.int32)
    if resample:
        vol = resize_nd_np(vol.astype(np.float32), size, mode="linear", align_corners=False)
    if vol.shape != tuple(size):
        vol = pad_to_size_np(vol, size)
    if crop_3d_w_dim_range:
        vol = vol[..., crop_3d_w_dim_range[0] : crop_3d_w_dim_range[1]]
    if normalize:
        vol = (vol - vol.mean()) / vol.std()
    return vol.astype(np.float32)
