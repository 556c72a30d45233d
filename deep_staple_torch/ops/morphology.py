"""Label morphology: `dilate_label_class`.

The counterpart of `deep_staple_tpu/ops/morphology.py:16-26` (after the
reference's `utils/torch_utils.py:36-63`): binary dilation of one class of
an integer label map by a cubic (square in 2D) window, written back over
the label. JAX takes a windowed max (`lax.reduce_window`); here a max-pool
of stride 1 over the class mask, padded with zeros (kernel_sz // 2 before,
the rest after, as JAX pads its window), which gives the same dilation,
since the mask is 0 or 1 and the test is > 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate_label_class(b_label, class_max_idx: int, class_dilate_idx: int, use_2d: bool,
                       kernel_sz: int = 3):
    """b_label: (B, *spatial) integer labels -> the labels with
    `class_dilate_idx` dilated by a kernel_sz^N window (N = 2 or 3)."""
    if kernel_sz < 2:
        return b_label
    ndim = 2 if use_2d else 3
    mask = (b_label == class_dilate_idx).float()[:, None]
    lo = kernel_sz // 2
    mask = F.pad(mask, (lo, kernel_sz - 1 - lo) * ndim)
    pool = F.max_pool2d if use_2d else F.max_pool3d
    dilated = pool(mask, kernel_sz, stride=1)[:, 0]
    return torch.where(dilated > 0, torch.full_like(b_label, class_dilate_idx), b_label)
