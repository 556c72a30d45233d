"""`affine_grid` with PyTorch semantics, for the augmentation warp.

The counterpart of `deep_staple_tpu/ops/grid_sample.py::affine_grid_3d`
(:127-155) at align_corners=False, the only setting the warp uses: grid
components are (x, y, z) with x along W, normalized to [-1, 1]; the product
with theta is written out elementwise, as the JAX version does, so both
compute the same float32 sums.
"""

from __future__ import annotations

import torch


def _base_coords(size: int, device):
    i = torch.arange(size, dtype=torch.float32, device=device)
    return (2.0 * i + 1.0) / size - 1.0


def affine_grid_3d(theta, spatial):
    """theta (B, 3, 4) -> grid (B, D, H, W, 3), as F.affine_grid for 5D with
    align_corners=False."""
    D, H, W = (int(s) for s in spatial)
    dev = theta.device
    gx = _base_coords(W, dev).reshape(1, 1, 1, W, 1)
    gy = _base_coords(H, dev).reshape(1, 1, H, 1, 1)
    gz = _base_coords(D, dev).reshape(1, D, 1, 1, 1)
    t = theta.float()[:, None, None, None]  # (B, 1, 1, 1, 3, 4)
    return gx * t[..., 0] + gy * t[..., 1] + gz * t[..., 2] + t[..., 3]
