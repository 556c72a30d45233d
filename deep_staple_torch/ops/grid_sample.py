"""`affine_grid` and 2D `grid_sample` with PyTorch semantics, for the
augmentation warp.

The counterpart of `deep_staple_tpu/ops/grid_sample.py` (`affine_grid_3d`
:136-155, `affine_grid_2d` :158-165, `grid_sample_2d` :111-124) at
align_corners=False, the only setting the warp uses: grid components are (x,
y[, z]) with x along W, normalized to [-1, 1]; the product with theta is
written out elementwise, as the JAX version does, so both compute the same
float32 sums. `grid_sample_2d` gathers the corners of each output from the
flattened image, weights and sums them in the order of the JAX version (its
3D sampler on a depth-1 volume), and rounds half to even in 'nearest'.
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


def affine_grid_2d(theta, spatial):
    """theta (B, 2, 3) -> grid (B, H, W, 2), as F.affine_grid for 4D with
    align_corners=False."""
    H, W = (int(s) for s in spatial)
    dev = theta.device
    gx = _base_coords(W, dev).reshape(1, 1, W, 1)
    gy = _base_coords(H, dev).reshape(1, H, 1, 1)
    t = theta.float()[:, None, None]  # (B, 1, 1, 2, 3)
    return gx * t[..., 0] + gy * t[..., 1] + t[..., 2]


def _unnormalize(coord, size: int):
    return ((coord + 1.0) * size - 1.0) / 2.0


def grid_sample_2d(inp, grid, mode: str = "bilinear", padding_mode: str = "border"):
    """Sample (B, C, H, W) at grid (B, Ho, Wo, 2) of (x, y), align_corners=
    False, in the two forms the augmentation uses: 'bilinear' with 'border'
    padding (the image) and 'nearest' with 'zeros' padding (labels)."""
    if (mode, padding_mode) not in (("bilinear", "border"), ("nearest", "zeros")):
        raise ValueError(f"Unsupported mode / padding_mode '{mode}' / '{padding_mode}'")
    B, C, H, W = inp.shape
    out_shape = (B, C) + tuple(grid.shape[1:3])
    flat = inp.reshape(B, C, H * W)
    x = _unnormalize(grid[..., 0], W)
    y = _unnormalize(grid[..., 1], H)

    def corner(ix, iy):
        lin = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, 1, -1)
        return torch.gather(flat, 2, lin.expand(B, C, lin.shape[-1])).reshape(out_shape)

    if mode == "nearest":
        ix, iy = torch.round(x).long(), torch.round(y).long()
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        return corner(ix, iy) * valid[:, None].to(inp.dtype)
    x, y = x.clamp(0, W - 1), y.clamp(0, H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0).to(inp.dtype), (y - y0).to(inp.dtype)
    x0, y0 = x0.long(), y0.long()
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            w = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            out = out + corner(x0 + dx, y0 + dy) * w[:, None]
    return out
