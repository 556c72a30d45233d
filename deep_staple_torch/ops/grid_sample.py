"""`affine_grid` and `grid_sample` with PyTorch semantics, for the
augmentation warp and the registration toolbox.

The counterpart of `deep_staple_tpu/ops/grid_sample.py` (`grid_sample_3d`
:42-108, `affine_grid_3d` :136-155, `affine_grid_2d` :158-165,
`grid_sample_2d` :111-124): grid components are (x, y[, z]) with x along W,
normalized to [-1, 1]; the product with theta is written out elementwise, as
the JAX version does, so both compute the same float32 sums.

The samplers gather the corners of each output from the flattened volume,
weight and sum them in the order of the JAX version, and round half to even
in 'nearest'. This plain formulation, not `F.grid_sample`, because it is
JAX's arithmetic step for step (the value and its gradient with respect to
the grid then agree to float32 rounding, which `affine_register`'s Adam
loop needs to follow JAX's first steps), and because it runs off any
kernel of the port: JAX computes it outside any Pallas kernel too. Autograd
gives the gradient with respect to the grid through the corner weights, as
`jax.grad` does. `grid_sample_3d` takes both modes, both paddings and both
corner conventions; `grid_sample_2d` the two forms the 2D augmentation uses
(align_corners=False).
"""

from __future__ import annotations

import torch


def _base_coords(size: int, device, align_corners: bool = False):
    i = torch.arange(size, dtype=torch.float32, device=device)
    if align_corners:
        if size == 1:
            return torch.zeros(1, dtype=torch.float32, device=device)
        return -1.0 + 2.0 * i / (size - 1)
    return (2.0 * i + 1.0) / size - 1.0


def affine_grid_3d(theta, spatial, align_corners: bool = False):
    """theta (B, 3, 4) -> grid (B, D, H, W, 3), as F.affine_grid for 5D."""
    D, H, W = (int(s) for s in spatial)
    dev = theta.device
    gx = _base_coords(W, dev, align_corners).reshape(1, 1, 1, W, 1)
    gy = _base_coords(H, dev, align_corners).reshape(1, 1, H, 1, 1)
    gz = _base_coords(D, dev, align_corners).reshape(1, D, 1, 1, 1)
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


def _unnormalize(coord, size: int, align_corners: bool = False):
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _clip(c, hi: int):
    """c clipped to [0, hi] as `jnp.clip` (a maximum, then a minimum): a
    coordinate on a bound gets half its gradient, as in JAX; `clamp` would
    pass all of it. At the identity map of `affine_register` every border
    voxel lies on a bound. The bounds are filled on `c`'s device: a tensor
    made from a host value would wait there for the card's whole queue."""
    lo, top = (torch.full((), v, dtype=c.dtype, device=c.device) for v in (0.0, float(hi)))
    return torch.minimum(torch.maximum(c, lo), top)


def grid_sample_3d(inp, grid, mode: str = "bilinear", padding_mode: str = "zeros",
                   align_corners: bool = False):
    """Sample (B, C, D, H, W) at grid (B, Do, Ho, Wo, 3) of (x, y, z) ->
    (B, C, Do, Ho, Wo): 'bilinear' (trilinear) or 'nearest', 'zeros' or
    'border' padding."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"Unsupported mode '{mode}'")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"Unsupported padding_mode '{padding_mode}'")
    B, C, D, H, W = inp.shape
    out_shape = (B, C) + tuple(grid.shape[1:-1])
    flat = inp.reshape(B, C, D * H * W)
    x = _unnormalize(grid[..., 0], W, align_corners)
    y = _unnormalize(grid[..., 1], H, align_corners)
    z = _unnormalize(grid[..., 2], D, align_corners)
    if padding_mode == "border":
        x, y, z = _clip(x, W - 1), _clip(y, H - 1), _clip(z, D - 1)

    def corner(iz, iy, ix):
        lin = ((iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W + ix.clamp(0, W - 1)).reshape(B, 1, -1)
        out = torch.gather(flat, 2, lin.expand(B, C, lin.shape[-1])).reshape(out_shape)
        if padding_mode == "zeros":
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0) & (iz < D)
            out = out * valid[:, None].to(out.dtype)
        return out

    if mode == "nearest":
        return corner(torch.round(z).long(), torch.round(y).long(), torch.round(x).long())
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    wx, wy, wz = (x - x0).to(inp.dtype), (y - y0).to(inp.dtype), (z - z0).to(inp.dtype)
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = (wx if dx else 1 - wx) * (wy if dy else 1 - wy) * (wz if dz else 1 - wz)
                out = out + corner(z0 + dz, y0 + dy, x0 + dx) * w[:, None]
    return out


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
