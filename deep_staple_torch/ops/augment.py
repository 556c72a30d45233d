"""Device-side augmentation of a training batch: noise, a random b-spline and
affine warp, pre-interpolation.

The counterpart of `deep_staple_tpu/ops/augment.py` for the augment orders
'reference' (interpolate x factor, then the joint trilinear / nearest warp,
`augment.py:642-675`) and 'fast-sep' (the separable warp at base
resolution, then interpolate, `:595-617`). The other orders ('fast' and the
packed '{fast,reference}-{bf16,int8,int6}') raise NotImplementedError.

Every random number of one augmentation is drawn in `draw_augment` from one
`torch.Generator`; what follows is deterministic given the draws
(`AugmentDraws`), so a test can hand both packages the same numbers: the
unit-normal noise and the warp's parts `(eff_theta, ctl)` of
`make_augment_parts` (`augment.py:176-197`). The two packages' generators
give different numbers from the same seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .grid_sample import affine_grid_3d
from .resample import interpolate_sample, resize_nd
from .sep_warp import sep_warp_apply, sep_warp_fields, unnormalize

ORDERS = ("reference", "fast-sep")
OTHER_ORDERS = (
    "reference-bf16", "reference-int8", "reference-int6",
    "fast", "fast-bf16", "fast-int8", "fast-int6",
)


class AugmentParams(NamedTuple):
    """Hyperparameters of `HybridIdLoader.augment` (`HybridIdLoader.py:482-487`)."""

    noise_strength: float = 0.05
    bspline_num_ctl_points: int = 6
    bspline_strength: float = 0.03
    bspline_probability: float = 0.95
    affine_strength: float = 0.2
    add_affine_translation: float = 0.0
    affine_probability: float = 0.45


class AugmentDraws(NamedTuple):
    """The random part of one augmentation.

    noise: (B, D, H, W) unit normal at base resolution; eff_theta: (B, 3, 4)
    effective affine (identity where the affine coin is off); ctl: (B, 3,
    n, n, n) smoothed, scaled b-spline control field, zero where the
    b-spline coin is off."""

    noise: torch.Tensor
    eff_theta: torch.Tensor
    ctl: torch.Tensor


def check_order(order: str):
    """Raise unless `order` is one of ORDERS; an order of a later slice raises
    NotImplementedError."""
    if order in OTHER_ORDERS:
        raise NotImplementedError(
            f"augment order {order!r} comes with a later slice of the port (slice 5, side "
            f"paths); this one runs {ORDERS}"
        )
    if order not in ORDERS:
        raise ValueError(f"unknown augment order {order!r}")


def smooth_ctl(ctl_normal, strength: float, strength_spatial):
    """Scale a unit-normal control field (B, 3, n, n, n) by the post-
    interpolation extents (D, H, W)[c] * strength (the reference's quirk,
    `torch_utils.py:196-209`) and smooth it with three stride-1 3x3x3
    average pools that count the zero padding (`augment.py:58-82`)."""
    sD, sH, sW = strength_spatial
    dim_strength = torch.tensor([sD, sH, sW], dtype=torch.float32, device=ctl_normal.device)
    ctl = ctl_normal * (dim_strength * strength).reshape(1, 3, 1, 1, 1)
    for _ in range(3):
        ctl = F.avg_pool3d(ctl, 3, stride=1, padding=1, count_include_pad=True)
    return ctl


def post_spatial(base_spatial, factor: float):
    return tuple(int(s * factor) for s in base_spatial)


def draw_augment(generator: torch.Generator, base_shape, params: AugmentParams = AugmentParams(),
                 pre_interpolation_factor: float = 1.5) -> AugmentDraws:
    """Every random number of one batch's augmentation, from `generator`, on
    its device. base_shape: (B, D, H, W) of the images before
    interpolation. The distributions are those of `make_augment_parts`
    (`augment.py:159-197`): per-sample coins, unit-normal control points
    scaled by the post-interpolation extents, a normal affine perturbation
    and a random translation direction."""
    dev = generator.device
    B = int(base_shape[0])
    n = params.bspline_num_ctl_points

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    noise = normal(*base_shape)
    do_bspline = (uniform(B) < params.bspline_probability).float()
    do_affine = (uniform(B) < params.affine_probability).float()
    ctl = smooth_ctl(normal(B, 3, n, n, n), params.bspline_strength,
                     post_spatial(base_shape[1:], pre_interpolation_factor))
    eye = torch.eye(3, 4, device=dev).expand(B, 3, 4)
    theta = eye + params.affine_strength * normal(B, 3, 4)
    angles = uniform(B, 2) * 2 * math.pi
    t_ang, phi = angles[:, 0], angles[:, 1]
    offset = torch.stack(
        [torch.cos(phi) * torch.sin(t_ang), torch.sin(phi) * torch.sin(t_ang), torch.cos(t_ang)],
        dim=-1,
    )
    theta = torch.cat([theta[:, :, :3], (params.add_affine_translation * offset)[..., None]], dim=-1)
    eff_theta = eye + do_affine[:, None, None] * (theta - eye)
    return AugmentDraws(noise, eff_theta, ctl * do_bspline.reshape(B, 1, 1, 1, 1))


def bspline_field_from_ctl(ctl, spatial):
    """The control field's trilinear interpolant on the full lattice:
    (B, 3, n, n, n) -> (B, D, H, W, 3)."""
    return resize_nd(ctl, tuple(spatial), mode="linear", align_corners=True).permute(0, 2, 3, 4, 1)


def make_augment_grid(draws: AugmentDraws, spatial):
    """The composed warp grid (B, D, H, W, 3): affine grid plus b-spline
    field (`augment.py:149-156`)."""
    return affine_grid_3d(draws.eff_theta, spatial) + bspline_field_from_ctl(draws.ctl, spatial)


def _corner_coords(vol, grid):
    """Clamped voxel coordinates of the grid, split into base corners and
    weights, flattened to (B, P) (`augment.py:204-229`, pair_x=False)."""
    B, D, H, W = vol.shape
    P = grid[..., 0].numel() // B
    x = unnormalize(grid[..., 0], W).clamp(0, W - 1).reshape(B, P)
    y = unnormalize(grid[..., 1], H).clamp(0, H - 1).reshape(B, P)
    z = unnormalize(grid[..., 2], D).clamp(0, D - 1).reshape(B, P)
    x0, y0, z0 = (torch.floor(a).long() for a in (x, y, z))
    return x0, y0, z0, x - x0, y - y0, z - z0


def warp_trilinear_border(vol, grid):
    """Trilinear warp, padding_mode='border', align_corners=False
    (`augment.py:232-274`). vol: (B, D, H, W) float32; grid: (B, D', H', W',
    3) of (x, y, z)."""
    B, D, H, W = vol.shape
    x0, y0, z0, wx, wy, wz = _corner_coords(vol, grid)
    vf = vol.reshape(B, D * H * W)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                lin = ((z0 + dz).clamp(max=D - 1) * H + (y0 + dy).clamp(max=H - 1)) * W \
                    + (x0 + dx).clamp(max=W - 1)
                w = (wx if dx else 1 - wx) * (wy if dy else 1 - wy) * (wz if dz else 1 - wz)
                out = out + torch.gather(vf, 1, lin) * w
    return out.reshape((B,) + tuple(grid.shape[1:-1]))


def warp_nearest_zeros(vol, grid):
    """Nearest warp, padding_mode='zeros', align_corners=False
    (`augment.py:452-465`); rounds half to even."""
    B, D, H, W = vol.shape
    P = grid[..., 0].numel() // B
    x = torch.round(unnormalize(grid[..., 0], W)).long().reshape(B, P)
    y = torch.round(unnormalize(grid[..., 1], H)).long().reshape(B, P)
    z = torch.round(unnormalize(grid[..., 2], D)).long().reshape(B, P)
    valid = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (z >= 0) & (z < D)
    lin = (z.clamp(0, D - 1) * H + y.clamp(0, H - 1)) * W + x.clamp(0, W - 1)
    vals = torch.gather(vol.reshape(B, -1), 1, lin)
    return (vals * valid.to(vol.dtype)).reshape((B,) + tuple(grid.shape[1:-1]))


def augment_sample_pair(b_image, b_label, b_modified_label, draws: AugmentDraws,
                        params: AugmentParams = AugmentParams(),
                        pre_interpolation_factor: float = 1.5, order: str = "reference"):
    """Noise on the image, then one spatial warp applied to the image, the
    clean label and the modified label (`augment.py:518-675`).

    Inputs (B, D, H, W) at base resolution; returns (image, label,
    modified_label, grid) at floor(extent * factor). 'reference'
    interpolates first and warps at the upscaled resolution; 'fast-sep'
    warps at base resolution through the separable passes (binary labels
    only) and interpolates after.
    """
    check_order(order)
    b_image = b_image + params.noise_strength * draws.noise
    if order == "fast-sep":
        base_spatial = tuple(b_image.shape[1:])
        fields = sep_warp_fields(draws.eff_theta, draws.ctl, base_spatial)
        img, lbl_w, mod_w = sep_warp_apply(b_image.float(), b_label, b_modified_label, fields)
        warped = lbl_w + 2 * mod_w
        img, _ = interpolate_sample(img, None, pre_interpolation_factor, False)
        _, warped = interpolate_sample(None, warped, pre_interpolation_factor, False)
        # The grid slot holds the per-pass fields (x, y, z), not the joint
        # grid, as `assemble_grid_from_fields` returns in the JAX package.
        return img, warped % 2, warped // 2, torch.stack(fields, dim=-1)

    b_image, _ = interpolate_sample(b_image, None, pre_interpolation_factor, False)
    _, b_label = interpolate_sample(None, b_label, pre_interpolation_factor, False)
    _, b_modified_label = interpolate_sample(None, b_modified_label, pre_interpolation_factor, False)
    grid = make_augment_grid(draws, b_image.shape[1:])
    b_image = warp_trilinear_border(b_image.float(), grid)
    # One nearest gather for both labels: label + 256 * modified.
    packed = (b_label + 256 * b_modified_label).float()
    warped = warp_nearest_zeros(packed, grid).to(torch.int32)
    return b_image, warped % 256, warped // 256, grid
