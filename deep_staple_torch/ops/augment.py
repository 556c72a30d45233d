"""Device-side augmentation of a training batch: noise, a random b-spline and
affine warp, pre-interpolation.

The counterpart of `deep_staple_tpu/ops/augment.py`, all nine augment orders
and the 2D path:

  * 'reference' interpolates x factor, then warps at the upscaled resolution
    (`augment.py:642-675`): the image trilinear / border through eight
    element gathers, both labels nearest / zeros through one gather of
    label + 256 * modified;
  * 'fast' warps at base resolution with the b-spline strength of the
    upscaled size, then interpolates (`:592-640`);
  * '-bf16', '-int8', '-int6' pack the image's corners into one 32-bit word
    a voxel: both x-corners as bfloat16 halves (4 gathers), the 2x2 in-plane
    quad as int8 quanta on a per-sample absmax / 127 scale (2 gathers), or
    the quad as int6 quanta with the quad's 2-bit label codes in the same
    word (2 gathers for image and labels, binary labels only). The int6
    orders shrink the additive noise per sample so that noise and
    quantization together keep the configured variance (`:581-590`);
  * 'fast-sep' runs the separable warp (`ops/sep_warp.py`, K1 on the card);
  * in 2D every order takes the reference path with bilinear / nearest
    `grid_sample_2d` (`:648-656`).

The words are packed in int32, whose shifts wrap as uint32's do, and every
field is masked after an arithmetic shift; int8 and int6 fields are sign-
extended as `(b ^ 0x80) - 0x80` and `(b ^ 0x20) - 0x20`, a bfloat16 half is
widened by moving its 16 bits to the top of a float32.

Every random number of one augmentation is drawn in `draw_augment` from one
`torch.Generator`; what follows is deterministic given the draws
(`AugmentDraws`), so a test can hand both packages the same numbers: the
unit-normal noise and the warp's parts `(eff_theta, ctl)` of
`make_augment_parts` (`augment.py:176-197`; in 2D the same parts of
`make_augment_grid`, `:135-147`). The two packages' generators give
different numbers from the same seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .grid_sample import affine_grid_2d, affine_grid_3d, grid_sample_2d
from .resample import interpolate_sample, resize_nd
from .sep_warp import sep_warp_apply, sep_warp_fields, unnormalize

ORDERS = (
    "reference", "reference-bf16", "reference-int8", "reference-int6",
    "fast", "fast-bf16", "fast-int8", "fast-int6", "fast-sep",
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

    noise: (B, *spatial) unit normal at base resolution; eff_theta: the
    effective affine, (B, 3, 4) in 3D and (B, 2, 3) in 2D (identity where
    the affine coin is off); ctl: the smoothed, scaled b-spline control
    field, (B, 3, n, n, n) or (B, 2, n, n), zero where the b-spline coin is
    off."""

    noise: torch.Tensor
    eff_theta: torch.Tensor
    ctl: torch.Tensor


def check_order(order: str):
    """Raise ValueError unless `order` is one of ORDERS."""
    if order not in ORDERS:
        raise ValueError(f"unknown augment order {order!r}")


def smooth_ctl(ctl_normal, strength: float, strength_spatial):
    """Scale a unit-normal control field (B, nd, n, ...) by the post-
    interpolation extents strength_spatial[c] * strength (the reference's
    quirk, `torch_utils.py:196-209`) and smooth it with three stride-1
    average pools of width 3 that count the zero padding
    (`augment.py:58-82`, `:97-104`)."""
    nd = ctl_normal.dim() - 2
    dim_strength = torch.tensor(list(strength_spatial), dtype=torch.float32, device=ctl_normal.device)
    ctl = ctl_normal * (dim_strength * strength).reshape((1, nd) + (1,) * nd)
    pool = F.avg_pool3d if nd == 3 else F.avg_pool2d
    for _ in range(3):
        ctl = pool(ctl, 3, stride=1, padding=1, count_include_pad=True)
    return ctl


def post_spatial(base_spatial, factor: float):
    return tuple(int(s * factor) for s in base_spatial)


def draw_augment(generator: torch.Generator, base_shape, params: AugmentParams = AugmentParams(),
                 pre_interpolation_factor: float = 1.5,
                 noise_generator: torch.Generator | None = None) -> AugmentDraws:
    """Every random number of one batch's augmentation, from `generator`, on
    its device. base_shape: (B, D, H, W) of the images before interpolation,
    or (B, H, W) for the 2D model. The distributions are those of
    `make_augment_parts` (`augment.py:159-197`) and of the 2D branch of
    `make_augment_grid` (`:135-147`, whose b-spline strength has an extra
    x0.5): per-sample coins, unit-normal control points scaled by the
    post-interpolation extents, a normal affine perturbation and a random
    translation direction. `noise_generator`, when given, draws the image
    noise (the one draw of the batch's size) on its own device instead."""
    dev = generator.device
    B = int(base_shape[0])
    n = params.bspline_num_ctl_points
    nd = len(base_shape) - 1

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    if noise_generator is None:
        noise = normal(*base_shape)
    else:
        noise = torch.randn(tuple(base_shape), generator=noise_generator,
                            device=noise_generator.device)
    do_bspline = (uniform(B) < params.bspline_probability).float()
    do_affine = (uniform(B) < params.affine_probability).float()
    strength = params.bspline_strength * (0.5 if nd == 2 else 1.0)
    ctl = smooth_ctl(normal(B, nd, *(n,) * nd), strength,
                     post_spatial(base_shape[1:], pre_interpolation_factor))
    eye = torch.eye(nd, nd + 1, device=dev).expand(B, nd, nd + 1)
    theta = eye + params.affine_strength * normal(B, nd, nd + 1)
    if nd == 2:
        alpha = uniform(B) * 2 * math.pi
        offset = torch.stack([torch.cos(alpha), torch.sin(alpha)], dim=-1)
    else:
        angles = uniform(B, 2) * 2 * math.pi
        t_ang, phi = angles[:, 0], angles[:, 1]
        offset = torch.stack(
            [torch.cos(phi) * torch.sin(t_ang), torch.sin(phi) * torch.sin(t_ang),
             torch.cos(t_ang)],
            dim=-1,
        )
    theta = torch.cat([theta[:, :, :nd], (params.add_affine_translation * offset)[..., None]], dim=-1)
    eff_theta = eye + do_affine[:, None, None] * (theta - eye)
    return AugmentDraws(noise, eff_theta, ctl * do_bspline.reshape((B,) + (1,) * (nd + 1)))


def bspline_field_from_ctl(ctl, spatial):
    """The control field's (bi/tri)linear interpolant on the full lattice:
    (B, nd, n, ...) -> (B, *spatial, nd)."""
    return resize_nd(ctl, tuple(spatial), mode="linear", align_corners=True).movedim(1, -1)


def make_augment_grid(draws: AugmentDraws, spatial):
    """The composed warp grid (B, *spatial, nd): affine grid plus b-spline
    field (`augment.py:135-156`); 2D when the draws are."""
    affine = affine_grid_2d if draws.eff_theta.shape[1] == 2 else affine_grid_3d
    return affine(draws.eff_theta, spatial) + bspline_field_from_ctl(draws.ctl, spatial)


def _corner_coords(vol, grid, pair_x: bool = False, pair_y: bool = False):
    """Clamped voxel coordinates of the grid, split into base corners and
    weights, flattened to (B, P) (`augment.py:204-229`). pair_x clamps x0 to
    W-2 so that the (x0, x0+1) pair lies in one word (at x == W-1 the weight
    moves wholly onto the high corner); pair_y does the same for y0 and H."""
    B, D, H, W = vol.shape
    P = grid[..., 0].numel() // B
    x = unnormalize(grid[..., 0], W).clamp(0, W - 1).reshape(B, P)
    y = unnormalize(grid[..., 1], H).clamp(0, H - 1).reshape(B, P)
    z = unnormalize(grid[..., 2], D).clamp(0, D - 1).reshape(B, P)
    x0, y0, z0 = (torch.floor(a).long() for a in (x, y, z))
    if pair_x:
        x0 = x0.clamp(max=max(W - 2, 0))
    if pair_y:
        y0 = y0.clamp(max=max(H - 2, 0))
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


def _next_along(a, dim: int):
    """a shifted by one towards lower indices along `dim`, the last slice
    repeated (border padding)."""
    n = a.shape[dim]
    return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim=dim)


def _quad(a):
    """(a, a at x+1, a at y+1, a at x+1 and y+1) of a (B, D, H, W) volume."""
    ax = _next_along(a, 3)
    return a, ax, _next_along(a, 2), _next_along(ax, 2)


def _signed_field(word, shift: int, bits: int):
    """The `bits`-wide two's-complement field at `shift` of int32 words, as
    float32."""
    half = 1 << (bits - 1)
    b = (word >> shift) & ((1 << bits) - 1)
    return ((b ^ half) - half).float()


def _quantize(vol, levels: int):
    """Per-sample symmetric quantization: round(vol / scale) in [-levels,
    levels], scale = max(absmax / levels, 1e-12); -> (int32 quanta, scale (B,
    1))."""
    B = vol.shape[0]
    flat = vol.reshape(B, -1)
    scale = (flat.abs().amax(dim=1, keepdim=True) / float(levels)).clamp(min=1e-12)
    q = torch.round(flat / scale).clamp(-levels, levels)
    return q.reshape(vol.shape).to(torch.int32), scale


def warp_trilinear_border_bf16pack(vol, grid):
    """The trilinear / border warp with both x-corners as the bfloat16
    halves of one gathered word, 4 gathers (`augment.py:277-313`): the high
    half holds the voxel, the low half its x+1 neighbour. Values round
    through bfloat16."""
    B, D, H, W = vol.shape
    x0, y0, z0, wx, wy, wz = _corner_coords(vol, grid, pair_x=True)
    v16 = vol.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    pf = ((v16 << 16) | _next_along(v16, 3)).reshape(B, D * H * W)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            lin = ((z0 + dz).clamp(max=D - 1) * H + (y0 + dy).clamp(max=H - 1)) * W + x0
            word = torch.gather(pf, 1, lin)
            # A bfloat16's bits at the top of a float32 are its exact value.
            v0 = (word & -65536).view(torch.float32)
            v1 = (word << 16).view(torch.float32)
            v = v0 * (1 - wx) + v1 * wx
            out = out + v * ((wy if dy else 1 - wy) * (wz if dz else 1 - wz))
    return out.reshape((B,) + tuple(grid.shape[1:-1]))


def warp_trilinear_border_int8pack(vol, grid):
    """The trilinear / border warp with the 2x2 in-plane corner quad as four
    int8 quanta in one gathered word (bits 0-7 the voxel, 8-15 x+1, 16-23
    y+1, 24-31 both), 2 gathers (`augment.py:316-360`). The image is
    quantized per sample on an absmax / 127 scale."""
    B, D, H, W = vol.shape
    x0, y0, z0, wx, wy, wz = _corner_coords(vol, grid, pair_x=True, pair_y=True)
    q, scale = _quantize(vol, 127)
    q, qx, qy, qxy = _quad(q & 0xFF)
    pf = (q | (qx << 8) | (qy << 16) | (qxy << 24)).reshape(B, D * H * W)
    out = 0.0
    for dz in (0, 1):
        lin = ((z0 + dz).clamp(max=D - 1) * H + y0) * W + x0
        word = torch.gather(pf, 1, lin)
        v00, v10, v01, v11 = (_signed_field(word, s, 8) for s in (0, 8, 16, 24))
        v = (1 - wy) * ((1 - wx) * v00 + wx * v10) + wy * ((1 - wx) * v01 + wx * v11)
        out = out + v * (wz if dz else 1 - wz)
    return (out * scale).reshape((B,) + tuple(grid.shape[1:-1]))


def warp_fused_int6pack(vol, lbl, mod, grid):
    """Image and both binary labels through 2 gathers (`augment.py:363-449`):
    a word holds the 2x2 in-plane quad as int6 quanta (bits 0-23, absmax / 31
    per sample) and the same quad's 2-bit label codes label | modified << 1
    (bits 24-31). The labels take the nearest corner (rounding half to even,
    as `warp_nearest_zeros`) from the same words, zero where the unclamped
    rounded position lies outside. -> (image, label, modified label)."""
    B, D, H, W = vol.shape
    out_spatial = (B,) + tuple(grid.shape[1:-1])
    x0, y0, z0, wx, wy, wz = _corner_coords(vol, grid, pair_x=True, pair_y=True)
    q, scale = _quantize(vol, 31)
    q, qx, qy, qxy = _quad(q & 0x3F)
    c, cx, cy, cxy = _quad((lbl + 2 * mod).to(torch.int32))
    pf = (q | (qx << 6) | (qy << 12) | (qxy << 18)
          | (c << 24) | (cx << 26) | (cy << 28) | (cxy << 30)).reshape(B, D * H * W)

    P = x0.shape[1]
    u = [unnormalize(grid[..., k], n).reshape(B, P) for k, n in enumerate((W, H, D))]
    sel_x, sel_y, sel_z = (torch.round(a.clamp(0, n - 1)).long() - a0
                           for a, n, a0 in zip(u, (W, H, D), (x0, y0, z0)))
    lbl_shift = (24 + 2 * sel_x + 4 * sel_y).to(torch.int32)
    xu, yu, zu = (torch.round(a) for a in u)
    valid = (xu >= 0) & (xu < W) & (yu >= 0) & (yu < H) & (zu >= 0) & (zu < D)

    img = 0.0
    code = torch.zeros_like(lbl_shift)
    for dz in (0, 1):
        lin = ((z0 + dz).clamp(max=D - 1) * H + y0) * W + x0
        word = torch.gather(pf, 1, lin)
        v00, v10, v01, v11 = (_signed_field(word, s, 6) for s in (0, 6, 12, 18))
        v = (1 - wy) * ((1 - wx) * v00 + wx * v10) + wy * ((1 - wx) * v01 + wx * v11)
        img = img + v * (wz if dz else 1 - wz)
        code = torch.where(sel_z == dz, (word >> lbl_shift) & 0x3, code)
    code = code * valid
    return (img * scale).reshape(out_spatial), (code & 1).reshape(out_spatial), \
        (code >> 1).reshape(out_spatial)


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


# The image warp of each order whose labels take the packed nearest gather.
_IMAGE_WARPS = {
    "": warp_trilinear_border,
    "-bf16": warp_trilinear_border_bf16pack,
    "-int8": warp_trilinear_border_int8pack,
}


def _warp_3d(order, b_image, b_label, b_modified_label, grid):
    """Image, label and modified label through `grid` in the order's packing
    -> (image, packed labels, divisor): label = packed % divisor, modified =
    packed // divisor."""
    packing = order[order.index("-"):] if "-" in order else ""
    if packing == "-int6":
        img, lbl_w, mod_w = warp_fused_int6pack(b_image.float(), b_label, b_modified_label, grid)
        return img, lbl_w + 2 * mod_w, 2
    img = _IMAGE_WARPS[packing](b_image.float(), grid)
    # One nearest gather for both labels: label + 256 * modified.
    packed = (b_label + 256 * b_modified_label).float()
    return img, warp_nearest_zeros(packed, grid).to(torch.int32), 256


def int6_noise_strength(b_image, noise_strength: float):
    """The additive noise's per-sample strength (B, 1, 1, 1) under the int6
    orders: the quantizer's variance (absmax / 31)^2 / 12 comes out of the
    configured noise_strength^2, clamped at zero (`augment.py:581-590`)."""
    absmax = b_image.reshape(b_image.shape[0], -1).abs().amax(dim=1)
    var = noise_strength ** 2 - (absmax / 31.0) ** 2 / 12.0
    return var.clamp(min=0.0).sqrt().reshape((-1,) + (1,) * (b_image.dim() - 1))


def augment_sample_pair(b_image, b_label, b_modified_label, draws: AugmentDraws,
                        params: AugmentParams = AugmentParams(),
                        pre_interpolation_factor: float = 1.5, order: str = "reference",
                        use_2d: bool = False):
    """Noise on the image, then one spatial warp applied to the image, the
    clean label and the modified label (`augment.py:518-675`).

    Inputs (B, D, H, W), or (B, H, W) with `use_2d`, at base resolution;
    returns (image, label, modified_label, grid) at floor(extent * factor).
    The 'fast*' orders warp at base resolution and interpolate after
    ('fast-sep' through the separable passes, binary labels only); the
    'reference*' orders and every 2D call interpolate first and warp at the
    upscaled resolution.
    """
    check_order(order)
    noise_strength = params.noise_strength
    if order.endswith("-int6") and not use_2d:
        noise_strength = int6_noise_strength(b_image, params.noise_strength)
    b_image = b_image + noise_strength * draws.noise
    if order == "fast-sep" and not use_2d:
        base_spatial = tuple(b_image.shape[1:])
        fields = sep_warp_fields(draws.eff_theta, draws.ctl, base_spatial)
        img, lbl_w, mod_w = sep_warp_apply(b_image.float(), b_label, b_modified_label, fields)
        warped = lbl_w + 2 * mod_w
        img, _ = interpolate_sample(img, None, pre_interpolation_factor, False)
        _, warped = interpolate_sample(None, warped, pre_interpolation_factor, False)
        # The grid slot holds the per-pass fields (x, y, z), not the joint
        # grid, as `assemble_grid_from_fields` returns in the JAX package.
        return img, warped % 2, warped // 2, torch.stack(fields, dim=-1)
    if order.startswith("fast") and not use_2d:
        grid = make_augment_grid(draws, b_image.shape[1:])
        img, warped, divisor = _warp_3d(order, b_image, b_label, b_modified_label, grid)
        img, _ = interpolate_sample(img, None, pre_interpolation_factor, False)
        _, warped = interpolate_sample(None, warped, pre_interpolation_factor, False)
        return img, warped % divisor, warped // divisor, grid

    b_image, _ = interpolate_sample(b_image, None, pre_interpolation_factor, use_2d)
    _, b_label = interpolate_sample(None, b_label, pre_interpolation_factor, use_2d)
    _, b_modified_label = interpolate_sample(None, b_modified_label, pre_interpolation_factor, use_2d)
    grid = make_augment_grid(draws, b_image.shape[1:])
    if use_2d:
        b_image = grid_sample_2d(b_image[:, None].float(), grid, "bilinear", "border")[:, 0]
        both = torch.stack([b_label, b_modified_label], dim=1).float()
        warped = grid_sample_2d(both, grid, "nearest", "zeros").to(torch.int32)
        return b_image, warped[:, 0], warped[:, 1], grid
    img, warped, divisor = _warp_3d(order, b_image, b_label, b_modified_label, grid)
    return img, warped % divisor, warped // divisor, grid
