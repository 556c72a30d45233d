"""The training augmentation in plain PyTorch: the random draws of a step,
the 'reference' order's warp through `F.grid_sample`, and the separable
three-pass warp of the 'fast-sep' order.

The draws follow the training loop's published protocol: a CPU generator
seeded with the run's seed (fold 0) seeds one generator on the model's
device; each step draws the image noise (the batch's shape) on the device,
then on the CPU the b-spline and affine coins, the unit-normal control
points, the affine perturbation and two angles; the ASPP's dropout masks
come from the device generator after the noise, one a train-mode forward.

The separable warp is an algorithm of its own (a partial inversion of the
warp on a coarse lattice, then three 1D resampling passes on int12 quanta
that carry the labels' 2-bit codes); this is a frozen copy of its plain
statement, which the benchmark keeps so that a change to the program's
version cannot move the yardstick.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

NOISE_STRENGTH = 0.05
BSPLINE_CTL = 6
BSPLINE_STRENGTH = 0.03
BSPLINE_P = 0.95
AFFINE_STRENGTH = 0.2
AFFINE_P = 0.45
AFFINE_GUARD = 0.05
SEP_ITERS = 4


class Draws(NamedTuple):
    noise: torch.Tensor  # (B, D, H, W) on the device
    eff_theta: torch.Tensor  # (B, 3, 4)
    ctl: torch.Tensor  # (B, 3, n, n, n)


def generators(seed: int, device):
    """-> (the CPU generator, the device generator) of a training run."""
    gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=device)
    dev_gen.manual_seed(int(torch.randint(2**62, (1,), generator=gen)))
    return gen, dev_gen


def draw(gen, dev_gen, base_shape, factor: float, device) -> Draws:
    B = base_shape[0]
    noise = torch.randn(tuple(base_shape), generator=dev_gen, device=dev_gen.device)
    do_bspline = (torch.rand(B, generator=gen) < BSPLINE_P).float()
    do_affine = (torch.rand(B, generator=gen) < AFFINE_P).float()
    ctl = torch.randn((B, 3, BSPLINE_CTL, BSPLINE_CTL, BSPLINE_CTL), generator=gen)
    post = torch.tensor([float(int(s * factor)) for s in base_shape[1:]])
    ctl = ctl * (post * BSPLINE_STRENGTH).reshape(1, 3, 1, 1, 1)
    for _ in range(3):
        ctl = F.avg_pool3d(ctl, 3, stride=1, padding=1, count_include_pad=True)
    eye = torch.eye(3, 4).expand(B, 3, 4)
    theta = eye + AFFINE_STRENGTH * torch.randn((B, 3, 4), generator=gen)
    torch.rand((B, 2), generator=gen)  # the translation's direction; its strength is 0
    theta = torch.cat([theta[:, :, :3], torch.zeros(B, 3, 1)], dim=-1)
    eff_theta = eye + do_affine[:, None, None] * (theta - eye)
    ctl = ctl * do_bspline.reshape(B, 1, 1, 1, 1)
    return Draws(noise, eff_theta.to(device), ctl.to(device))


def dropout_keep(dev_gen, shape, rate: float):
    return torch.rand(tuple(shape), generator=dev_gen, device=dev_gen.device) >= rate


def up_image(img, factor: float):
    """Trilinear (align_corners) to floor(n * factor) a side."""
    size = [int(math.floor(n * factor)) for n in img.shape[1:]]
    return F.interpolate(img[:, None].float(), size=size, mode="trilinear",
                         align_corners=True)[:, 0]


def up_labels(lbl, factor: float):
    """Nearest (source floor(dst / factor)) to floor(n * factor) on each of
    the last three axes."""
    for axis in range(lbl.dim() - 3, lbl.dim()):
        n_out = int(math.floor(lbl.shape[axis] * factor))
        src = torch.floor(torch.arange(n_out, dtype=torch.float32, device=lbl.device)
                          * (1.0 / factor)).long().clamp_(0, lbl.shape[axis] - 1)
        lbl = lbl.index_select(axis, src)
    return lbl


def warp_reference(img, lbl, mod, d: Draws, factor: float):
    """'reference': noise, upsample, then the affine + b-spline warp at the
    upsampled size (image trilinear with border padding, labels nearest with
    zeros), align_corners=False."""
    img = up_image(img + NOISE_STRENGTH * d.noise, factor)
    lab = up_labels(torch.stack([lbl, mod], dim=1), factor)
    B = img.shape[0]
    size = tuple(img.shape[1:])
    grid = F.affine_grid(d.eff_theta.float(), (B, 1, *size), align_corners=False)
    grid = grid + F.interpolate(d.ctl.float(), size=size, mode="trilinear",
                                align_corners=True).permute(0, 2, 3, 4, 1)
    img = F.grid_sample(img[:, None], grid, mode="bilinear", padding_mode="border",
                        align_corners=False)[:, 0]
    lab = F.grid_sample(lab.float(), grid, mode="nearest",
                        padding_mode="zeros", align_corners=False).round().long()
    return img, lab[:, 0], lab[:, 1]


# --- the separable warp ---------------------------------------------------


def _unnormalize(coord, size):
    return ((coord + 1.0) * size - 1.0) / 2.0


def _norm_at(vox, size):
    return (2.0 * vox + 1.0) / size - 1.0


def _guard(x):
    s = torch.where(x < 0, -1.0, 1.0)
    return torch.where(x.abs() < AFFINE_GUARD, s * AFFINE_GUARD, x)


def _lerp1(f, t):
    n = f.shape[1]
    t = t.clamp(0.0, n - 1.0)
    i0 = torch.floor(t).long().clamp_(0, max(n - 2, 0))
    w = t - i0
    return torch.gather(f, 1, i0) * (1 - w) + torch.gather(f, 1, (i0 + 1).clamp_(max=n - 1)) * w


def _lerp2(f, tz, ty):
    B, Dc, Hc, Wc = f.shape
    tz, ty = tz.clamp(0.0, Dc - 1.0), ty.clamp(0.0, Hc - 1.0)
    iz = torch.floor(tz).long().clamp_(0, max(Dc - 2, 0))
    iy = torch.floor(ty).long().clamp_(0, max(Hc - 2, 0))
    wz, wy = tz - iz, ty - iy
    ff = f.reshape(B, Dc * Hc, Wc)

    def tap(dz, dy):
        lin = (iz + dz).clamp_(max=Dc - 1) * Hc + (iy + dy).clamp_(max=Hc - 1)
        return torch.gather(ff, 1, lin.reshape(B, -1, Wc)).reshape(tz.shape)

    return (tap(0, 0) * (1 - wz) * (1 - wy) + tap(0, 1) * (1 - wz) * wy
            + tap(1, 0) * wz * (1 - wy) + tap(1, 1) * wz * wy)


def sep_fields(eff_theta, ctl, spatial):
    """The three passes' coordinate fields (normalised, each (B, D, H, W))."""
    D, H, W = (int(s) for s in spatial)
    B, dev = eff_theta.shape[0], eff_theta.device
    Dc, Hc, Wc = (max(5, s // 8 + 1) for s in (D, H, W))
    th = eff_theta.float().reshape(B, 3, 4, 1, 1, 1)

    def m(i, j):
        return th[:, i, j]

    sc = F.interpolate(ctl.float(), size=(Dc, Hc, Wc), mode="trilinear",
                       align_corners=True).permute(0, 2, 3, 4, 1)

    def lin(n, c):
        return torch.linspace(0.0, n - 1.0, c, dtype=torch.float32, device=dev)

    ucz = _norm_at(lin(D, Dc), D).reshape(1, Dc, 1, 1)
    ucy = _norm_at(lin(H, Hc), H).reshape(1, 1, Hc, 1)
    ucx = _norm_at(lin(W, Wc), W).reshape(1, 1, 1, Wc)

    def cidx(vox, size, csize):
        return vox * ((csize - 1.0) / max(size - 1.0, 1.0))

    t22 = _guard(m(2, 2))
    rhs = ucz - m(2, 0) * ucx - m(2, 1) * ucy - m(2, 3)
    w = rhs / t22
    for _ in range(SEP_ITERS):
        w = (rhs - _lerp1(sc[..., 2], cidx(_unnormalize(w, D), D, Dc))) / t22
    zi = cidx(_unnormalize(w, D), D, Dc)
    fy_c = m(1, 0) * ucx + m(1, 1) * ucy + m(1, 2) * w + m(1, 3) + _lerp1(sc[..., 1], zi)

    det = _guard(m(2, 2) * m(1, 1) - m(2, 1) * m(1, 2))
    r1a = ucz - m(2, 0) * ucx - m(2, 3)
    r2a = ucy - m(1, 0) * ucx - m(1, 3)
    w2 = (m(1, 1) * r1a - m(2, 1) * r2a) / det
    v2 = (-m(1, 2) * r1a + m(2, 2) * r2a) / det
    for _ in range(SEP_ITERS):
        zi2, yi2 = cidx(_unnormalize(w2, D), D, Dc), cidx(_unnormalize(v2, H), H, Hc)
        r1 = r1a - _lerp2(sc[..., 2], zi2, yi2)
        r2 = r2a - _lerp2(sc[..., 1], zi2, yi2)
        w2 = (m(1, 1) * r1 - m(2, 1) * r2) / det
        v2 = (-m(1, 2) * r1 + m(2, 2) * r2) / det
    zi2, yi2 = cidx(_unnormalize(w2, D), D, Dc), cidx(_unnormalize(v2, H), H, Hc)
    fx_c = m(0, 0) * ucx + m(0, 1) * v2 + m(0, 2) * w2 + m(0, 3) + _lerp2(sc[..., 0], zi2, yi2)
    up = F.interpolate(torch.stack([fx_c, fy_c], dim=1), size=(D, H, W), mode="trilinear",
                       align_corners=True)

    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=dev)

    uz = _norm_at(ar(D), D).reshape(1, D, 1, 1)
    uy = _norm_at(ar(H), H).reshape(1, 1, H, 1)
    ux = _norm_at(ar(W), W).reshape(1, 1, 1, W)
    sz = F.interpolate(ctl[:, 2:3].float(), size=(D, H, W), mode="trilinear",
                       align_corners=True)[:, 0]
    fz = m(2, 0) * ux + m(2, 1) * uy + m(2, 2) * uz + m(2, 3) + sz
    return up[:, 0], up[:, 1], fz


def _encode(x, code):
    return torch.round(x).clamp_(-2047, 2047).to(torch.int16) * 4 + code.to(torch.int16)


def _pass(t, cc, dim):
    L = t.shape[dim]
    c = cc.clamp(0.0, L - 1.0)
    i0 = torch.floor(c).to(torch.int32).clamp_(0, max(L - 2, 0))
    w = c - i0.float()
    g0 = torch.gather(t, dim, i0.long())
    g1 = torch.gather(t, dim, (i0.long() + 1).clamp_(max=L - 1))
    img = (g0 >> 2).float() * (1.0 - w) + (g1 >> 2).float() * w
    code = torch.where(torch.round(cc) >= (i0 + 1).float(), g1 & 3, g0 & 3)
    return img, torch.where((cc >= -0.5) & (cc < L - 0.5), code, 0)


def warp_fast_sep(img, lbl, mod, d: Draws, factor: float):
    """'fast-sep': noise, the separable warp at the base size (image and
    binary labels as int12 quanta with 2-bit codes, along W, then H, then
    D), then the upsampling."""
    img = (img + NOISE_STRENGTH * d.noise).float()
    B, D, H, W = img.shape
    fx, fy, fz = sep_fields(d.eff_theta, d.ctl, (D, H, W))
    amax = img.reshape(B, -1).abs().amax(dim=1)
    scale = (amax / 2047.0).clamp(min=1e-12).reshape(B, 1, 1, 1)
    t = _encode(img / scale, (lbl + 2 * mod) & 3)
    t = _encode(*_pass(t, _unnormalize(fx, W), 3))
    t = _encode(*_pass(t, _unnormalize(fy, H), 2))
    x, code = _pass(t, _unnormalize(fz, D), 1)
    code = up_labels(code.long(), factor)
    return up_image(x * scale, factor), code & 1, code >> 1
