"""The separable (3-pass scanline) augmentation warp, with K1 as a Hopper kernel.

The counterpart of `deep_staple_tpu/ops/sep_warp.py` without a mesh: the
augmentation map is split into three 1D resampling passes (x, then y, then
z), whose coordinate fields come from a partial inversion of the warp on a
coarse lattice (`sep_warp_fields`, :140-242). Each pass packs, per lane, the
lane pair (i, i+1) of the image as two int12 quanta plus the pair's 2-bit
label codes (label | modified << 1) into one 32-bit word (`_pack_pass`,
:274-280), and one gather per element fetches them (`sep_warp_pass`, K1).
The JAX module's docstring explains the decomposition and its accuracy.

  * `sep_warp_pass` is the wrapper of K1 (`csrc/sep_warp_pass.cu`): a CPU
    tensor takes `sep_warp_pass_plain` (the counterpart of `_sep_pass_xla`,
    :317-320); a CUDA tensor launches the kernel or raises;
    `sep_warp_pass.launches` counts the launches.
  * Words are int32 tensors: every bit operation here works on int32, and
    the packed values use bits 0..27 only.
  * `torch.round` rounds half to even, as `jnp.round` does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from . import cuda_build
from .resample import resize_nd

_AFFINE_GUARD = 0.05  # |denominator| floor for the per-sample linear solves
_ITERS = 4  # fixed-point iterations of the b-spline inversions


class SepWarpFields(NamedTuple):
    """Per-pass coordinate fields, normalized to [-1, 1] (torch grid
    convention), each (B, D, H, W), indexed by the pass's output lattice."""

    fx: torch.Tensor
    fy: torch.Tensor
    fz: torch.Tensor


def unnormalize(coord, size: int):
    """align_corners=False: normalized coordinate -> voxel position."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _norm_coords_at(vox, size):
    return (2.0 * vox + 1.0) / size - 1.0


def _guard(x):
    s = torch.where(x < 0, -1.0, 1.0)
    return torch.where(x.abs() < _AFFINE_GUARD, s * _AFFINE_GUARD, x)


def _interp_axis1(f, t):
    """Lerp f (B, N, ...) along axis 1 at continuous indices t (B, M, ...)
    whose other axes match f's."""
    n = f.shape[1]
    t = t.clamp(0.0, n - 1.0)
    i0 = torch.floor(t).long().clamp_(0, max(n - 2, 0))
    w = t - i0
    v0 = torch.gather(f, 1, i0)
    v1 = torch.gather(f, 1, (i0 + 1).clamp_(max=n - 1))
    return v0 * (1 - w) + v1 * w


def _interp_zy(f, tz, ty):
    """Bilerp f (B, Dc, Hc, Wc) over its (z, y) axes at continuous indices
    tz, ty (B, M1, M2, Wc); the x axis stays on the lattice."""
    B, Dc, Hc, Wc = f.shape
    tz = tz.clamp(0.0, Dc - 1.0)
    ty = ty.clamp(0.0, Hc - 1.0)
    iz = torch.floor(tz).long().clamp_(0, max(Dc - 2, 0))
    iy = torch.floor(ty).long().clamp_(0, max(Hc - 2, 0))
    wz = tz - iz
    wy = ty - iy
    ff = f.reshape(B, Dc * Hc, Wc)
    out_shape = tz.shape

    def tap(dz, dy):
        lin = (iz + dz).clamp_(max=Dc - 1) * Hc + (iy + dy).clamp_(max=Hc - 1)
        return torch.gather(ff, 1, lin.reshape(B, -1, Wc)).reshape(out_shape)

    return (
        tap(0, 0) * (1 - wz) * (1 - wy)
        + tap(0, 1) * (1 - wz) * wy
        + tap(1, 0) * wz * (1 - wy)
        + tap(1, 1) * wz * wy
    )


def sep_warp_fields(eff_theta, ctl, spatial: Sequence[int]):
    """The three pass fields from the warp's parts (`sep_warp.py:140-242`, at
    its default solve lattice and iteration count).

    eff_theta: (B, 3, 4) effective affine, coin folded in; ctl: (B, 3, n, n,
    n) smoothed, scaled b-spline control field, zero where its coin is off;
    spatial: (D, H, W) of the warp lattice. The inversions are solved on a
    coarse lattice of about 1/8 of the resolution (at least 5 a side).
    """
    D, H, W = (int(s) for s in spatial)
    B = eff_theta.shape[0]
    dev = eff_theta.device
    Dc, Hc, Wc = (max(5, s // 8 + 1) for s in (D, H, W))
    th = eff_theta.float().reshape(B, 3, 4, 1, 1, 1)

    def m(i, j):
        return th[:, i, j]

    sc = resize_nd(ctl.float(), (Dc, Hc, Wc), mode="linear", align_corners=True).permute(0, 2, 3, 4, 1)

    def lin(n, c):
        return torch.linspace(0.0, n - 1.0, c, dtype=torch.float32, device=dev)

    ucz = _norm_coords_at(lin(D, Dc), D).reshape(1, Dc, 1, 1)
    ucy = _norm_coords_at(lin(H, Hc), H).reshape(1, 1, Hc, 1)
    ucx = _norm_coords_at(lin(W, Wc), W).reshape(1, 1, 1, Wc)

    def vox2cidx(vox, size, csize):
        return vox * ((csize - 1.0) / max(size - 1.0, 1.0))

    # z-inversion for fy: solve Z(z*, y, x) = zeta on the coarse lattice.
    t22 = _guard(m(2, 2))
    rhs_z = ucz - m(2, 0) * ucx - m(2, 1) * ucy - m(2, 3)
    w = rhs_z / t22
    for _ in range(_ITERS):
        zi = vox2cidx(unnormalize(w, D), D, Dc)
        w = (rhs_z - _interp_axis1(sc[..., 2], zi)) / t22
    zi = vox2cidx(unnormalize(w, D), D, Dc)
    fy_c = m(1, 0) * ucx + m(1, 1) * ucy + m(1, 2) * w + m(1, 3) + _interp_axis1(sc[..., 1], zi)

    # (z, y)-inversion for fx: solve Z = zeta, Y = upsilon jointly.
    det = _guard(m(2, 2) * m(1, 1) - m(2, 1) * m(1, 2))
    r1a = ucz - m(2, 0) * ucx - m(2, 3)
    r2a = ucy - m(1, 0) * ucx - m(1, 3)
    w2 = (m(1, 1) * r1a - m(2, 1) * r2a) / det
    v2 = (-m(1, 2) * r1a + m(2, 2) * r2a) / det
    for _ in range(_ITERS):
        zi2 = vox2cidx(unnormalize(w2, D), D, Dc)
        yi2 = vox2cidx(unnormalize(v2, H), H, Hc)
        r1 = r1a - _interp_zy(sc[..., 2], zi2, yi2)
        r2 = r2a - _interp_zy(sc[..., 1], zi2, yi2)
        w2 = (m(1, 1) * r1 - m(2, 1) * r2) / det
        v2 = (-m(1, 2) * r1 + m(2, 2) * r2) / det
    zi2 = vox2cidx(unnormalize(w2, D), D, Dc)
    yi2 = vox2cidx(unnormalize(v2, H), H, Hc)
    sxv = _interp_zy(sc[..., 0], zi2, yi2)
    fx_c = m(0, 0) * ucx + m(0, 1) * v2 + m(0, 2) * w2 + m(0, 3) + sxv

    up = resize_nd(torch.stack([fx_c, fy_c], dim=1), (D, H, W), mode="linear", align_corners=True)

    # fz is exact: the joint map's z component on the full lattice.
    def ar(n):
        return torch.arange(n, dtype=torch.float32, device=dev)

    uz = _norm_coords_at(ar(D), D).reshape(1, D, 1, 1)
    uy = _norm_coords_at(ar(H), H).reshape(1, 1, H, 1)
    ux = _norm_coords_at(ar(W), W).reshape(1, 1, 1, W)
    sz_full = resize_nd(ctl[:, 2:3].float(), (D, H, W), mode="linear", align_corners=True)[:, 0]
    fz = m(2, 0) * ux + m(2, 1) * uy + m(2, 2) * uz + m(2, 3) + sz_full
    return SepWarpFields(fx=up[:, 0], fy=up[:, 1], fz=fz)


def pack_pass(img, code, scale):
    """Pack each lane's (i, i+1) pair: the image as two int12 quanta (bits
    0..23, border-replicated at the last lane) and the label codes (2 bits
    each, bits 24..27), as int32."""
    q = torch.round(img / scale).clamp_(-2047, 2047).to(torch.int32) & 0xFFF
    qn = torch.cat([q[..., 1:], q[..., -1:]], dim=-1)
    code = code.to(torch.int32)
    cn = torch.cat([code[..., 1:], code[..., -1:]], dim=-1)
    return q | (qn << 12) | (code << 24) | (cn << 26)


def sep_warp_pass_plain(word, cc, L: int):
    """One pass in plain PyTorch: word (..., L) int32, cc (..., L) float32
    voxel coordinates -> (img float32, code int32)."""
    cimg = cc.clamp(0.0, L - 1.0)
    i0 = torch.floor(cimg).to(torch.int32).clamp_(0, max(L - 2, 0))
    w = cimg - i0.float()
    g = torch.gather(word, -1, i0.long())
    v0 = (((g & 0xFFF) ^ 0x800) - 0x800).float()
    v1 = ((((g >> 12) & 0xFFF) ^ 0x800) - 0x800).float()
    img = v0 * (1.0 - w) + v1 * w
    sel = (torch.round(cc) >= (i0 + 1).float())  # clamp(round(cc) - i0, 0, 1) == 1
    code = torch.where(sel, (g >> 26) & 0x3, (g >> 24) & 0x3)
    valid = (cc >= -0.5) & (cc < L - 0.5)
    return img, torch.where(valid, code, 0)


def load_library():
    lib = cuda_build.load("sep_warp_pass")
    if not hasattr(lib, "error_string"):
        vp = ctypes.c_void_p
        lib.sw_pass.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
        lib.sw_pass.restype = ctypes.c_int
        lib.sw_error_string.argtypes = [ctypes.c_int]
        lib.sw_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.sw_error_string
    return lib


def sep_warp_pass(word, cc, L: int):
    """One scanline pass (K1). CPU tensors take `sep_warp_pass_plain`; CUDA
    tensors launch the Hopper kernel on the current stream and add one to
    `sep_warp_pass.launches`; any other device raises."""
    if word.device.type == "cpu":
        return sep_warp_pass_plain(word, cc, L)
    if word.device.type != "cuda":
        raise ValueError(f"unsupported device {word.device}")
    if word.dtype != torch.int32 or cc.dtype != torch.float32:
        raise TypeError(f"word must be int32 and cc float32, got {word.dtype} and {cc.dtype}")
    if word.shape != cc.shape or word.shape[-1] != L or cc.device != word.device:
        raise ValueError(f"word {tuple(word.shape)} and cc {tuple(cc.shape)} must be (..., {L}) "
                         "on one device")
    if word.device.index != torch.cuda.current_device():
        raise ValueError(f"{word.device} is not the current CUDA device")
    word, cc = word.contiguous(), cc.contiguous()
    img = torch.empty(cc.shape, dtype=torch.float32, device=cc.device)
    code = torch.empty(cc.shape, dtype=torch.int32, device=cc.device)
    lib = load_library()
    err = lib.sw_pass(word.data_ptr(), cc.data_ptr(), img.data_ptr(), code.data_ptr(),
                      word.numel(), L, torch.cuda.current_stream(word.device).cuda_stream)
    cuda_build.check(lib, err, "sep_warp_pass")
    sep_warp_pass.launches += 1
    return img, code


sep_warp_pass.launches = 0


def sep_warp_apply(img, lbl, mod, fields: SepWarpFields):
    """Apply the separable warp (`sep_warp.py:378-453`, no mesh): image 1D
    lerp with border padding and labels 1D nearest with zeros padding per
    pass, all three riding one packed word per element.

    img: (B, D, H, W) float32; lbl, mod: (B, D, H, W) binary integers.
    Returns (img, lbl, mod) at the same shape. The transposes between the
    passes are `permute().contiguous()`.
    """
    B, D, H, W = img.shape
    scale = img.reshape(B, -1).abs().amax(dim=1).reshape(B, 1, 1, 1) / 2047.0
    scale = scale.clamp(min=1e-12)
    code = (lbl + 2 * mod).to(torch.int32)
    one = torch.ones_like(scale)

    # Pass 1 along W; the image leaves in int12 units, so the two repacks
    # quantize at +/-0.5 unit instead of taking the absmax again.
    x1, c1 = sep_warp_pass(pack_pass(img.float(), code, scale), unnormalize(fields.fx, W), W)

    # Pass 2 along H, in layout (B, D, W, H).
    x1 = x1.permute(0, 1, 3, 2).contiguous()
    c1 = c1.permute(0, 1, 3, 2).contiguous()
    ccy = unnormalize(fields.fy, H).permute(0, 1, 3, 2).contiguous()
    x2, c2 = sep_warp_pass(pack_pass(x1, c1, one), ccy, H)

    # Pass 3 along D, in layout (B, H, W, D).
    x2 = x2.permute(0, 3, 2, 1).contiguous()
    c2 = c2.permute(0, 3, 2, 1).contiguous()
    ccz = unnormalize(fields.fz, D).permute(0, 2, 3, 1).contiguous()
    x3, c3 = sep_warp_pass(pack_pass(x2, c2, one), ccz, D)

    img_out = x3.permute(0, 3, 1, 2) * scale
    code_out = c3.permute(0, 3, 1, 2).contiguous()
    return img_out, code_out & 1, code_out >> 1
