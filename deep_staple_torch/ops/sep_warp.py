"""The separable (3-pass scanline) augmentation warp, fused into three Hopper
kernels.

The counterpart of `deep_staple_tpu/ops/sep_warp.py` without a mesh: the
augmentation map is split into three 1D resampling passes (x, then y, then
z), whose coordinate fields come from a partial inversion of the warp on a
coarse lattice (`sep_warp_fields`, :140-242). The JAX package packs, per
lane, the lane pair (i, i+1) of the image as two int12 quanta plus the
pair's 2-bit label codes (label | modified << 1) into one 32-bit word
(`_pack_pass`, :274-280), gathers one word per element (K1,
`_sep_pass_pallas`, :323) and transposes between the passes. The JAX
module's docstring explains the decomposition and its accuracy.

Here each pass works in place along its axis of the (B, D, H, W) batch, with
no transposes, and carries one 16-bit value an element between passes
(`encode`: the int12 quantum times 4 plus the 2-bit code), which is what
`_pack_pass` would extract from the previous pass's float image and code.

  * `sep_warp_apply` is the wrapper: a CPU tensor takes
    `sep_warp_apply_plain`; a CUDA tensor launches the three passes of
    `csrc/sep_warp_pass.cu` (tiled by `tile_plan`) or raises;
    `sep_warp_apply.launches` counts the pass launches, three a call.
  * `sep_axis_pass_plain` is one pass in plain PyTorch (`torch.gather` along
    the pass axis, the element math of `_pass_elem_math`, :283-301).
  * `torch.round` rounds half to even, as `jnp.round` does.
"""

from __future__ import annotations

import ctypes
import functools
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


def encode(x, code):
    """The 16-bit value a pass hands the next: the int12 quantum
    clamp(round(x), +/-2047) times 4 plus the 2-bit code, as int16. `>> 2`
    gives the quantum back, `& 3` the code."""
    q = torch.round(x).clamp_(-2047, 2047).to(torch.int16)
    return q * 4 + code.to(torch.int16)


def sep_axis_pass_plain(t, cc, dim: int):
    """One pass in plain PyTorch along axis `dim` of t (encoded int16), at cc
    (float32 voxel coordinates along that axis, t's shape) -> (img float32,
    code int16). The image is the lerp of the quanta at i0 and i1 = min(i0
    + 1, L - 1) (the border replication of `_pack_pass`); the code the
    nearest (half to even), 0 outside [-0.5, L - 0.5)."""
    L = t.shape[dim]
    cimg = cc.clamp(0.0, L - 1.0)
    i0 = torch.floor(cimg).to(torch.int32).clamp_(0, max(L - 2, 0))
    w = cimg - i0.float()
    g0 = torch.gather(t, dim, i0.long())
    g1 = torch.gather(t, dim, (i0.long() + 1).clamp_(max=L - 1))
    img = (g0 >> 2).float() * (1.0 - w) + (g1 >> 2).float() * w
    sel = torch.round(cc) >= (i0 + 1).float()  # clamp(round(cc) - i0, 0, 1) == 1
    code = torch.where(sel, g1 & 3, g0 & 3)
    valid = (cc >= -0.5) & (cc < L - 0.5)
    return img, torch.where(valid, code, 0)


def _absmax_step(img):
    """absmax / 2047 of each sample, (B,): the quantization step before its
    floor of 1e-12 (which the kernels apply themselves)."""
    amax = torch.linalg.vector_norm(img.reshape(img.shape[0], -1), float("inf"), dim=1)
    return amax.div_(2047.0)


def sep_warp_apply_plain(img, lbl, mod, fields: SepWarpFields):
    """The three passes in plain PyTorch, each along its axis in place: what
    the kernels compute, on any device."""
    B, D, H, W = img.shape
    scale = _absmax_step(img).clamp_(min=1e-12).reshape(B, 1, 1, 1)
    t = encode(img.float() / scale, (lbl + 2 * mod) & 3)
    t = encode(*sep_axis_pass_plain(t, unnormalize(fields.fx, W), 3))
    t = encode(*sep_axis_pass_plain(t, unnormalize(fields.fy, H), 2))
    x, code = sep_axis_pass_plain(t, unnormalize(fields.fz, D), 1)
    return x * scale, (code & 1).to(torch.int32), (code >> 1).to(torch.int32)


SMEM_MAX = 232_448  # bytes of shared memory a block may use on sm_90 (227 KB)
TILE_BYTES = 6  # a tile position: its float32 coordinate and its int16 quantum
MAX_AXIS = SMEM_MAX // TILE_BYTES  # voxels of the longest axis: one whole row in a block
TILE_COLS = 32  # positions a pass-Y or pass-Z block takes at most
X_ELEMS = 1024  # elements (whole W-rows, at least one) a pass-X block takes at most


class WarpPlan(NamedTuple):
    """How the kernels tile a (B, D, H, W) batch: pass X takes `rows_x` whole
    W-rows a block, pass Y whole H-columns of `cols_y` consecutive W
    positions, pass Z whole D-columns of `cols_z` consecutive positions of
    the (H, W) plane. A block's shared memory holds TILE_BYTES a position
    of its tile."""

    rows_x: int
    cols_y: int
    cols_z: int


def _even_split(n: int, cap: int) -> int:
    """The width of the fewest equal tiles of at most `cap` that cover n."""
    return -(-n // -(-n // cap))


@functools.lru_cache(maxsize=64)
def tile_plan(shape) -> WarpPlan:
    """The kernels' tiles for a batch of `shape` (a tuple); raises ValueError
    for a shape the kernels do not take (see `sep_warp_apply`)."""
    B, D, H, W = (int(s) for s in shape)
    if min(B, D, H, W) < 1 or B > 65_535 or D * H * W > 2**31 - 1:
        raise ValueError(f"sep_warp_apply on the card takes 1 to 65,535 samples of 1 to "
                         f"2^31 - 1 voxels; got {(B, D, H, W)}")
    too_long = {a: n for a, n in zip("DHW", (D, H, W)) if n > MAX_AXIS}
    if too_long:
        raise ValueError(f"sep_warp_apply on the card takes axes of at most {MAX_AXIS} voxels "
                         f"(a whole row in 227 KB of shared memory); got {too_long}")
    rows_x = min(D * H, max(1, X_ELEMS // W // 4 * 4))  # a multiple of 4 rows: 16-byte loads
    cols_y = _even_split(W, min(TILE_COLS, SMEM_MAX // (TILE_BYTES * H)))
    cols_z = _even_split(H * W, min(TILE_COLS, SMEM_MAX // (TILE_BYTES * D)))
    return WarpPlan(rows_x, cols_y, cols_z)


def load_library():
    lib = cuda_build.load("sep_warp_pass")
    if not hasattr(lib, "error_string"):
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sw_apply.argtypes = [vp] * 6 + [i64] * 3 + [vp] * 5 + [i] * 7 + [vp]
        lib.sw_apply.restype = ctypes.c_int
        lib.sw_error_string.argtypes = [ctypes.c_int]
        lib.sw_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.sw_error_string
    return lib


def _contiguous(t, dtype):
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _dense_samples(f, inner):
    """f if it is float32 with each sample dense (strides `inner` after the
    batch's, as a slice of the stacked fields has), else a contiguous copy:
    the kernels take a batch stride."""
    return f if f.dtype == torch.float32 and f.stride()[1:] == inner else f.float().contiguous()


def sep_warp_apply(img, lbl, mod, fields: SepWarpFields):
    """Apply the separable warp (`sep_warp.py:378-453`, no mesh): image 1D
    lerp with border padding and labels 1D nearest with zeros padding per
    pass, along W, then H, then D.

    img: (B, D, H, W) float32; lbl, mod: (B, D, H, W) binary integers;
    fields from `sep_warp_fields`. Returns (img float32, lbl int32, mod
    int32) at the same shape. CPU tensors take `sep_warp_apply_plain`; CUDA
    tensors launch the three kernels on the current stream and add 3 to
    `sep_warp_apply.launches`; any other device raises. On the card every
    axis is at most MAX_AXIS (38,741) voxels, a sample at most 2^31 - 1
    voxels and B at most 65,535: beyond that it raises ValueError.
    """
    dev = img.device
    if dev.type == "cpu":
        return sep_warp_apply_plain(img, lbl, mod, fields)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    shape = img.shape
    if any(t.shape != shape or t.device != dev for t in (lbl, mod, *fields)):
        raise ValueError(f"labels and fields must be {tuple(shape)} on {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{dev} is not the current CUDA device")
    plan = tile_plan(tuple(shape))
    # Each step here costs the host microseconds; the absmax goes first so
    # that the card works while the host prepares the rest.
    img = _contiguous(img, torch.float32)
    step = _absmax_step(img)
    lbl, mod = _contiguous(lbl, torch.int32), _contiguous(mod, torch.int32)
    inner = img.stride()[1:]
    fx, fy, fz = (_dense_samples(f, inner) for f in fields)
    tmp = torch.empty(shape, dtype=torch.int16, device=dev)
    out = torch.empty_like(img)
    labels = torch.empty((2, *shape), dtype=torch.int32, device=dev)
    lib = load_library()
    err = lib.sw_apply(img.data_ptr(), lbl.data_ptr(), mod.data_ptr(), fx.data_ptr(),
                       fy.data_ptr(), fz.data_ptr(), fx.stride(0), fy.stride(0), fz.stride(0),
                       step.data_ptr(), tmp.data_ptr(), out.data_ptr(), labels.data_ptr(),
                       labels.data_ptr() + 4 * img.numel(), *shape, *plan,
                       torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, err, "sep_warp_apply")
    sep_warp_apply.launches += 3
    return (out, *labels.unbind(0))


sep_warp_apply.launches = 0
