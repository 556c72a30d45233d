"""The fused STAPLE EM iteration (K4) as a Hopper kernel, with its plain version.

The counterpart of `deep_staple_tpu/consensus/staple_pallas.py:44-109`
(`_em_iter_kernel` and `em_iteration`). For each case c, at fixed coef[c]
and base[c], one pass over the case's decisions d[c] (R raters x V voxels):

    t_j = base + sum_r coef_r d_rj,  w_j = sigmoid(t_j),
    wd_r = sum_j d_rj w_j,           ws = sum_j w_j          (float32)

Decisions are (C, R, V) uint8, the label stacks (C, R, *spatial) reshaped:
no padding and no copy (the TPU kernel pads R to 16 and V to 131072 and
stores bfloat16).

  * `staple_em_iter` is K4's wrapper (`csrc/staple_em.cu`): a CPU tensor
    takes `staple_em_iter_plain`; a CUDA tensor launches the kernel on the
    current stream or raises. Its sums have a fixed order (no atomics), so a
    run repeats bit for bit.
  * `staple_posterior` launches the same kernel in its E-only form and
    writes w (C, V); `staple_posterior_plain` is its plain version.
  * `staple_em_iter.launches` counts the launches of both.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import cuda_build

MAX_RATERS = 128
TILE = 256  # voxels a block handles at once (`kTile` in the source)
TILES_PER_BLOCK = 8  # on average; block b takes the tiles b, b + blocks, ...


def load_library():
    lib = cuda_build.load("staple_em")
    if not hasattr(lib, "error_string"):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.staple_em_iter.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ll, ll, vp]
        lib.staple_em_iter.restype = ctypes.c_int
        lib.staple_posterior.argtypes = [vp, vp, vp, vp, ll, ll, ll, ll, vp]
        lib.staple_posterior.restype = ctypes.c_int
        lib.staple_error_string.argtypes = [ctypes.c_int]
        lib.staple_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.staple_error_string
    return lib


def staple_posterior_plain(d, coef, base):
    """d (C, R, V) uint8, coef (C, R), base (C,) float32 -> w (C, V) float32."""
    return torch.sigmoid(base[:, None] + torch.bmm(coef[:, None, :], d.float())[:, 0])


def staple_em_iter_plain(d, coef, base):
    """One E+M pass in plain PyTorch -> (wd (C, R), ws (C,)) float32."""
    df = d.float()
    w = torch.sigmoid(base[:, None] + torch.bmm(coef[:, None, :], df)[:, 0])
    return torch.bmm(df, w[:, :, None])[:, :, 0], w.sum(dim=1)


def _on_cuda(d, coef, base) -> bool:
    """Check the arguments; True for CUDA tensors, False for CPU ones."""
    if d.dim() != 3 or d.dtype != torch.uint8:
        raise ValueError(f"d must be (C, R, V) uint8, got {d.dtype} {tuple(d.shape)}")
    C, R, V = d.shape
    if R > MAX_RATERS:
        raise ValueError(f"at most {MAX_RATERS} raters, got {R}")
    if tuple(coef.shape) != (C, R) or tuple(base.shape) != (C,) or \
            coef.dtype != torch.float32 or base.dtype != torch.float32:
        raise ValueError(f"coef must be float32 ({C}, {R}) and base float32 ({C},), got "
                         f"{coef.dtype} {tuple(coef.shape)} and {base.dtype} {tuple(base.shape)}")
    if d.device.type == "cpu":
        return False
    if d.device.type != "cuda":
        raise ValueError(f"unsupported device {d.device}")
    if coef.device != d.device or base.device != d.device or \
            d.device.index != torch.cuda.current_device():
        raise ValueError(f"d ({d.device}), coef ({coef.device}) and base ({base.device}) must "
                         f"lie on the current CUDA device (cuda:{torch.cuda.current_device()})")
    if not (d.is_contiguous() and coef.is_contiguous() and base.is_contiguous()):
        raise ValueError("d, coef and base must be contiguous")
    if min(C, R, V) == 0:
        raise ValueError(f"empty decisions {tuple(d.shape)}")
    return True


def _blocks(V: int) -> int:
    """Blocks a case: a fixed function of V, so the order of the sums is."""
    return -(-(-(-V // TILE)) // TILES_PER_BLOCK)


def staple_em_iter(d, coef, base, active):
    """One E+M pass for every case whose flag in `active` (C,) bool is set.

    -> (wd (C, R), ws (C,)) float32. On the CPU every case is computed; on
    the card the rows of inactive cases are left undefined (the EM loop
    keeps their last values)."""
    if not _on_cuda(d, coef, base):
        return staple_em_iter_plain(d, coef, base)
    C, R, V = d.shape
    if active.dtype != torch.bool or tuple(active.shape) != (C,) or \
            active.device != d.device or not active.is_contiguous():
        raise ValueError(f"active must be contiguous bool ({C},) on {d.device}, got "
                         f"{active.dtype} {tuple(active.shape)} on {active.device}")
    nblk = _blocks(V)
    partial = torch.empty((C, nblk, R + 1), dtype=torch.float32, device=d.device)
    sums = torch.empty((C, R + 1), dtype=torch.float32, device=d.device)
    lib = load_library()
    err = lib.staple_em_iter(d.data_ptr(), coef.data_ptr(), base.data_ptr(),
                             active.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                             C, R, V, nblk, torch.cuda.current_stream(d.device).cuda_stream)
    cuda_build.check(lib, err, "staple_em_iter")
    staple_em_iter.launches += 1
    return sums[:, :R], sums[:, R]


def staple_posterior(d, coef, base):
    """w (C, V) float32 = sigmoid(base + coef . d): `staple_posterior_plain`
    on the CPU, K4's E-only form on the card (counted in
    `staple_em_iter.launches`)."""
    if not _on_cuda(d, coef, base):
        return staple_posterior_plain(d, coef, base)
    C, R, V = d.shape
    nblk = _blocks(V)
    w = torch.empty((C, V), dtype=torch.float32, device=d.device)
    lib = load_library()
    err = lib.staple_posterior(d.data_ptr(), coef.data_ptr(), base.data_ptr(), w.data_ptr(),
                               C, R, V, nblk, torch.cuda.current_stream(d.device).cuda_stream)
    cuda_build.check(lib, err, "staple_posterior")
    staple_em_iter.launches += 1
    return w


staple_em_iter.launches = 0
