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
    current stream or raises. Its sums have a fixed order (no float
    atomics), so a run repeats bit for bit.
  * `staple_posterior` launches the same kernel in its E-only form and
    writes w (C, V); `staple_posterior_plain` is its plain version.
  * Any number of raters: up to 128 (`CHUNK`) a pass is one kernel; above,
    the chunked form sums the logit over chunks of 128 raters into a
    (C, chunks, V) float32 scratch, takes the sigmoid into a (C, V) one and
    then runs the M-step, three kernels (two for the posterior), with
    shared memory of a fixed size and sums in a fixed order. JAX's default
    consensus (`deep_staple_tpu/consensus/staple.py:51`) has no limit; its
    Pallas kernel stops at 128 (`staple_pallas.py:88`).
  * `staple_em_iter.launches` counts the kernels both wrappers launch;
    `.launches_chunked` those of the chunked form alone.
  * The wrappers size their scratch by the kernel's own plan
    (`kernel_tile_plan`, from `staple_tile_plan` in the source). `tile_plan`
    mirrors it in Python, a function of (C, R, V) alone, so that the CPU
    tests can check that it covers every voxel once within the shared
    memory of an SM; `chip_smoke.py` holds the two equal on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..ops import cuda_build

CHUNK = 128  # raters of a single-pass form at most, the rows of a chunk above (`kChunk`)
THREADS = 256  # a block (`kThreads`)
SMS = 132  # an H100 SXM's SMs: the blocks a case make one wave of them (`kSMs`)
STATIC_SMEM = 4 * CHUNK + 4 * 8 * (CHUNK + 1) + 16  # s_coef, s_red, s_last
CHUNK_TILE = 128  # voxels of the chunked form's M-step tile (`kChunkTile`)
CHUNK_BLOCKS_PER_SM = 4  # its planned residency (`kChunkBlocksPerSm`)


class StapleTile(NamedTuple):
    """The tiling of one pass (`StapleTile` / `Plan` in `csrc/staple_em.cu`)."""

    rows: int  # rows of decisions a thread holds in registers: R rounded up to even; 0 above 32
    tile: int  # voxels of each rater row one stage of the ring holds
    stages: int  # stages of each warp's ring
    blocks_per_sm: int  # resident blocks an SM the launch bounds and shared memory allow
    ntiles: int  # tiles a case
    nblk: int  # blocks a case; block b takes the tiles b, b + nblk, ...
    smem: int  # dynamic shared bytes a block
    chunks: int  # rater chunks: 1 for a single-pass form; above 128 raters the chunked form's


def tile_plan(C: int, R: int, V: int) -> StapleTile:
    """K4's tiling of (C, R, V) decisions, as the kernel computes it. Above
    `CHUNK` raters: the chunked form's M-step (tiles of `CHUNK_TILE` voxels,
    nblk blocks a case and chunk, no ring and no dynamic shared memory)."""
    if R > CHUNK:
        chunks = -(-R // CHUNK)
        ntiles = -(-V // CHUNK_TILE)
        nblk = min(ntiles, -(-(SMS * CHUNK_BLOCKS_PER_SM) // (C * chunks)))
        return StapleTile(0, CHUNK_TILE, 0, CHUNK_BLOCKS_PER_SM, ntiles, nblk, 0, chunks)
    rows = R + (R & 1) if R <= 32 else 0
    tile = 1024 if rows else 256
    stages, per_sm = (2, 1) if rows == 0 else (4, 2) if rows <= 16 else (2, 3)
    ntiles = -(-V // tile)
    nblk = min(ntiles, -(-(SMS * per_sm) // C))
    smem = stages * rows * tile if rows else stages * R * tile + (R + 1) * THREADS * 4
    return StapleTile(rows, tile, stages, per_sm, ntiles, nblk, smem, 1)


def load_library():
    lib = cuda_build.load("staple_em")
    if not hasattr(lib, "error_string"):
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.staple_em_iter.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ll, ll, ll, ll, vp]
        lib.staple_em_iter.restype = ctypes.c_int
        lib.staple_posterior.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll, ll, vp]
        lib.staple_posterior.restype = ctypes.c_int
        lib.staple_tile_plan.argtypes = [ll, ll, ll, ctypes.POINTER(ll)]
        lib.staple_tile_plan.restype = None
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


@functools.lru_cache(maxsize=None)
def kernel_tile_plan(C: int, R: int, V: int) -> StapleTile:
    """The plan as the built kernel computes it (needs the library)."""
    out = (ctypes.c_longlong * 8)()
    load_library().staple_tile_plan(C, R, V, out)
    return StapleTile(*(int(x) for x in out))


def _count(plan: StapleTile, posterior: bool) -> None:
    """Count the kernels of one call: 1 for a single-pass form; the chunked
    form's logit and sigmoid kernels, and for a pass its M-step."""
    if plan.chunks == 1:
        staple_em_iter.launches += 1
    else:
        n = 2 + (not posterior)
        staple_em_iter.launches += n
        staple_em_iter.launches_chunked += n


def _ptr(t):
    return None if t is None else t.data_ptr()


_tickets: dict = {}


def _zeroed_tickets(C: int, device, stream) -> torch.Tensor:
    """(C,) int32 ticket counters for the passes on `stream`: zeroed once;
    each pass's last block of a case leaves its counter at zero again."""
    key = (device.index, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < C:
        t = _tickets[key] = torch.zeros(max(C, 64), dtype=torch.int32, device=device)
    return t


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
    plan = kernel_tile_plan(C, R, V)
    nblk = plan.nblk
    partial = torch.empty((C, R + 1, nblk), dtype=torch.float32, device=d.device)
    sums = torch.empty((C, R + 1), dtype=torch.float32, device=d.device)
    tpart = wbuf = None
    if plan.chunks > 1:
        tpart = torch.empty((C, plan.chunks, V), dtype=torch.float32, device=d.device)
        wbuf = torch.empty((C, V), dtype=torch.float32, device=d.device)
    stream = torch.cuda.current_stream(d.device)
    tickets = _zeroed_tickets(C, d.device, stream)
    lib = load_library()
    err = lib.staple_em_iter(d.data_ptr(), coef.data_ptr(), base.data_ptr(),
                             active.data_ptr(), partial.data_ptr(), tickets.data_ptr(),
                             sums.data_ptr(), _ptr(tpart), _ptr(wbuf), C, R, V, nblk,
                             stream.cuda_stream)
    cuda_build.check(lib, err, "staple_em_iter")
    _count(plan, posterior=False)
    return sums[:, :R], sums[:, R]


def staple_posterior(d, coef, base):
    """w (C, V) float32 = sigmoid(base + coef . d): `staple_posterior_plain`
    on the CPU, K4's E-only form on the card (counted in
    `staple_em_iter.launches`)."""
    if not _on_cuda(d, coef, base):
        return staple_posterior_plain(d, coef, base)
    C, R, V = d.shape
    plan = kernel_tile_plan(C, R, V)
    w = torch.empty((C, V), dtype=torch.float32, device=d.device)
    tpart = None
    if plan.chunks > 1:
        tpart = torch.empty((C, plan.chunks, V), dtype=torch.float32, device=d.device)
    lib = load_library()
    err = lib.staple_posterior(d.data_ptr(), coef.data_ptr(), base.data_ptr(), w.data_ptr(),
                               _ptr(tpart), C, R, V, plan.nblk,
                               torch.cuda.current_stream(d.device).cuda_stream)
    cuda_build.check(lib, err, "staple_posterior")
    _count(plan, posterior=True)
    return w


staple_em_iter.launches = 0
staple_em_iter.launches_chunked = 0
