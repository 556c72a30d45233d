"""Spatial sharding: whole-volume inference and training over a space axis.

The counterpart of `deep_staple_tpu/parallel/spatial.py`. There a volume's
H axis (axis 2 of B, D, H, W) is one `NamedSharding` over the mesh axis
'space', and GSPMD adds the halo exchanges of every conv whose window
crosses a shard's edge, and their adjoints. Here the space axis is S ranks
of a process group (`parallel/mesh.py::SpaceGroup`, one process a rank),
and each exchange is explicit code in the model's layers
(`models/lraspp3d.py`):

  * `slab_map` splits the model's three H grids (the input, the stride-2
    level, the stride-4 level) so that the slabs line up across the
    model's two halvings: the coarsest grid's rows as evenly as possible,
    each finer grid's rows twice its coarser rows, clipped to the extent.
    Slabs may differ in size, so any H that leaves every rank a row of the
    coarsest grid splits (JAX's serve asks only H % S == 0).
  * `halo_rows` / `window_rows` give a rank the rows around its slab that
    its convs read (zero outside the volume): every row that some rank
    needs from another goes into one buffer, indexed by global row, which
    is summed over the group (gloo takes only reductions and broadcasts for
    tensors on the card, `parallel/mesh.py:13-17`).
  * `space_mean` is a global mean: float64 sums of the slabs, summed over
    the group; the unsharded model takes the same float64 sum, so that both
    round the same mean.
  * `resize_h` resizes with the source rows of the global extents.
  * `gather_slabs` reassembles the full H axis on every rank.

The forward of a sharded model equals the unsharded one bit for bit where
the libraries' convs and matmuls round alike at the slab's shape: the halo
rows are the rows themselves, the depthwise kernel (K2) computes each
output alike at any extent, and a resize whose extents differ by a power
of two runs `F.interpolate` on the slab with the source rows of the global
grid.

Every exchange but `gather_slabs` is differentiable (`parallel/mesh.py::
_AllReduceSum`): the buffer is built out of place and summed over the
group, and its gradient is again the sum over the group, because the step's
loss is the sum of the ranks' shares (`train/step.py`). So a window's gradient rows go back to the
ranks that own them: each rank scatters its window's gradient into the
buffer's rows, the buffer is summed, and each owner takes its rows.
bfloat16 rows and their gradients travel as float32 over gloo. Every rank
issues the backward's sums in the same order, because every rank builds the
same graph (each computes the same list of needed rows). `window_rows`
counts the buffers it sums: `.bytes` / `.calls` in the forward, `.replay_bytes`
/ `.replay_calls` in a recomputation of `models/remat.py`, `.grad_bytes` /
`.grad_calls` in the backward (`reset_counts`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.resample import resize_ndhwc
from .mesh import SpaceGroup, _AllReduceSum

# The model's halvings of H: block 0's stride-2 conv and block 6's stride-2
# depthwise conv (`models/lraspp3d.py`, `MID_STRIDE`); levels 0, 1, 2.
LEVELS = 3


class SlabAxis(NamedTuple):
    """One H grid split over a space group: rank r holds the rows
    bounds[r] .. bounds[r + 1] of an extent of bounds[-1]."""

    group: SpaceGroup
    bounds: tuple

    @property
    def start(self) -> int:
        return self.bounds[self.group.rank]

    @property
    def stop(self) -> int:
        return self.bounds[self.group.rank + 1]

    @property
    def extent(self) -> int:
        return self.bounds[-1]

    def window(self, r: int) -> tuple:
        return self.bounds[r], self.bounds[r + 1]


def even_bounds(n: int, parts: int) -> tuple:
    """n rows over `parts` ranks as evenly as possible, the larger shares
    first: (0, ..., n)."""
    q, r = divmod(n, parts)
    out = [0]
    for i in range(parts):
        out.append(out[-1] + q + (i < r))
    return tuple(out)


def slab_map(H: int, S: int) -> tuple:
    """The bounds of the model's three H grids over S ranks: (input,
    stride-2 level, stride-4 level), each (0, ..., extent). The extents
    halve with ceil (ceil(H / 2), then ceil of that / 2). Raises ValueError
    where a rank would get no row of the coarsest grid."""
    extents = [H]
    for _ in range(LEVELS - 1):
        extents.append(-(-extents[-1] // 2))
    if extents[-1] < S:
        raise ValueError(
            f"H = {H} has {extents[-1]} rows at the model's stride 4, fewer than the "
            f"{S} ranks of the space axis: a rank would hold no row")
    levels = [even_bounds(extents[-1], S)]
    for ext in reversed(extents[:-1]):
        levels.insert(0, tuple(min(2 * b, ext) for b in levels[0]))
    return tuple(levels)


def slab_axes(H: int, space: SpaceGroup) -> tuple:
    """`slab_map` as a SlabAxis a level."""
    return tuple(SlabAxis(space, b) for b in slab_map(H, space.size))


def _carrier(t: torch.Tensor, space: SpaceGroup) -> torch.dtype:
    """The dtype rows travel in: bfloat16 as float32 over gloo (the round
    trip is exact), anything else as it is."""
    if t.dtype == torch.bfloat16 and space.backend == "gloo":
        return torch.float32
    return t.dtype


def _tally(backward: bool, t: torch.Tensor) -> None:
    """Count a halo buffer summed in the forward, in a recomputation of
    `models/remat.py` or in the backward, on `window_rows`."""
    from ..models.remat import replaying

    kind = "grad_" if backward else "replay_" if replaying() else ""
    setattr(window_rows, f"{kind}bytes",
            getattr(window_rows, f"{kind}bytes") + t.numel() * t.element_size())
    setattr(window_rows, f"{kind}calls", getattr(window_rows, f"{kind}calls") + 1)


def reset_counts() -> None:
    """Set every exchange count of `window_rows` to 0."""
    for kind in ("", "replay_", "grad_"):
        setattr(window_rows, f"{kind}bytes", 0)
        setattr(window_rows, f"{kind}calls", 0)


def _runs(rows: Sequence[int]):
    """Maximal runs of consecutive ints in sorted `rows` -> (first, count)."""
    out = []
    for g in rows:
        if out and out[-1][0] + out[-1][1] == g:
            out[-1][1] += 1
        else:
            out.append([g, 1])
    return [tuple(r) for r in out]


def window_rows(x: torch.Tensor, axis: SlabAxis, windows: Sequence[tuple]) -> torch.Tensor:
    """The rows windows[rank] = [g0, g1) of the global H axis (dim 2) of a
    tensor split by `axis` (x this rank's slab), on every rank at once (a
    collective: every rank passes every rank's window). Rows outside the
    volume are zero. Each row that some rank reads from another goes into
    one buffer at its place in the sorted list of such rows; each owner
    puts its rows there, zeros elsewhere, and the buffer is summed over the
    group (x + 0 is x). Differentiable: the gradient of a row read by
    another rank comes back to its owner through the same sum."""
    space, H = axis.group, axis.extent
    need = sorted({g for r, (g0, g1) in enumerate(windows)
                   for g in range(max(g0, 0), min(g1, H))
                   if not axis.bounds[r] <= g < axis.bounds[r + 1]})
    start, stop = axis.start, axis.stop
    at = {g: i for i, g in enumerate(need)}

    def zeros(n, dtype=x.dtype):
        shape = list(x.shape)
        shape[2] = n
        return x.new_zeros(shape, dtype=dtype)

    buf = None
    if need:
        carrier = _carrier(x, space)
        own = [g for g in need if start <= g < stop]  # one run of the buffer's rows
        # An empty run of x where this rank owns no needed row: the sum
        # then has a backward on every rank, as the buffer's read below.
        parts = [zeros(len(need), carrier), x.narrow(2, 0, 0).to(carrier)]
        if own:
            parts = ([zeros(at[own[0]], carrier)]
                     + [x.narrow(2, g - start, n).to(carrier) for g, n in _runs(own)]
                     + [zeros(len(need) - at[own[0]] - len(own), carrier)])
        buf = _AllReduceSum.apply(torch.cat(parts, dim=2), space)
        _tally(False, buf)
        if buf.requires_grad:  # the gradient is summed as the buffer was
            buf.register_hook(lambda grad: _tally(True, grad))
    g0, g1 = windows[space.rank]
    pieces, read = [], False
    g = g0
    while g < g1:
        if g < 0 or g >= H:  # outside the volume
            n = min(g1, 0 if g < 0 else g1) - g
            pieces.append(zeros(n))
        elif start <= g < stop:  # this rank's own rows
            n = min(g1, stop) - g
            pieces.append(x.narrow(2, g - start, n))
        else:  # another rank's: a run of the buffer
            n = min(g1, H, start if g < start else g1) - g
            pieces.append(buf.narrow(2, at[g], n).to(x.dtype))
            read = True
        g += n
    if buf is not None and not read:
        # An empty run of the buffer: a rank that reads no other rank's row
        # still joins the sum of the buffer's gradient, which carries its
        # rows' gradients back from the ranks that read them (autograd runs
        # a sum's backward only on a rank whose loss depends on it).
        pieces.append(buf.narrow(2, 0, 0).to(x.dtype))
    if len(pieces) == 1:
        return pieces[0].contiguous()
    return torch.cat(pieces, dim=2)


reset_counts()


def halo_rows(x: torch.Tensor, lo: int, hi: int, axis: SlabAxis) -> torch.Tensor:
    """The rows [start - lo, stop + hi) of the global H axis around this
    rank's slab x, zero outside the volume; every rank passes the same lo
    and hi."""
    return window_rows(x, axis, [(axis.bounds[r] - lo, axis.bounds[r + 1] + hi)
                                 for r in range(axis.group.size)])


def conv_windows(src: SlabAxis, dst: SlabAxis, stride: int, dilation: int,
                 kernel_pads: bool) -> list:
    """Each rank's input window of a 3-tap conv along H (zero 'same'
    padding of `dilation`) whose outputs are its rows of `dst`. A conv run
    with no H padding (`F.conv3d` with padding (p, 0, p)) reads exactly
    [stride * o0 - dilation, stride * (o1 - 1) + dilation + 1). A kernel that
    pads every border itself (K2, undilated) is given one more output below,
    which the caller crops: [stride * (o0 - 1), stride * (o1 - 1) + 2), so
    that its outputs, centred on rows stride * j of the window, line up with
    the global grid's (at stride 2 the window starts two rows below)."""
    out = []
    for r in range(dst.group.size):
        o0, o1 = dst.window(r)
        if kernel_pads:
            out.append((stride * (o0 - 1), stride * (o1 - 1) + 2))
        else:
            out.append((stride * o0 - dilation, stride * (o1 - 1) + dilation + 1))
    return out


def space_mean(x: torch.Tensor, axis: Optional[SlabAxis] = None) -> torch.Tensor:
    """The mean of x (B, D, H, W, C) over D, H and W, kept as (B, 1, 1, 1,
    C) in x's dtype: the sum in float64, over the group's slabs where
    `axis` splits H, over the extent."""
    s = x.sum(dim=(1, 2, 3), keepdim=True, dtype=torch.float64)
    H = x.shape[2]
    if axis is not None:
        s = _AllReduceSum.apply(s, axis.group)
        H = axis.extent
    return (s / (x.shape[1] * H * x.shape[3])).to(x.dtype)


def _pow2_ratio(a: int, b: int) -> bool:
    big, small = max(a, b), min(a, b)
    return big % small == 0 and (big // small) & (big // small - 1) == 0


def _source_rows(n_in: int, n_out: int, o0: int, o1: int):
    """Linear, align_corners=False: the source rows and weights of output
    rows [o0, o1) as F.interpolate takes them, in float32: src = (dst +
    0.5) * in / out - 0.5, clamped at 0; rows i0 = floor(src) and
    min(i0 + 1, in - 1), weights 1 - l and l, l = src - i0."""
    scale = np.float32(n_in) / np.float32(n_out)
    dst = np.arange(o0, o1, dtype=np.float32)
    src = np.maximum(scale * (dst + np.float32(0.5)) - np.float32(0.5), np.float32(0))
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    lam = (src - i0.astype(np.float32)).astype(np.float32)
    return i0, i1, np.float32(1) - lam, lam


def resize_h(x: torch.Tensor, src: SlabAxis, dst: SlabAxis, out_dw) -> torch.Tensor:
    """A linear (align_corners=False) resize of this rank's slab x (B, D,
    src rows, W, C) of a volume split by `src` to its rows of `dst`, D and W
    to `out_dw`: the H axis's source rows and weights come from the global
    extents (src.extent -> dst.extent), and the rows it reads come from the
    ranks that hold them (`window_rows`, a collective).

    Where the extents differ by a power of two, `F.interpolate` runs on a
    window of the source that starts on a row whose first output is a
    global output row, sized so that its scale is the global one: every
    source coordinate is then the global one shifted by a whole row, and
    the rows equal those of the unsharded resize bit for bit. Otherwise the
    H axis is interpolated row by row in float32, then D and W by
    `resize_nd`, which agrees with the unsharded resize to rounding."""
    n_in, n_out, S = src.extent, dst.extent, src.group.size
    rows = [_source_rows(n_in, n_out, *dst.window(r)) for r in range(S)]
    need = [(int(i0.min()), int(i1.max()) + 1) for i0, i1, _, _ in rows]
    D_out, W_out = out_dw
    o0, o1 = dst.start, dst.stop
    if _pow2_ratio(n_in, n_out):
        step = max(n_in // n_out, 1)  # source rows an output row (downsampling)
        wins = [((a // step) * step, min(n_in, -(-b // step) * step)) for a, b in need]
        e0, e1 = wins[src.group.rank]
        ext = window_rows(x, src, wins)
        off = e0 * n_out // n_in
        y = resize_ndhwc(ext, (D_out, (e1 - e0) * n_out // n_in, W_out))
        return y[:, :, o0 - off:o1 - off].contiguous()
    ext = window_rows(x, src, need)
    n0 = need[src.group.rank][0]
    i0, i1, w0, w1 = rows[src.group.rank]
    xf = ext.to(torch.promote_types(ext.dtype, torch.float32))
    shape = (1, 1, o1 - o0, 1, 1)
    w0 = torch.from_numpy(w0).to(xf.device, xf.dtype).reshape(shape)
    w1 = torch.from_numpy(w1).to(xf.device, xf.dtype).reshape(shape)
    idx = lambda i: torch.from_numpy(i - n0).to(xf.device)  # noqa: E731
    h = xf.index_select(2, idx(i0)) * w0 + xf.index_select(2, idx(i1)) * w1
    return resize_ndhwc(h, (D_out, o1 - o0, W_out)).to(x.dtype)


def gather_slabs(t: torch.Tensor, axis: SlabAxis, dim: int = 2) -> torch.Tensor:
    """The full axis `dim` of a tensor split by `axis` (t this rank's slab),
    on every rank: each slab in a zero buffer, summed over the group.
    Forward only: it gathers integer argmaxes, which carry no gradient."""
    shape = list(t.shape)
    shape[dim] = axis.extent
    full = t.new_zeros(shape, dtype=_carrier(t, axis.group))
    full.narrow(dim, axis.start, axis.stop - axis.start).copy_(t)
    return axis.group.all_reduce(full).to(t.dtype)


class SpacePlan:
    """A space group attached to a model (`models/lraspp3d.py::
    attach_space_group`): the group, and the slab axes of the volume the
    model's forward is running (`split`), which its layers read."""

    def __init__(self, group: SpaceGroup):
        self.group = group
        self.axes = None

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """Set the axes for the whole volume x (B, D, H, W, C) and return
        this rank's rows of it."""
        self.axes = slab_axes(x.shape[2], self.group)
        a = self.axes[0]
        return x[:, :, a.start:a.stop]


def make_whole_volume_inference(model, space: Optional[SpaceGroup], use_mind: bool = False):
    """The counterpart of JAX's `make_whole_volume_inference`
    (`deep_staple_tpu/parallel/spatial.py:33-63`): -> infer(image), image
    (B, D, H, W) the whole volume on every rank of `space` -> the int64
    argmax (B, D, H, W) on every rank. Each rank runs the model (the 3D
    model, in eval mode, on the image's device) on its slab of H, with the
    halo rows of its neighbours; the slabs of the argmax are gathered. The
    model's weights are the caller's (`models/interop.py::
    flax_to_state_dict` carries JAX's)."""
    from ..models.lraspp3d import attach_space_group
    from ..train.step import _featurize

    attach_space_group(model, space)

    def infer(image):
        x = torch.as_tensor(image, dtype=torch.float32)
        with torch.inference_mode():
            logits = model(_featurize(x, use_mind, False), train=False)["out"]
            pred = logits.argmax(dim=-1)
            if space is not None:
                pred = gather_slabs(pred, model.space.axes[0])
        return pred

    return infer
