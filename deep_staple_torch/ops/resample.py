"""N-D resampling with PyTorch `F.interpolate` coordinate semantics.

The counterpart of `deep_staple_tpu/ops/resample.py:26-119`, which builds
the same three behaviours from per-axis interpolation matrices:

  * linear, align_corners=False: src = (dst + 0.5) * in/out - 0.5, clamped
    at 0 (the head's and the final resizes);
  * linear, align_corners=True: src = dst * (in-1)/(out-1) (the eval image);
  * nearest: src = floor(dst / scale), or floor(dst * in/out) without a
    scale (labels).

Linear resizes run through `F.interpolate` in float32 (float64 for float64
inputs) and cast back to the input dtype, as the JAX version accumulates in
float32. Nearest resizes gather with indices computed in float32 exactly as
the JAX version does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LINEAR_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def _resize_linear(x, out_spatial, align_corners: bool, scale):
    n = len(out_spatial)
    spatial = tuple(x.shape[-n:])
    # A (N, C, *spatial) tensor goes in as it is, so a channels-last view
    # keeps its memory layout; other ranks fold their leading axes into N.
    xi = x if x.dim() == n + 2 else x.reshape((-1, 1) + spatial)
    xi = xi.to(torch.promote_types(xi.dtype, torch.float32))
    if scale is not None and not align_corners:
        # The JAX version takes src = (dst + 0.5) / scale - 0.5 here; so does
        # F.interpolate with an explicit scale and recompute_scale_factor=False.
        y = F.interpolate(
            xi, scale_factor=tuple(float(s) for s in scale), mode=_LINEAR_MODES[n],
            align_corners=False, recompute_scale_factor=False,
        )
        if tuple(y.shape[-n:]) != tuple(out_spatial):
            raise ValueError(
                f"scale {scale} maps {spatial} to {tuple(y.shape[-n:])}, not {tuple(out_spatial)}"
            )
    else:
        # align_corners=True ignores the scale: src = dst * (in-1)/(out-1).
        y = F.interpolate(
            xi, size=tuple(int(s) for s in out_spatial), mode=_LINEAR_MODES[n],
            align_corners=align_corners,
        )
    y = y.to(x.dtype)
    return y if x.dim() == n + 2 else y.reshape(tuple(x.shape[:-n]) + tuple(out_spatial))


def _axis_nearest(x, axis: int, out_size: int, in_size: int, scale):
    if in_size == out_size and scale in (None, 1.0):
        return x
    ratio = (1.0 / scale) if scale is not None else (in_size / out_size)
    dst = torch.arange(out_size, dtype=torch.float32, device=x.device)
    src = torch.floor(dst * ratio).to(torch.int64).clamp_(0, in_size - 1)
    return x.index_select(axis, src)


def resize_ndhwc(x, out_spatial):
    """Linear (align_corners=False) resize of an NDHWC tensor's spatial
    axes, returned contiguous."""
    y = resize_nd(x.permute(0, 4, 1, 2, 3), tuple(out_spatial), mode="linear",
                  align_corners=False)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def resize_nd(x, out_spatial, mode: str = "linear", align_corners: bool = False, scale=None):
    """Resize the trailing ``len(out_spatial)`` axes of ``x``.

    Args:
        x: tensor of shape (..., *spatial).
        out_spatial: target sizes for the trailing axes.
        mode: 'linear' ((bi/tri)linear by rank) or 'nearest'.
        align_corners: torch align_corners semantics (linear mode only).
        scale: optional explicit scale factor (scalar or per-axis sequence),
            as torch's recompute_scale_factor=False.
    """
    n = len(out_spatial)
    if scale is not None and not isinstance(scale, (list, tuple)):
        scale = [scale] * n
    if mode == "linear":
        return _resize_linear(x, out_spatial, align_corners, scale)
    if mode != "nearest":
        raise ValueError(f"Unknown resize mode '{mode}'")
    for k in range(n):
        axis = x.dim() - n + k
        s = scale[k] if scale is not None else None
        x = _axis_nearest(x, axis, int(out_spatial[k]), x.shape[axis], s)
    return x


def interpolate_sample(b_image=None, b_label=None, scale_factor: float = 1.0, use_2d: bool = False):
    """Scale image (linear, align_corners=True) and label (nearest) batches.

    Inputs are (B, *spatial); output size is floor(in * scale) per axis
    (`deep_staple/utils/torch_utils.py:67-90`).
    """
    ndim = 2 if use_2d else 3

    def _out_sizes(arr):
        return [int(math.floor(arr.shape[1 + k] * scale_factor)) for k in range(ndim)]

    if b_image is not None:
        b_image = resize_nd(
            b_image, _out_sizes(b_image), mode="linear", align_corners=True, scale=scale_factor
        )
    if b_label is not None:
        b_label = resize_nd(
            b_label.float(), _out_sizes(b_label), mode="nearest", scale=scale_factor
        ).to(torch.int32)
    return b_image, b_label
