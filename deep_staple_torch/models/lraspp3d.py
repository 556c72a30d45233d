"""MobileNetV3-style 3D LR-ASPP segmentation network, eval and train forward.

The counterpart of `deep_staple_tpu/models/lraspp3d.py`: the same modules,
submodule names and parameter names as the Flax model, so a state_dict key is
the Flax variable path joined by dots (`models/interop.py` maps the values).
1,228,932 parameters at in=1, classes=2.

Layout: the public input is (B, D, H, W, C_in) and the output logits
(B, D, H, W, num_classes), channels last as in JAX. Inside, activations stay
NDHWC-contiguous tensors:

  * every depthwise conv goes through `ops/conv3d_dw.depthwise_conv3d`, the
    Hopper kernel on the card (both strides), which reads NDHWC directly;
  * 1x1x1 convs are matmuls over the channel axis;
  * dense 3x3x3 convs (block 0's stride-2 conv, the ASPP's dilated convs,
    the conv head) run through `F.conv3d` on the NCDHW view of the same
    memory, i.e. `torch.channels_last_3d`, and come back NDHWC.

The compute dtype (float32 or bfloat16) applies to activations and to the
weights as the convs see them; parameters stay float32, as in Flax. The
final trilinear upsample runs in float32 (`lraspp3d.py:460-473`).

Train mode (`forward(x, train=True, generator=g)`): BatchNorm in its
`bn_mode` (`models/norm.py`), ASPP dropout drawn from the explicit
`torch.Generator` g, and, with `use_checkpointing`, activation remat of the
four segments him, lom, aspp and head (`lraspp3d.py:453-458`) through
`models/remat.py`, so that a recomputation neither updates BatchNorm
statistics again nor draws a new dropout mask. `init_weights` draws
parameters from the Flax initializers' distributions (`lraspp3d.py:54-65`).

Tensor parallelism (`parallel/tensor.py::shard_model`): a sharded model's
leaves are its rank's channel slices, a column region (an inverted
residual, the ASPP, the head) passes its input through `copy_to_model`
(`model_group`), and a row conv sums its partial output over the model
group (`row_group`) before its bias. The partial products of a bfloat16
model are summed in float32 and rounded once, as one rank's conv rounds
its float32 accumulation once.

Spatial sharding (`attach_space_group`, `parallel/spatial.py`): a model
with a space group takes the whole volume on every rank of the group and
returns this rank's slab of the logits, H cut by `spatial.slab_map`. Each
layer whose window crosses the slab's edge reads its neighbours' rows
first: the dense 3x3x3 convs (block 0's stride-2 conv, the ASPP's dilated
branches, the conv head) run `F.conv3d` without H padding on the window,
a depthwise conv runs K2 on the window and crops the rows computed against
K2's own zero pad; the two global means are sums over the group; the
head's resize and the final upsample take the global extents
(`spatial.resize_h`). The global means are summed in float64 with or
without a space group, so that both round the same mean. In train mode the
exchanges carry the gradients back to the rows' owners, BatchNorm takes its
moments over the group's slabs (`models/norm.py`; not the pooled branch,
whose input every rank of the group holds whole), and the ASPP's dropout
draws the mask of the global batch and stride-4 grid and keeps this rank's
rows of it, so that the mask is the same whatever the number of ranks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3d_dw import depthwise_conv3d
from ..ops.resample import resize_nd, resize_ndhwc
from ..parallel.spatial import SpacePlan, conv_windows, resize_h, space_mean, window_rows
from ..parallel.tensor import copy_to_model, reduce_from_model
from . import remat
from .norm import BatchNorm

# Backbone channel spec (reference `MobileNet_LR_ASPP_3D.py:171-174`, in_num=1).
MID_CHANNELS = (32, 96, 96, 144, 144, 192, 192, 192, 384, 384)
OUT_CHANNELS = (16, 16, 24, 24, 32, 32, 32, 64, 64, 64)
MID_STRIDE = (1, 1, 1, 1, 1, 1, 2, 1, 1, 1)


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


def _resize_to(high, low, space):
    """The head's resize of `high` (the stride-2 grid) to `low`'s (stride
    4); on a spatially sharded model, this rank's rows of the global grid."""
    if space is None:
        return resize_ndhwc(high, low.shape[1:4])
    return resize_h(high, space.axes[1], space.axes[2], (low.shape[1], low.shape[3]))


class Conv3d(nn.Module):
    """Flax `nn.Conv` counterpart on NDHWC tensors: parameter `kernel` of shape
    (O, I/groups, k, k, k) (PyTorch's), optional `bias`, 'same' padding
    dilation * (k // 2)."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, stride: int = 1,
                 dilation: int = 1, use_bias: bool = False):
        super().__init__()
        self.stride, self.dilation, self.k = stride, dilation, kernel
        self.kernel = nn.Parameter(torch.zeros(features, in_features, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        # A row conv of a model-sharded layer (`parallel/tensor.py`): its
        # model group, and the local input channels where its input is
        # replicated.
        self.row_group = None
        self.in_index = None
        # A 3x3x3 conv of a spatially sharded model: its SpacePlan, and the
        # H grid (0, 1, 2: the input, stride 2, stride 4) of its input.
        self.space = None
        self.level = 0

    def forward(self, x):
        w = self.kernel.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.row_group is not None:
            return self._row(x, w, b)
        if self.k == 1 and self.stride == 1:
            w2 = w.reshape(w.shape[0], w.shape[1]).t()
            y = x @ w2
            return y if b is None else y.add_(b)
        pad = self.dilation * (self.k // 2)
        if self.space is not None:
            # This rank's output rows from its window of the input, which
            # holds the rows the conv reads beyond the slab: no H padding.
            src = self.space.axes[self.level]
            dst = self.space.axes[self.level + (self.stride == 2)]
            x = window_rows(x, src, conv_windows(src, dst, self.stride, self.dilation, False))
            pad = (pad, 0, pad)
        y = F.conv3d(_to_ncdhw(x), w, b, self.stride, pad, self.dilation)
        return _to_ndhwc(y).contiguous()

    def _row(self, x, w, b):
        """A 1x1x1 row conv: this rank's input channels times its kernel
        rows, in float32, summed over the model group, rounded to x's dtype
        once; then the bias, once."""
        if self.k != 1 or self.stride != 1:
            raise ValueError("a row conv is 1x1x1")
        if self.in_index is not None:
            x = copy_to_model(x, self.row_group)[..., self.in_index.to(x.device)]
        acc = torch.promote_types(x.dtype, torch.float32)
        y = x.to(acc) @ w.reshape(w.shape[0], w.shape[1]).t().to(acc)
        y = reduce_from_model(y, self.row_group).to(x.dtype)
        return y if b is None else y.add_(b)


class DepthwiseConv3D(nn.Module):
    """Depthwise 3x3x3 conv; parameter `kernel` (27, C) float32, tap index
    dz*9 + dy*3 + dx (the Flax kernel (3, 3, 3, 1, C) reshaped)."""

    def __init__(self, features: int, stride: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(27, features))
        self.space = None  # as Conv3d's
        self.level = 0

    def forward(self, x):
        w = self.kernel
        if self.dtype is not None and self.dtype != torch.float32:
            # As in JAX, the weights are cast to the compute dtype before the
            # float32 tap accumulation.
            w = w.to(self.dtype).float()
        if self.space is None:
            return depthwise_conv3d(x, w, self.stride)
        # K2 on this rank's window, which starts one output below the slab's
        # first (that output, computed against K2's own zero pad, is cropped).
        src = self.space.axes[self.level]
        dst = self.space.axes[self.level + (self.stride == 2)]
        xw = window_rows(x, src, conv_windows(src, dst, self.stride, 1, True))
        y = depthwise_conv3d(xw, w, self.stride)
        return y[:, :, 1:1 + dst.stop - dst.start].contiguous()


class _ReLU6(torch.autograd.Function):
    """min(max(x, 0), 6) in place, keeping the result for the backward: the
    gradient passes where 0 < y < 6, which is where 0 < x < 6. In-place
    `clamp_` would keep a copy of its input instead, one more activation-sized
    tensor per layer; the result is kept by the next conv anyway."""

    @staticmethod
    def forward(ctx, x):
        y = x.clamp_(0, 6)
        ctx.mark_dirty(y)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where((y > 0) & (y < 6), g, 0.0)


class ConvBN(nn.Module):
    """Conv3d (no bias) + BatchNorm + optional activation ('relu' | 'relu6')."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, stride: int = 1,
                 dilation: int = 1, groups: int = 1, act: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, bn_mode: str = "batch"):
        super().__init__()
        self.act = act
        if groups == features and groups > 1:
            if kernel != 3 or dilation != 1 or in_features != features:
                raise ValueError("depthwise convs are 3x3x3, undilated, in == out")
            self.Conv_0 = DepthwiseConv3D(features, stride, dtype)
        elif groups == 1:
            self.Conv_0 = Conv3d(in_features, features, kernel, stride, dilation)
        else:
            raise ValueError(f"groups={groups} is neither 1 nor depthwise")
        self.BatchNorm_0 = BatchNorm(features, bn_mode)

    def forward(self, x, train: bool = False):
        x = self.BatchNorm_0(self.Conv_0(x), train)
        if self.act == "relu":
            x = torch.relu_(x)  # its backward reads the result, not a copy of x
        elif self.act == "relu6":
            x = _ReLU6.apply(x) if torch.is_grad_enabled() and x.requires_grad else x.clamp_(0, 6)
        return x


class InvertedResidual3D(nn.Module):
    """Expand -> depthwise -> project block (reference Backbone_3d :141-154)."""

    def __init__(self, inc: int, midc: int, outc: int, stride: int,
                 first_full_conv: bool = False, dtype=None, bn_mode: str = "batch"):
        super().__init__()
        self.residual = inc == outc and stride == 1 and not first_full_conv
        kw = dict(dtype=dtype, bn_mode=bn_mode)
        if first_full_conv:
            # Block 0: a full 3x3x3 stride-2 conv replaces the 1x1 expansion.
            self.ConvBN_0 = ConvBN(inc, midc, kernel=3, stride=2, act="relu6", **kw)
        else:
            self.ConvBN_0 = ConvBN(inc, midc, kernel=1, act="relu6", **kw)
        self.ConvBN_1 = ConvBN(midc, midc, kernel=3, stride=stride, groups=midc, act="relu6", **kw)
        self.ConvBN_2 = ConvBN(midc, outc, kernel=1, act=None, **kw)
        self.model_group = None  # a column region of a model-sharded model

    def forward(self, x, train: bool = False):
        h = copy_to_model(x, self.model_group)
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(h, train), train), train)
        return y.add_(x) if self.residual else y


class _Backbone(nn.Module):
    def __init__(self, blocks, in_ch: int, dtype, bn_mode: str):
        super().__init__()
        self.n = len(blocks)
        inc = in_ch
        for j, i in enumerate(blocks):
            self.add_module(f"InvertedResidual3D_{j}", InvertedResidual3D(
                inc, MID_CHANNELS[i], OUT_CHANNELS[i], MID_STRIDE[i],
                first_full_conv=(i == 0), dtype=dtype, bn_mode=bn_mode,
            ))
            inc = OUT_CHANNELS[i]

    def forward(self, x, train: bool = False):
        for j in range(self.n):
            x = getattr(self, f"InvertedResidual3D_{j}")(x, train)
        return x


class BackboneHigh3D(_Backbone):
    """him_slice: blocks 0-1 of the backbone (reference :201)."""

    def __init__(self, in_ch: int = 1, dtype=None, bn_mode: str = "batch"):
        super().__init__(range(2), in_ch, dtype, bn_mode)


class BackboneLow3D(_Backbone):
    """lom_slice: blocks 2-9 of the backbone (reference :202)."""

    def __init__(self, dtype=None, bn_mode: str = "batch"):
        super().__init__(range(2, 10), OUT_CHANNELS[1], dtype, bn_mode)


class ASPP3D(nn.Module):
    """Atrous spatial pyramid pooling (reference :86-114): a 1x1 branch, dilated
    3x3x3 branches at `atrous_rates`, and a global-average-pool branch
    broadcast back over the volume (`lraspp3d.py:311-339`)."""

    def __init__(self, in_features: int = 64, out_channels: int = 128,
                 atrous_rates=(2, 4, 8, 16), dropout_rate: float = 0.5, dtype=None,
                 bn_mode: str = "batch"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.data = None  # the data group of a data-parallel step
        self.model_group = None  # a column region of a model-sharded model
        self.space = None  # the SpacePlan of a spatially sharded model (stride 4)
        self.n_rates = len(atrous_rates)
        kw = dict(act="relu", dtype=dtype, bn_mode=bn_mode)
        self.ConvBN_0 = ConvBN(in_features, out_channels, kernel=1, **kw)
        for j, rate in enumerate(atrous_rates):
            self.add_module(f"ConvBN_{j + 1}", ConvBN(
                in_features, out_channels, kernel=3, dilation=rate, **kw
            ))
        n = self.n_rates
        self.add_module(f"ConvBN_{n + 1}", ConvBN(in_features, out_channels, kernel=1, **kw))
        self.add_module(f"ConvBN_{n + 2}", ConvBN((n + 2) * out_channels, out_channels, kernel=1, **kw))

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        n = self.n_rates
        x = copy_to_model(x, self.model_group)
        branches = [getattr(self, f"ConvBN_{j}")(x, train) for j in range(n + 1)]
        pooled = space_mean(x, None if self.space is None else self.space.axes[2])
        pooled = getattr(self, f"ConvBN_{n + 1}")(pooled, train)
        branches.append(pooled.expand(*x.shape[:-1], pooled.shape[-1]))
        y = getattr(self, f"ConvBN_{n + 2}")(torch.cat(branches, dim=-1), train)
        if not train or self.dropout_rate == 0.0:
            return y
        if generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator")
        # Flax nn.Dropout: keep with probability 1 - rate, scale by 1/(1 - rate).
        state = remat.keep(generator.get_state)
        if remat.replaying():
            generator = torch.Generator(device=generator.device)
            generator.set_state(state)
        # Drawn on the generator's device: a CPU generator gives the same mask
        # to a model on any device. With a data group, the global batch's
        # mask, of which this rank keeps its rows, and with a space group the
        # global stride-4 grid's, of which it keeps its rows of H: the same
        # mask whatever the number of ranks.
        shape = list(y.shape)
        if self.data is not None:
            shape[0] *= self.data.size
        if self.space is not None:
            shape[2] = self.space.axes[2].extent
        keep = torch.rand(shape, generator=generator, device=generator.device) >= self.dropout_rate
        if self.data is not None:
            keep = keep[self.data.rows(shape[0])]
        if self.space is not None:
            keep = keep[:, :, self.space.axes[2].start:self.space.axes[2].stop]
        keep = keep.to(y.device, non_blocking=True)
        return torch.where(keep, y / (1.0 - self.dropout_rate), 0.0)


class LRASPPHead3D(nn.Module):
    """LR-ASPP head (reference :21-53, `lraspp3d.py:342-382`). low: the ASPP
    output (128 ch), high: block 1's output (16 ch)."""

    def __init__(self, num_classes: int, low_channels: int = 128, high_channels: int = 16,
                 inter_channels: int = 128, dtype=None, bn_mode: str = "batch"):
        super().__init__()
        self.ConvBN_0 = ConvBN(high_channels, inter_channels, kernel=1, act="relu",
                               dtype=dtype, bn_mode=bn_mode)
        self.Conv_0 = Conv3d(high_channels, inter_channels)
        self.Conv_1 = Conv3d(low_channels, num_classes, use_bias=True)
        self.Conv_2 = Conv3d(inter_channels, num_classes, use_bias=True)
        self.model_group = None  # a column region of a model-sharded model
        self.space = None  # the SpacePlan of a spatially sharded model

    def forward(self, low, high, train: bool = False):
        high = copy_to_model(high, self.model_group)
        x = self.ConvBN_0(high, train)
        s = self.Conv_0(space_mean(high, None if self.space is None else self.space.axes[1]))
        x = x * torch.sigmoid(s)
        # A downsample: the reference keeps torchvision's inverted naming.
        x = _resize_to(x, low, self.space)
        return self.Conv_1(low).add_(self.Conv_2(x))


class ConvHead3D(nn.Module):
    """Plain conv head of the non-LRASPP variant (reference :191-197), on
    concat(low, high resized to low's size)."""

    def __init__(self, num_classes: int, low_channels: int = 128, high_channels: int = 16,
                 dtype=None, bn_mode: str = "batch"):
        super().__init__()
        kw = dict(act="relu", dtype=dtype, bn_mode=bn_mode)
        self.ConvBN_0 = ConvBN(low_channels + high_channels, 64, kernel=1, **kw)
        self.ConvBN_1 = ConvBN(64, 64, kernel=3, **kw)
        self.Conv_0 = Conv3d(64, num_classes, use_bias=True)
        self.space = None  # the SpacePlan of a spatially sharded model

    def forward(self, low, high, train: bool = False):
        x = torch.cat([low, _resize_to(high, low, self.space)], dim=-1)
        return self.Conv_0(self.ConvBN_1(self.ConvBN_0(x, train), train))


class MobileNetLRASPP3D(nn.Module):
    """Full segmentation network. Input (B, D, H, W, C_in); output dict with
    'out': (B, D, H, W, num_classes) float32 logits at input resolution.

    Args:
        num_classes: output classes (including background).
        use_checkpointing: activation remat in training (reference :206-222);
            the eval forward does not read it.
        dtype: compute dtype (torch.bfloat16 or None for float32); params
            stay float32.
        bn_mode: 'batch' | 'async' | 'slab' (eval is the same in all three).

    Parameters start at zero (BatchNorms at identity): load a checkpoint or
    call `init_weights`.
    """

    head_type = "lraspp"

    def __init__(self, num_classes: int = 2, use_checkpointing: bool = True,
                 dropout_rate: float = 0.5, dtype: Optional[torch.dtype] = None,
                 bn_mode: str = "batch", in_channels: int = 1):
        super().__init__()
        self.num_classes = num_classes
        self.use_checkpointing = use_checkpointing
        self.dtype = dtype
        self.bn_mode = bn_mode
        kw = dict(dtype=dtype, bn_mode=bn_mode)
        self.him = BackboneHigh3D(in_channels, **kw)
        self.lom = BackboneLow3D(**kw)
        self.aspp = ASPP3D(OUT_CHANNELS[-1], dropout_rate=dropout_rate, **kw)
        head_cls = LRASPPHead3D if self.head_type == "lraspp" else ConvHead3D
        self.head = head_cls(num_classes, 128, OUT_CHANNELS[1], **kw)
        self.space = None  # the SpacePlan of a spatially sharded model

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        """x (B, D, H, W, C_in) -> {"out": float32 logits}; `generator` feeds
        the ASPP dropout in train mode. With a space group x is the whole
        volume and "out" this rank's rows of H (`self.space.axes[0]`)."""
        out_spatial = tuple(x.shape[1:4])
        if self.space is not None:
            x = self.space.split(x)
        high, low = self.stage0(x, train)
        return {"out": self.stage1(high, low, out_spatial, train, generator)}

    def _segment(self, train: bool):
        if train and self.use_checkpointing and torch.is_grad_enabled():
            return remat.checkpoint
        return lambda fn, *args: fn(*args)

    def stage0(self, x, train: bool = False):
        """him + lom, the pipeline's first stage (`parallel/pipeline.py`):
        x -> (high, low) in the compute dtype."""
        x = x.to(self.dtype or x.dtype).contiguous()
        seg = self._segment(train)
        high = seg(self.him, x, train)
        return high, seg(self.lom, high, train)

    def stage1(self, high, low, out_spatial, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """aspp + head + the final upsample to `out_spatial`, the pipeline's
        second stage: (high, low) -> float32 logits (B, *out_spatial, C)."""
        seg = self._segment(train)
        low = seg(self.aspp, low, train, generator)
        y = seg(self.head, low, high, train)
        # Final trilinear upsample to the input size, in float32 (reference :232);
        # a float64 model stays in float64.
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        if self.space is not None:  # this rank's rows of the global extent
            axes = self.space.axes
            return resize_h(y, axes[2], axes[0], (out_spatial[0], out_spatial[2]))
        return _to_ndhwc(resize_nd(_to_ncdhw(y), tuple(out_spatial), mode="linear",
                                   align_corners=False))


class MobileNetASPP3D(MobileNetLRASPP3D):
    """Variant with the plain conv head (reference MobileNet_ASPP_3D :160-257)."""

    head_type = "conv"


def attach_space_group(model: MobileNetLRASPP3D, space) -> MobileNetLRASPP3D:
    """Shard `model`'s forward over the space group `space`
    (`parallel/mesh.py::SpaceGroup`, or the SpacePlan of another model to
    share it; None detaches): one SpacePlan shared by the model, its 3x3x3
    convs (each told the H grid of its input), the ASPP and the head; every
    BatchNorm whose input is a slab of H takes the group (all but the ASPP's
    pooled branch)."""
    plan = space if space is None or isinstance(space, SpacePlan) else SpacePlan(space)
    model.space = model.aspp.space = model.head.space = plan
    pooled = getattr(model.aspp, f"ConvBN_{model.aspp.n_rates + 1}").BatchNorm_0
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.space = None if plan is None or mod is pooled else plan.group
    level = 0
    for backbone in (model.him, model.lom):
        for j in range(backbone.n):
            block = getattr(backbone, f"InvertedResidual3D_{j}")
            for conv in (block.ConvBN_0.Conv_0, block.ConvBN_1.Conv_0):
                if isinstance(conv, DepthwiseConv3D) or conv.k == 3:
                    conv.space, conv.level = plan, level
                    level += conv.stride == 2
    convs = [getattr(model.aspp, f"ConvBN_{j + 1}").Conv_0 for j in range(model.aspp.n_rates)]
    if isinstance(model.head, ConvHead3D):
        convs.append(model.head.ConvBN_1.Conv_0)
    for conv in convs:  # at stride 4
        conv.space, conv.level = plan, level
    if level != 2:
        raise ValueError(f"the backbone halves H {level} times, not twice")
    return model


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _truncated_normal_(w, std: float, gen):
    """Flax's 'normal' variance scaling: N(0, 1) cut at +-2, redrawn outside
    the cut, scaled so that the cut distribution has standard deviation std."""
    with torch.no_grad():
        t = torch.empty(w.shape, device=w.device).normal_(generator=gen)
        bad = t.abs() > 2.0
        while bad.any():
            t[bad] = torch.empty(int(bad.sum()), device=w.device).normal_(generator=gen)
            bad = t.abs() > 2.0
        w.copy_(t * (std / 0.87962566103423978))  # std of N(0, 1) cut at +-2


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random parameters with the Flax initializers' distributions
    (`lraspp3d.py:54-65`): the backbone's convs (him, lom; depthwise
    included) variance-scaling 2.0 fan_out normal; the ASPP's and head's
    convs torch's default U(+-1/sqrt(fan_in)), their biases likewise;
    BatchNorm scale 1 and bias 0, running statistics (0, 1), count 0. The
    numbers differ from Flax's for the same seed."""
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            with torch.no_grad():
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
                if hasattr(mod, "count"):
                    mod.count.zero_()
        elif isinstance(mod, DepthwiseConv3D):  # Flax (3, 3, 3, 1, C): fan_out 27 C
            _truncated_normal_(mod.kernel, math.sqrt(2.0 / mod.kernel.numel()), generator)
        elif isinstance(mod, Conv3d):  # (O, I, k, k, k)
            if name.startswith(("him.", "lom.")):
                fan_out = mod.kernel.shape[0] * math.prod(mod.kernel.shape[2:])
                _truncated_normal_(mod.kernel, math.sqrt(2.0 / fan_out), generator)
                continue
            bound = 1.0 / math.sqrt(math.prod(mod.kernel.shape[1:]))
            with torch.no_grad():
                mod.kernel.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
    return model
