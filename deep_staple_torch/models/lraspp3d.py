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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3d_dw import depthwise_conv3d
from ..ops.resample import resize_nd
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


def _resize_ndhwc(x, out_spatial):
    """Linear (align_corners=False) resize of an NDHWC tensor's spatial axes."""
    y = resize_nd(_to_ncdhw(x), tuple(out_spatial), mode="linear", align_corners=False)
    return _to_ndhwc(y).contiguous()


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

    def forward(self, x):
        w = self.kernel.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.k == 1 and self.stride == 1:
            w2 = w.reshape(w.shape[0], w.shape[1]).t()
            y = x @ w2
            return y if b is None else y.add_(b)
        pad = self.dilation * (self.k // 2)
        y = F.conv3d(_to_ncdhw(x), w, b, self.stride, pad, self.dilation)
        return _to_ndhwc(y).contiguous()


class DepthwiseConv3D(nn.Module):
    """Depthwise 3x3x3 conv; parameter `kernel` (27, C) float32, tap index
    dz*9 + dy*3 + dx (the Flax kernel (3, 3, 3, 1, C) reshaped)."""

    def __init__(self, features: int, stride: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(27, features))

    def forward(self, x):
        w = self.kernel
        if self.dtype is not None and self.dtype != torch.float32:
            # As in JAX, the weights are cast to the compute dtype before the
            # float32 tap accumulation.
            w = w.to(self.dtype).float()
        return depthwise_conv3d(x, w, self.stride)


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

    def forward(self, x, train: bool = False):
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x, train), train), train)
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
        branches = [getattr(self, f"ConvBN_{j}")(x, train) for j in range(n + 1)]
        pooled = x.mean(dim=(1, 2, 3), keepdim=True)
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
        # to a model on any device.
        keep = torch.rand(y.shape, generator=generator, device=generator.device) >= self.dropout_rate
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

    def forward(self, low, high, train: bool = False):
        x = self.ConvBN_0(high, train)
        s = self.Conv_0(high.mean(dim=(1, 2, 3), keepdim=True))
        x = x * torch.sigmoid(s)
        # A downsample: the reference keeps torchvision's inverted naming.
        x = _resize_ndhwc(x, low.shape[1:4])
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

    def forward(self, low, high, train: bool = False):
        x = torch.cat([low, _resize_ndhwc(high, low.shape[1:4])], dim=-1)
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

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        """x (B, D, H, W, C_in) -> {"out": float32 logits}; `generator` feeds
        the ASPP dropout in train mode."""
        in_spatial = tuple(x.shape[1:4])
        x = x.to(self.dtype or x.dtype).contiguous()
        if train and self.use_checkpointing and torch.is_grad_enabled():
            seg = remat.checkpoint
        else:
            def seg(fn, *args):
                return fn(*args)
        high = seg(self.him, x, train)
        low = seg(self.lom, high, train)
        low = seg(self.aspp, low, train, generator)
        y = seg(self.head, low, high, train)
        # Final trilinear upsample to the input size, in float32 (reference :232);
        # a float64 model stays in float64.
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        y = _to_ndhwc(resize_nd(_to_ncdhw(y), in_spatial, mode="linear",
                                align_corners=False))
        return {"out": y}


class MobileNetASPP3D(MobileNetLRASPP3D):
    """Variant with the plain conv head (reference MobileNet_ASPP_3D :160-257)."""

    head_type = "conv"


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
