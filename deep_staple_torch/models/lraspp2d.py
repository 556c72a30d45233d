"""2D LR-ASPP MobileNetV3-Large segmentation network, eval and train forward
(`deep_staple_tpu/models/lraspp2d.py`): the reference's 2D path, torchvision's
`lraspp_mobilenet_v3_large` with the stem taking `in_channels`
(`main_deep_staple.py:386-394`).

The same modules, submodule names and parameter names as the Flax model, so
a state_dict key is the Flax variable path joined by dots
(`models/interop.py` maps the values). Stem 3x3 stride 2, 15 inverted-
residual blocks (squeeze-excite with hardsigmoid, hardswish or ReLU per
`_V3_LARGE_CFG`, the last stage dilated instead of strided), a 1x1 conv to
960; the LR-ASPP head taps 'low' after block 3 (40 channels at stride 8) and
'high' (960 at stride 16). 3,218,020 parameters at in=1, classes=2.

Layout: input (B, H, W, C_in) and logits (B, H, W, num_classes), channels
last as in JAX. 1x1 convs are matmuls over the channel axis; the others
(the stem, the depthwise 3x3 and 5x5 convs, dilated 2 in the last stage)
run through `F.conv2d` on the NCHW view of the same memory. JAX computes
them outside any Pallas kernel. BatchNorm is Flax's default (momentum 0.99,
epsilon 1e-3) with batch statistics in train mode; the model has no
`bn_mode`, no dropout and no remat. The compute dtype applies to
activations and to the weights as the convs see them; the head's sum and the
final bilinear upsample run in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resample import resize_nd
from .lraspp3d import _truncated_normal_
from .norm import BatchNorm

# (kernel, expanded, out, use_se, activation, stride, dilation)
_V3_LARGE_CFG = [
    (3, 16, 16, False, "relu", 1, 1),
    (3, 64, 24, False, "relu", 2, 1),
    (3, 72, 24, False, "relu", 1, 1),
    (5, 72, 40, True, "relu", 2, 1),
    (5, 120, 40, True, "relu", 1, 1),
    (5, 120, 40, True, "relu", 1, 1),
    (3, 240, 80, False, "hardswish", 2, 1),
    (3, 200, 80, False, "hardswish", 1, 1),
    (3, 184, 80, False, "hardswish", 1, 1),
    (3, 184, 80, False, "hardswish", 1, 1),
    (3, 480, 112, True, "hardswish", 1, 1),
    (3, 672, 112, True, "hardswish", 1, 1),
    # torchvision's dilated last stage: stride 1, dilation 2.
    (5, 672, 160, True, "hardswish", 1, 2),
    (5, 960, 160, True, "hardswish", 1, 2),
    (5, 960, 160, True, "hardswish", 1, 2),
]
# torchvision taps 'low' at the output of the first 40-channel block.
_LOW_BLOCK_IDX = 3


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _act(name: Optional[str], x):
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "hardswish":
        return F.hardswish(x)
    raise ValueError(name)


def _resize_nhwc(x, out_spatial):
    """Bilinear (align_corners=False) resize of an NHWC tensor's spatial axes."""
    y = resize_nd(x.permute(0, 3, 1, 2), tuple(out_spatial), mode="linear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """Flax `nn.Conv` counterpart on NHWC tensors: parameter `kernel` of shape
    (O, I/groups, k, k) (PyTorch's), optional `bias`, 'same' padding
    dilation * (k // 2)."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, stride: int = 1,
                 dilation: int = 1, groups: int = 1, use_bias: bool = False):
        super().__init__()
        self.stride, self.dilation, self.groups, self.k = stride, dilation, groups, kernel
        self.kernel = nn.Parameter(torch.zeros(features, in_features // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        w = self.kernel.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.k == 1 and self.stride == 1 and self.groups == 1:
            y = x @ w.reshape(w.shape[0], w.shape[1]).t()
            return y if b is None else y + b
        pad = self.dilation * (self.k // 2)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, pad, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class ConvBN2D(nn.Module):
    """Conv2d (no bias) + BatchNorm + optional activation."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, stride: int = 1,
                 dilation: int = 1, groups: int = 1, act: Optional[str] = None):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv2d(in_features, features, kernel, stride, dilation, groups)
        self.BatchNorm_0 = BatchNorm(features, "batch", momentum=0.99, epsilon=1e-3)

    def forward(self, x, train: bool = False):
        return _act(self.act, self.BatchNorm_0(self.Conv_0(x), train))


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.Conv_0 = Conv2d(channels, squeeze_channels, use_bias=True)
        self.Conv_1 = Conv2d(squeeze_channels, channels, use_bias=True)

    def forward(self, x):
        s = self.Conv_1(torch.relu(self.Conv_0(x.mean(dim=(1, 2), keepdim=True))))
        return x * F.hardsigmoid(s)


class InvertedResidual2D(nn.Module):
    """Expand (when expanded != in) -> depthwise -> squeeze-excite (if
    use_se) -> project; residual at stride 1 and in == out."""

    def __init__(self, inc: int, kernel: int, expanded: int, out: int, use_se: bool, act: str,
                 stride: int, dilation: int):
        super().__init__()
        self.residual = stride == 1 and inc == out
        self.use_se = use_se
        convs = []
        if expanded != inc:
            convs.append(ConvBN2D(inc, expanded, 1, act=act))
        convs.append(ConvBN2D(expanded, expanded, kernel, stride, dilation, groups=expanded, act=act))
        convs.append(ConvBN2D(expanded, out, 1))
        self.n = len(convs)
        for j, c in enumerate(convs):
            self.add_module(f"ConvBN2D_{j}", c)
        if use_se:
            self.SqueezeExcite_0 = SqueezeExcite(expanded, _make_divisible(expanded // 4))

    def forward(self, x, train: bool = False):
        y = x
        for j in range(self.n - 1):
            y = getattr(self, f"ConvBN2D_{j}")(y, train)
        if self.use_se:
            y = self.SqueezeExcite_0(y)
        y = getattr(self, f"ConvBN2D_{self.n - 1}")(y, train)
        return y + x if self.residual else y


class LRASPPMobileNetV3Large2D(nn.Module):
    """Input (B, H, W, C_in) -> {'out': (B, H, W, num_classes)} float32
    logits. Parameters start at zero (BatchNorms at identity): load a
    checkpoint or call `init_weights`."""

    def __init__(self, num_classes: int = 2, dtype: Optional[torch.dtype] = None,
                 in_channels: int = 1):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.ConvBN2D_0 = ConvBN2D(in_channels, 16, 3, stride=2, act="hardswish")
        inc = 16
        for i, cfg in enumerate(_V3_LARGE_CFG):
            self.add_module(f"InvertedResidual2D_{i}", InvertedResidual2D(inc, *cfg))
            inc = cfg[2]
        self.ConvBN2D_1 = ConvBN2D(inc, 960, 1, act="hardswish")
        self.ConvBN2D_2 = ConvBN2D(960, 128, 1, act="relu")
        self.Conv_0 = Conv2d(960, 128)
        low_channels = _V3_LARGE_CFG[_LOW_BLOCK_IDX][2]
        self.Conv_1 = Conv2d(low_channels, num_classes, use_bias=True)
        self.Conv_2 = Conv2d(128, num_classes, use_bias=True)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        """`generator` is taken for the 3D model's signature: this model
        draws nothing."""
        in_spatial = tuple(x.shape[1:3])
        y = self.ConvBN2D_0(x.to(self.dtype or x.dtype).contiguous(), train)
        low = None
        for i in range(len(_V3_LARGE_CFG)):
            y = getattr(self, f"InvertedResidual2D_{i}")(y, train)
            if i == _LOW_BLOCK_IDX:
                low = y
        high = self.ConvBN2D_1(y, train)
        # LR-ASPP head: cbr(high) gated by its pooled sigmoid, resized to low.
        gated = self.ConvBN2D_2(high, train) * torch.sigmoid(
            self.Conv_0(high.mean(dim=(1, 2), keepdim=True)))
        gated = _resize_nhwc(gated, low.shape[1:3])
        out = self.Conv_1(low) + self.Conv_2(gated)
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        return {"out": _resize_nhwc(out, in_spatial)}


def init_weights(model: LRASPPMobileNetV3Large2D, generator: torch.Generator):
    """Random parameters with the Flax initializers' distributions
    (`lraspp2d.py:78-170`): the ConvBN2D convs variance-scaling 2.0 fan_out
    normal, the squeeze-excite convs Flax's default (LeCun normal, zero
    bias), the head's three convs torch's default U(+-1/sqrt(fan_in)) with
    such biases; BatchNorm scale 1 and bias 0, running statistics (0, 1).
    The numbers differ from Flax's for the same seed."""
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            with torch.no_grad():
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
        elif isinstance(mod, Conv2d):
            k = mod.kernel
            if "SqueezeExcite" in name:
                _truncated_normal_(k, math.sqrt(1.0 / math.prod(k.shape[1:])), generator)
                with torch.no_grad():
                    mod.bias.zero_()
            elif name.startswith("Conv_"):
                bound = 1.0 / math.sqrt(math.prod(k.shape[1:]))
                with torch.no_grad():
                    k.uniform_(-bound, bound, generator=generator)
                    if mod.bias is not None:
                        mod.bias.uniform_(-bound, bound, generator=generator)
            else:
                fan_out = k.shape[0] * math.prod(k.shape[2:])
                _truncated_normal_(k, math.sqrt(2.0 / fan_out), generator)
    return model
