"""nnU-Net v2's `3d_fullres` network, `PlainConvUNet` with deep supervision,
as a segmentation network that DeepSTAPLE's training loop drives.

Source: Isensee et al., "nnU-Net: a self-configuring method for deep
learning-based biomedical image segmentation", Nature Methods 18:203-211
(2021); `MIC-DKFZ/nnUNet` v2, whose network class is
`dynamic_network_architectures.architectures.unet.PlainConvUNet`
(`deep_supervision=True`). The default widths are the nnU-Net planner's for
a 192x192x96 patch: 30,785,994 parameters at one input channel and two
classes.

Equations, with F = `features` and S = `strides` (one per stage):

  * encoder, stage s = 0..n-1:
        x = LReLU(IN(Conv3(x, stride S_s)));  x = LReLU(IN(Conv3(x)));  skip_s = x
    Conv3 is a 3x3x3 conv with padding 1 and a bias; IN normalises each
    sample's channel over D.H.W with the biased variance, eps 1e-5 and an
    affine (`models/norm.py::InstanceNorm`); LReLU has slope 0.01;
  * decoder, s = n-2..0:
        u = ConvT(x)   (F_{s+1} -> F_s, kernel = stride = S_{s+1}, a bias)
        x = cat([u, skip_s], channel)   (the upsampled tensor first)
        x = LReLU(IN(Conv3(x)))  (2 F_s -> F_s);  x = LReLU(IN(Conv3(x)))
        head_s = Conv1x1x1(x)   (F_s -> classes, a bias)
  * train mode returns {"out": head_0, "aux": [head_1, ..., head_{n-2}]};
    eval mode {"out": head_0} alone (no other head is computed). There is
    no dropout.

Departures from the published trainer, all outside this module: the
objective is DeepSTAPLE's class-weighted CE alone (nnU-Net adds a Dice
term; DP weight a per-sample CE), the optimiser is the port's AdamW
(nnU-Net's default is SGD with Nesterov momentum), and the deep-supervision
targets are order-0 selections of the label (`train/losses.py::
deep_supervision_ce`). The JAX package has no such network, so its
checkpoint formats (`state.msgpack`, `state.orbax`) refuse it
(`train/checkpoint.py`); `state.pt` holds it as any other model.

Layout, as `lraspp3d.py`: the input is (B, D, H, W, C_in) and every
activation an NDHWC-contiguous tensor, which the convs see as the NCDHW view
of the same memory (`torch.channels_last_3d`); the logits are channels last.
`dtype` (bfloat16 or None for float32) is the activations' and the weights'
as the convs see them; parameters stay float32 and the normalisation's
statistics are float32.

While `utils/tracing.py` records, the forward's spans are `unet.encoder`,
`unet.decoder` and `unet.heads`, and the counter `unet.conv_flops` adds the
FLOPs of every conv the forward launched (two a multiply-add, every tap of
the padded window counted, as cuDNN computes them).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing
from .norm import InstanceNorm

FEATURES = (32, 64, 128, 256, 320, 320)
STRIDES = ((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 1))
NEGATIVE_SLOPE = 0.01


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


class _Conv(nn.Module):
    """A conv (or, `transposed`, a transposed conv with kernel = stride) on
    NDHWC tensors, with a bias; `weight` in PyTorch's layout."""

    def __init__(self, cin: int, cout: int, kernel, stride=(1, 1, 1), transposed: bool = False):
        super().__init__()
        self.kernel, self.stride, self.transposed = tuple(kernel), tuple(stride), transposed
        shape = (cin, cout) if transposed else (cout, cin)
        self.weight = nn.Parameter(torch.zeros(*shape, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.transposed:
            y = F.conv_transpose3d(_to_ncdhw(x), w, b, self.stride)
        else:
            y = F.conv3d(_to_ncdhw(x), w, b, self.stride, [k // 2 for k in self.kernel])
        y = _to_ndhwc(y).contiguous()
        if tracing.active() is not None:
            # Two a multiply-add over every (output, tap) pair; a transposed
            # conv with kernel = stride touches each output voxel once.
            taps = 1 if self.transposed else math.prod(self.kernel)
            cin = w.shape[0] if self.transposed else w.shape[1]
            tracing.count("unet.conv_flops", 2 * y[..., 0].numel() * taps * cin * y.shape[-1])
        return y


class ConvBlock(nn.Module):
    """Conv3 (a bias) -> InstanceNorm (affine) -> LeakyReLU(0.01)."""

    def __init__(self, cin: int, cout: int, stride=(1, 1, 1)):
        super().__init__()
        self.conv = _Conv(cin, cout, (3, 3, 3), stride)
        self.norm = InstanceNorm(cout)

    def forward(self, x):
        return F.leaky_relu_(self.norm(self.conv(x)), NEGATIVE_SLOPE)


def _stage(cin: int, cout: int, stride=(1, 1, 1)) -> nn.Sequential:
    """An encoder stage: two conv blocks, the first with the stage's stride."""
    return nn.Sequential(ConvBlock(cin, cout, stride), ConvBlock(cout, cout))


class DecoderStage(nn.Sequential):
    """The transposed conv from the stage below (`up`), then two conv blocks
    on the concatenation [upsampled, skip], the first 2 C_out -> C_out."""

    def __init__(self, cin: int, cout: int, up_stride):
        super().__init__(ConvBlock(2 * cout, cout), ConvBlock(cout, cout))
        self.up = _Conv(cin, cout, up_stride, up_stride, transposed=True)

    def forward(self, x, skip):
        return self[1](self[0](torch.cat([self.up(x), skip], dim=-1)))


class PlainConvUNet3D(nn.Module):
    """nnU-Net v2's `PlainConvUNet` (3D, deep supervision). Input (B, D, H,
    W, C_in) with each spatial extent divisible by the strides' product
    ((32, 32, 16) at the defaults); output a dict of float32 channels-last
    logits (module docstring).

    Parameters start at zero (InstanceNorm at identity): load a checkpoint
    or call `init_weights`.
    """

    def __init__(self, num_classes: int = 2, in_channels: int = 1,
                 features: Sequence[int] = FEATURES, strides=STRIDES,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(features) != len(strides) or len(features) < 2:
            raise ValueError(f"{len(features)} stages' features for {len(strides)} strides")
        self.num_classes, self.dtype = num_classes, dtype
        self.features = tuple(int(f) for f in features)
        self.strides = tuple(tuple(int(s) for s in st) for st in strides)
        n = len(self.features)
        cin = in_channels
        self.encoder = nn.ModuleList()
        for f, st in zip(self.features, self.strides):
            self.encoder.append(_stage(cin, f, st))
            cin = f
        self.decoder = nn.ModuleList(
            DecoderStage(self.features[s + 1], self.features[s], self.strides[s + 1])
            for s in range(n - 1))
        self.heads = nn.ModuleList(_Conv(self.features[s], num_classes, (1, 1, 1))
                                   for s in range(n - 1))

    def divisor(self) -> tuple:
        """The product of the strides on each spatial axis."""
        return tuple(math.prod(st[a] for st in self.strides) for a in range(3))

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        """x (B, D, H, W, C_in) -> {"out": head_0} (eval), and in train mode
        also "aux": [head_1, ...]; logits (B, D_s, H_s, W_s, classes)
        float32 (float64 for a float64 model). `generator` is not read: the
        network draws nothing."""
        div = self.divisor()
        if any(n % d for n, d in zip(x.shape[1:4], div)):
            raise ValueError(f"PlainConvUNet3D needs a spatial extent divisible by {div}; "
                             f"got {tuple(x.shape[1:4])}")
        x = x.to(self.dtype or x.dtype).contiguous()
        skips = []
        with tracing.span("unet.encoder"):
            for stage in self.encoder:
                x = stage(x)
                skips.append(x)
        heads = range(len(self.decoder)) if train else (0,)
        outs = {}
        with tracing.span("unet.decoder"):
            x = skips.pop()
            for s in reversed(range(len(self.decoder))):
                x = self.decoder[s](x, skips[s])
                if s in heads:
                    outs[s] = x
        with tracing.span("unet.heads"):
            acc = torch.promote_types(x.dtype, torch.float32)
            logits = [self.heads[s](outs[s]).to(acc) for s in heads]
        out = {"out": logits[0]}
        if train:
            out["aux"] = logits[1:]
        return out


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """nnU-Net's `InitWeights_He(1e-2)`: `kaiming_normal_(a=1e-2)` on every
    conv and transposed-conv weight, with PyTorch's fan rule (fan_in: the
    weight's dim 1 times its kernel, which for a transposed conv's (C_in,
    C_out, k) layout is C_out k), zero biases; InstanceNorm weight 1 and bias
    0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _Conv):
                nn.init.kaiming_normal_(mod.weight, a=1e-2, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, InstanceNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model
