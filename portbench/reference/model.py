"""MobileNet-LRASPP-3D in plain PyTorch: the reference the benchmark holds
the port's outputs against.

Written from the architecture (MobileNetV3-style inverted residuals, an
ASPP with a pooled branch, the LR-ASPP head; Weihsbach et al., WBIR 2022)
and the configuration's widths, on NCDHW tensors with `F.conv3d` for every
convolution, the depthwise ones included (groups = channels). It imports
nothing of the program. Parameters are a dict under the names the port's
`state_dict` uses, so the benchmark hands both sides the same tensors.

It computes in float32. `quant` rounds the forward's values to a lower
precision where a lower-precision model would round them (each conv's input,
weights and output, each normalisation's output); its gradient passes
unrounded (straight through). That is the benchmark's control.

BatchNorm modes: 'batch' normalises through the batch's statistics, with
their gradient (var = max(0, E[x^2] - E[x]^2)); 'slab' through statistics
of every fourth D slice (all of them below four), without their gradient;
'async' through the running statistics as they were before the step,
without gradient; 'eval' through the running statistics. 'slab' and
'async' leave in `batch_stats` what the step's update of the running
statistics takes (the slab's statistics; the whole batch's), and the caller
updates them (`update_stats`). The ASPP's dropout takes its keep mask from
the caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5
SLAB_STRIDE = 4


def param_shapes(arch: dict) -> dict:
    """name -> (shape, init) of every parameter; init is 'fan_out' (the
    backbone's convs), 'fan_in' (the ASPP's and head's convs and biases),
    'one' or 'zero' (BatchNorm scale and bias)."""
    shapes = {}

    def conv_bn(prefix, cin, cout, k, init, depthwise=False):
        shapes[f"{prefix}.Conv_0.kernel"] = ((27, cout) if depthwise else
                                             (cout, cin, k, k, k), init)
        shapes[f"{prefix}.BatchNorm_0.scale"] = ((cout,), "one")
        shapes[f"{prefix}.BatchNorm_0.bias"] = ((cout,), "zero")

    inc = arch["in_channels"]
    for i, (mid, oc) in enumerate(zip(arch["mid_channels"], arch["out_channels"])):
        pre = f"him.InvertedResidual3D_{i}" if i < 2 else f"lom.InvertedResidual3D_{i - 2}"
        conv_bn(f"{pre}.ConvBN_0", inc, mid, 3 if i == 0 else 1, "fan_out")
        conv_bn(f"{pre}.ConvBN_1", mid, mid, 3, "fan_out", depthwise=True)
        conv_bn(f"{pre}.ConvBN_2", mid, oc, 1, "fan_out")
        inc = oc
    a, n = arch["aspp_channels"], len(arch["aspp_rates"])
    conv_bn("aspp.ConvBN_0", inc, a, 1, "fan_in")
    for j in range(n):
        conv_bn(f"aspp.ConvBN_{j + 1}", inc, a, 3, "fan_in")
    conv_bn(f"aspp.ConvBN_{n + 1}", inc, a, 1, "fan_in")
    conv_bn(f"aspp.ConvBN_{n + 2}", a * (n + 2), a, 1, "fan_in")
    hc, inter, ncls = arch["out_channels"][1], arch["head_inter_channels"], arch["num_classes"]
    conv_bn("head.ConvBN_0", hc, inter, 1, "fan_in")
    shapes["head.Conv_0.kernel"] = ((inter, hc, 1, 1, 1), "fan_in")
    shapes["head.Conv_1.kernel"] = ((ncls, a, 1, 1, 1), "fan_in")
    shapes["head.Conv_1.bias"] = ((ncls,), "fan_in_bias:head.Conv_1.kernel")
    shapes["head.Conv_2.kernel"] = ((ncls, inter, 1, 1, 1), "fan_in")
    shapes["head.Conv_2.bias"] = ((ncls,), "fan_in_bias:head.Conv_2.kernel")
    return shapes


def bn_names(arch: dict) -> list:
    """The prefixes of every BatchNorm ('....BatchNorm_0')."""
    return [k[: -len(".scale")] for k in param_shapes(arch) if k.endswith("BatchNorm_0.scale")]


def update_stats(running: dict, batch_stats: dict, seeded: bool,
                 momentum: float = 0.9) -> dict:
    """The running statistics after a step: momentum * running + (1 -
    momentum) * the step's, or the step's alone for the first update
    (`seeded` False)."""
    m = momentum if seeded else 0.0
    return {k: tuple(m * r + (1.0 - m) * b for r, b in zip(running[k], batch_stats[k]))
            for k in running}


def _identity(t):
    return t


def straight_through(dtype):
    """A `quant` that rounds to `dtype` (a float8 type saturates at its
    largest finite value) with an unrounded gradient."""
    fmax = torch.finfo(dtype).max

    def quant(t):
        r = t.detach().clamp(-fmax, fmax).to(dtype).to(t.dtype)
        return t + (r - t).detach()

    return quant


class Net:
    """The forward of one set of parameters. `params`: name -> float32
    tensor; `stats`: BatchNorm prefix -> (running mean, running var) for
    'eval' and 'async'; `remat`: recompute each block in the backward
    (`torch.utils.checkpoint`), which changes no value."""

    def __init__(self, arch, params, bn_mode, quant=None, stats=None, remat=False):
        self.arch, self.p, self.bn_mode = arch, params, bn_mode
        self.q = quant or _identity
        self.stats = stats
        self.remat = remat
        self.batch_stats = {}

    def conv(self, name, x, stride=1, dilation=1, depthwise=False, bias=None):
        w = self.p[f"{name}.kernel"]
        if depthwise:
            C = w.shape[1]
            w = w.t().reshape(C, 1, 3, 3, 3)
            groups, pad = C, 1
        else:
            groups, pad = 1, dilation * (w.shape[-1] // 2)
        y = F.conv3d(self.q(x), self.q(w), None if bias is None else self.q(bias), stride, pad,
                     dilation, groups)
        return self.q(y)

    def bn(self, name, x):
        scale, bias = self.p[f"{name}.scale"], self.p[f"{name}.bias"]
        dims = (0, 2, 3, 4)
        if self.bn_mode == "eval":
            mean, var = self.stats[name]
        elif self.bn_mode == "batch":
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        elif self.bn_mode == "slab":
            xs = x[:, :, ::SLAB_STRIDE] if x.shape[2] >= SLAB_STRIDE else x
            with torch.no_grad():
                mean = xs.mean(dims)
                var = (xs * xs).mean(dims) - mean * mean
            self.batch_stats[name] = (mean, var)
        elif self.bn_mode == "async":
            mean, var = self.stats[name]
            with torch.no_grad():
                b_mean = x.mean(dims)
                self.batch_stats[name] = (b_mean, (x * x).mean(dims) - b_mean * b_mean)
        else:
            raise ValueError(f"bn_mode {self.bn_mode!r}")
        shape = (1, -1, 1, 1, 1)
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + EPS)
        return self.q(y * scale.reshape(shape) + bias.reshape(shape))

    def conv_bn(self, name, x, act=None, **kw):
        y = self.bn(f"{name}.BatchNorm_0", self.conv(f"{name}.Conv_0", x, **kw))
        if act == "relu6":
            return y.clamp(0.0, 6.0)
        return torch.relu(y) if act == "relu" else y

    def block(self, i, x):
        arch = self.arch
        pre = f"him.InvertedResidual3D_{i}" if i < 2 else f"lom.InvertedResidual3D_{i - 2}"
        s = arch["mid_stride"][i]
        h = self.conv_bn(f"{pre}.ConvBN_0", x, "relu6", stride=2 if i == 0 else 1)
        h = self.conv_bn(f"{pre}.ConvBN_1", h, "relu6", stride=s, depthwise=True)
        h = self.conv_bn(f"{pre}.ConvBN_2", h)
        inc = arch["in_channels"] if i == 0 else arch["out_channels"][i - 1]
        return self.q(h + x) if (i > 0 and s == 1 and inc == arch["out_channels"][i]) else h

    def aspp(self, x):
        n = len(self.arch["aspp_rates"])
        branches = [self.conv_bn("aspp.ConvBN_0", x, "relu")]
        for j, r in enumerate(self.arch["aspp_rates"]):
            branches.append(self.conv_bn(f"aspp.ConvBN_{j + 1}", x, "relu", dilation=r))
        pooled = self.q(x.mean(dim=(2, 3, 4), keepdim=True))
        pooled = self.conv_bn(f"aspp.ConvBN_{n + 1}", pooled, "relu")
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        return self.conv_bn(f"aspp.ConvBN_{n + 2}", torch.cat(branches, dim=1), "relu")

    def head(self, low, high):
        x = self.conv_bn("head.ConvBN_0", high, "relu")
        s = self.conv("head.Conv_0", self.q(high.mean(dim=(2, 3, 4), keepdim=True)))
        x = self.q(x * torch.sigmoid(s))
        x = self.q(F.interpolate(x, size=tuple(low.shape[2:]), mode="trilinear",
                                 align_corners=False))
        out = self.conv("head.Conv_1", low, bias=self.p["head.Conv_1.bias"])
        return self.q(out + self.conv("head.Conv_2", x, bias=self.p["head.Conv_2.bias"]))

    def _seg(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def __call__(self, x, keep=None):
        """x (B, C_in, D, H, W) -> float32 logits (B, classes, D, H, W).
        `keep(shape)` gives the ASPP dropout's keep mask of the channels-last
        shape (B, D/4, H/4, W/4, channels), as it is drawn; None: no
        dropout."""
        out_size = tuple(x.shape[2:])
        h = self.q(x)
        for i in range(len(self.arch["mid_channels"])):
            h = self._seg(lambda t, i=i: self.block(i, t), h)
            if i == 1:
                high = h
        low = self._seg(self.aspp, h)
        if keep is not None:
            rate = self.arch["dropout_rate"]
            mask = keep(tuple(low.shape[i] for i in (0, 2, 3, 4, 1))).permute(0, 4, 1, 2, 3)
            low = self.q(torch.where(mask, low / (1.0 - rate), 0.0))
        y = self._seg(self.head, low, high)
        return F.interpolate(y, size=out_size, mode="trilinear", align_corners=False)
