"""The yardstick's arithmetic: the H100's published peaks, the work of the
MobileNet-LRASPP-3D forward from its layer shapes, and the depthwise calls'
operations and bytes.

Everything here is counted from the configuration's published widths and
the cell's input shape, never from which kernel ran. A forward's FLOPs are
those of its convolutions and matrix products (two per multiply-add, taps
that fall outside the zero-padded volume not counted); BatchNorm,
activations, resizes and the losses are left out, so a share of the peak
built on them is a lower bound of the work done.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOP_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # float32: TF32 off
F32_CORE_FLOP_PER_S = 67e12  # float32 FMA on the CUDA cores: the depthwise taps

BYTES = {"bfloat16": 2, "float32": 4}


def tap_pairs(n: int, stride: int = 1, dilation: int = 1, k: int = 3) -> int:
    """(output, tap) pairs of one axis of a 'same'-padded conv whose input
    position lies inside the volume."""
    pad = dilation * (k // 2)
    n_out = (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    return sum(1 for o in range(n_out) for t in range(k)
               if 0 <= stride * o + dilation * t - pad < n)


def out_extent(n: int, stride: int) -> int:
    return -(-n // stride)


def layers(arch: dict, batch: int, spatial) -> list:
    """Every conv of one forward: dicts of name, kind ('dense', 'pointwise',
    'depthwise'), batch, input spatial, cin, cout, k, stride, dilation."""
    D, H, W = (int(s) for s in spatial)
    out = []

    def add(name, kind, sp, cin, cout, k=1, stride=1, dilation=1):
        out.append(dict(name=name, kind=kind, batch=batch, spatial=tuple(sp), cin=cin,
                        cout=cout, k=k, stride=stride, dilation=dilation))

    sp = (D, H, W)
    inc = arch["in_channels"]
    for i, (mid, oc, s) in enumerate(zip(arch["mid_channels"], arch["out_channels"],
                                         arch["mid_stride"])):
        if i == 0:  # a full 3x3x3 stride-2 conv in place of the 1x1 expansion
            add(f"block{i}.expand", "dense", sp, inc, mid, 3, 2)
            sp = tuple(out_extent(n, 2) for n in sp)
        else:
            add(f"block{i}.expand", "pointwise", sp, inc, mid)
        add(f"block{i}.depthwise", "depthwise", sp, mid, mid, 3, s)
        sp = tuple(out_extent(n, s) for n in sp)
        add(f"block{i}.project", "pointwise", sp, mid, oc)
        inc = oc
        if i == 1:
            high = (sp, oc)
    a = arch["aspp_channels"]
    add("aspp.pointwise", "pointwise", sp, inc, a)
    for r in arch["aspp_rates"]:
        add(f"aspp.rate{r}", "dense", sp, inc, a, 3, 1, r)
    add("aspp.pooled", "pointwise", (1, 1, 1), inc, a)
    add("aspp.merge", "pointwise", sp, a * (len(arch["aspp_rates"]) + 2), a)
    (hsp, hc), inter, ncls = high, arch["head_inter_channels"], arch["num_classes"]
    add("head.high", "pointwise", hsp, hc, inter)
    add("head.gate", "pointwise", (1, 1, 1), hc, inter)
    add("head.low_out", "pointwise", sp, a, ncls)
    add("head.high_out", "pointwise", sp, inter, ncls)
    return out


def layer_flops(layer: dict) -> int:
    taps = math.prod(tap_pairs(n, layer["stride"], layer["dilation"], layer["k"])
                     for n in layer["spatial"])
    cin = 1 if layer["kind"] == "depthwise" else layer["cin"]
    return 2 * layer["batch"] * taps * cin * layer["cout"]


def forward_flops(arch: dict, batch: int, spatial) -> int:
    return sum(layer_flops(layer) for layer in layers(arch, batch, spatial))


def parameter_count(arch: dict) -> int:
    """Parameters of the model at these widths: conv kernels, the head's two
    biases, and each BatchNorm's scale and bias."""
    n = 0
    for layer in layers(arch, 1, (8, 8, 8)):
        k3 = layer["k"] ** 3
        if layer["kind"] == "depthwise":
            n += k3 * layer["cin"]
        else:
            n += k3 * layer["cin"] * layer["cout"]
        if layer["name"] in ("head.low_out", "head.high_out"):
            n += layer["cout"]
        elif layer["name"] != "head.gate":
            n += 2 * layer["cout"]
    return n


def dw_calls(arch: dict, batch: int, spatial) -> list:
    """((B, D, H, W, C), stride) of each depthwise call of one forward."""
    return [((layer["batch"], *layer["spatial"], layer["cin"]), layer["stride"])
            for layer in layers(arch, batch, spatial) if layer["kind"] == "depthwise"]


def dw_ops(shape, stride) -> int:
    """FLOPs of a depthwise call (or of either gradient): one multiply-add
    per (output, tap) pair inside the volume, per channel."""
    B, D, H, W, C = shape
    return 2 * B * C * math.prod(tap_pairs(n, stride) for n in (D, H, W))


def dw_bytes(shape, stride, elem: int) -> int:
    """Bytes of a depthwise call read once and written once: the input, the
    output (or the cotangent) at `elem` bytes and the (27, C) float32
    weights. Each gradient moves the same."""
    B, D, H, W, C = shape
    out = B * C * math.prod(out_extent(n, stride) for n in (D, H, W))
    return (B * D * H * W * C + out) * elem + 27 * C * 4


def dw_bound_s(calls, elem: int, passes: int) -> float:
    """The least time of `passes` passes over `calls` (each a forward or a
    gradient): per call the larger of its bytes at HBM bandwidth and its
    FLOPs at the float32 CUDA-core peak."""
    return passes * sum(max(dw_bytes(sh, s, elem) / HBM_BYTES_PER_S,
                            dw_ops(sh, s) / F32_CORE_FLOP_PER_S) for sh, s in calls)
