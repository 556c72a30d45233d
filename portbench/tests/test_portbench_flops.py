"""The frozen FLOP and byte counts against counts by hand and by brute force
at small shapes, and the model's widths against the port's model."""

from __future__ import annotations

import itertools
import json
import math

import pytest

from portbench import flops

from .conftest import REPO

ARCH = json.loads((REPO / "portbench/configs/lraspp3d-production.json").read_text())["model"]


def _brute_taps(n, stride, dilation, k=3):
    pad = dilation * (k // 2)
    n_out = (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    return n_out, sum(1 for o, t in itertools.product(range(n_out), range(k))
                      if 0 <= o * stride + t * dilation - pad < n)


@pytest.mark.parametrize("n,stride,dilation", [(5, 1, 1), (5, 2, 1), (19, 1, 16), (4, 1, 2),
                                               (1, 1, 1), (38, 2, 1)])
def test_tap_pairs(n, stride, dilation):
    assert flops.tap_pairs(n, stride, dilation) == _brute_taps(n, stride, dilation)[1]


def test_dw_counts_by_hand():
    # (1, 3, 3, 3, 2), stride 1: along an axis of 3, the taps inside are
    # 2 + 3 + 2 = 7, so 7^3 pairs a channel, 2 FLOPs each.
    assert flops.dw_ops((1, 3, 3, 3, 2), 1) == 2 * 2 * 7 ** 3
    # bytes: 27 voxels x 2 channels in and out at 2 bytes, 27 x 2 float32 weights
    assert flops.dw_bytes((1, 3, 3, 3, 2), 1, 2) == (54 + 54) * 2 + 54 * 4
    # stride 2 on 3: outputs 2; taps 2 + 2
    assert flops.dw_bytes((1, 3, 3, 3, 2), 2, 4) == (54 + 8 * 2) * 4 + 54 * 4
    assert flops.dw_ops((1, 3, 3, 3, 2), 2) == 2 * 2 * 4 ** 3


def test_forward_flops_at_one_shape():
    spatial = (8, 8, 4)
    total = 0
    for layer in flops.layers(ARCH, 2, spatial):
        taps = math.prod(_brute_taps(n, layer["stride"], layer["dilation"], layer["k"])[1]
                         for n in layer["spatial"])
        cin = 1 if layer["kind"] == "depthwise" else layer["cin"]
        total += 2 * 2 * taps * cin * layer["cout"]
    assert flops.forward_flops(ARCH, 2, spatial) == total
    # block 0's 3x3x3 stride-2 conv by hand: 1 -> 32 channels, (8, 8, 4) ->
    # (4, 4, 2); taps inside: 11 along 8 (stride 2), 5 along 4.
    first = flops.layers(ARCH, 2, spatial)[0]
    assert flops.layer_flops(first) == 2 * 2 * 11 * 11 * 5 * 1 * 32


def test_dw_calls_follow_the_strides():
    calls = flops.dw_calls(ARCH, 8, (192, 192, 75))
    assert calls[0] == ((8, 96, 96, 38, 32), 1)
    assert calls[6] == ((8, 96, 96, 38, 192), 2)
    assert calls[7] == ((8, 48, 48, 19, 192), 1) and len(calls) == 10


def test_widths_are_the_ports():
    from deep_staple_torch.models import MobileNetLRASPP3D, count_params

    model = MobileNetLRASPP3D(num_classes=ARCH["num_classes"])
    assert count_params(model) == flops.parameter_count(ARCH) == ARCH["parameters"]
