"""MobileNet-LRASPP-3D (Weihsbach et al., DeepSTAPLE, WBIR 2022): its
reference forward (`reference/model.py`) and its work (`flops.py`), under
the names `archs.load` looks for."""

from __future__ import annotations

from portbench.flops import dw_calls, forward_flops, parameter_count
from portbench.reference.model import Net, bn_names, param_shapes

__all__ = ["Net", "dw_calls", "forward_flops", "head_bias", "param_shapes", "parameter_count",
           "stat_names"]

stat_names = bn_names


def head_bias(arch: dict) -> str:
    return "head.Conv_1.bias"
