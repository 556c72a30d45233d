"""Carry weights between the Flax `MobileNetLRASPP3D` variables and the
port's state_dict.

The port's modules carry the Flax names (`models/lraspp3d.py`), so a
state_dict key is the Flax variable path joined by dots, e.g.
`him.InvertedResidual3D_0.ConvBN_1.Conv_0.kernel`. Only layouts differ:

  * conv kernels: Flax (kD, kH, kW, I/groups, O) <-> torch (O, I/groups, kD, kH, kW);
  * depthwise kernels (ConvBN_1 of every InvertedResidual3D): Flax
    (3, 3, 3, 1, C) <-> (27, C) float32, tap index dz*9 + dy*3 + dx, what
    the Hopper kernel takes;
  * everything else (BatchNorm `scale`, `bias`, `mean`, `var`, conv
    `bias`) as it is, including the int32 `count` of 'async'/'slab' BN,
    which the JAX package's torch bridge has no slot for.

Values on the Flax side are numpy arrays in nested dicts
(`{"params": ..., "batch_stats": ...}`). Pure numpy and torch; no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_COLLECTIONS = ("params", "batch_stats")


def _is_depthwise(path: tuple) -> bool:
    return (
        len(path) >= 4
        and path[-4].startswith("InvertedResidual3D_")
        and path[-3] == "ConvBN_1"
        and path[-2:] == ("Conv_0", "kernel")
    )


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf_to_torch(path: tuple, value) -> torch.Tensor:
    a = np.array(value)  # a writable copy: the tensor must not alias the caller's array
    if path[-1] == "kernel":
        a = a.astype(np.float32)
        if _is_depthwise(path):
            a = a.reshape(27, a.shape[-1])
        else:
            a = np.transpose(a, (4, 3, 0, 1, 2))
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaf_to_flax(path: tuple, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy().copy()
    if path[-1] == "kernel":
        if _is_depthwise(path):
            a = a.reshape(3, 3, 3, 1, a.shape[-1])
        else:
            a = np.ascontiguousarray(np.transpose(a, (2, 3, 4, 1, 0)))
    return a


def flax_to_state_dict(variables: dict) -> dict:
    """Flax `{"params", "batch_stats"}` (numpy leaves) -> the port's state_dict
    (CPU tensors), for `model.load_state_dict`."""
    sd = {}
    for coll in _COLLECTIONS:
        for path, value in _flatten(variables.get(coll, {})):
            sd[".".join(path)] = _leaf_to_torch(path, value)
    return sd


def state_dict_to_flax(state_dict: dict) -> dict:
    """The port's state_dict -> Flax `{"params", "batch_stats"}` with numpy
    leaves. BatchNorm `mean`, `var` and `count` go to batch_stats; the rest
    to params."""
    out = {c: {} for c in _COLLECTIONS}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        coll = "batch_stats" if path[-1] in ("mean", "var", "count") else "params"
        node = out[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _leaf_to_flax(path, t)
    return out


def load_flax_variables(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load Flax variables into `model` (strict: every key on both sides)."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model
