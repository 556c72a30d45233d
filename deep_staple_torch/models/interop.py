"""Carry weights between the Flax variables of `MobileNetLRASPP3D` or
`LRASPPMobileNetV3Large2D` and the port's state_dict.

The port's modules carry the Flax names (`models/lraspp3d.py`,
`models/lraspp2d.py`), so a state_dict key is the Flax variable path joined
by dots, e.g. `him.InvertedResidual3D_0.ConvBN_1.Conv_0.kernel` or
`InvertedResidual2D_3.SqueezeExcite_0.Conv_1.bias`. Only layouts differ:

  * conv kernels: Flax (kD, kH, kW, I/groups, O) <-> torch (O, I/groups, kD,
    kH, kW), in 2D (kH, kW, I/groups, O) <-> (O, I/groups, kH, kW), the
    2D model's depthwise convs included;
  * depthwise kernels (ConvBN_1 of every InvertedResidual3D): Flax
    (3, 3, 3, 1, C) <-> (27, C) float32, tap index dz*9 + dy*3 + dx, what
    the Hopper kernel takes;
  * everything else (BatchNorm `scale`, `bias`, `mean`, `var`, conv
    `bias`) as it is, including the int32 `count` of 'async'/'slab' BN,
    which the JAX package's torch bridge has no slot for.

Values on the Flax side are numpy arrays in nested dicts
(`{"params": ..., "batch_stats": ...}`). Pure numpy and torch; no JAX.

`state_from_jax` carries a whole JAX train state across (`DeepStapleState`
of `deep_staple_tpu/train/state.py` with numpy leaves): the variables, the
optax AdamW moments and count, the DP vector with its SparseAdam state, and
the step counters, so that a port step can start from any JAX step.
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
            n = a.ndim - 2  # spatial axes
            a = np.transpose(a, (n + 1, n) + tuple(range(n)))
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaf_to_flax(path: tuple, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy().copy()
    if path[-1] == "kernel":
        if _is_depthwise(path):
            a = a.reshape(3, 3, 3, 1, a.shape[-1])
        else:
            n = a.ndim - 2
            a = np.ascontiguousarray(np.transpose(a, tuple(range(2, n + 2)) + (1, 0)))
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


def _find_adam_state(node):
    """The optax ScaleByAdamState (fields count, mu, nu) inside an optax
    optimizer state (inject_hyperparams' inner_state, chain tuples)."""
    if all(hasattr(node, k) for k in ("count", "mu", "nu")):
        return node
    children = node.inner_state if hasattr(node, "inner_state") else node
    if isinstance(children, (tuple, list)):
        for child in children:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def state_from_jax(jax_state, model: torch.nn.Module, weight_decay: float = 0.01, device=None):
    """A JAX `DeepStapleState` with numpy leaves -> the port's
    `train.state.DeepStapleState`, with `model` loaded and moved to `device`
    (CUDA unless "cpu" is asked for) and its AdamW state set from optax's."""
    from ..core.device import resolve_device
    from ..train.optim import SparseAdamState, make_model_optimizer
    from ..train.state import DeepStapleState

    dev = resolve_device(device)
    load_flax_variables(model, {"params": jax_state.params, "batch_stats": jax_state.batch_stats})
    model.to(dev)
    optimizer = make_model_optimizer(model.parameters(), weight_decay)
    adam = _find_adam_state(jax_state.opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (count, mu, nu) in the JAX optimizer state")
    mu = flax_to_state_dict({"params": adam.mu})
    nu = flax_to_state_dict({"params": adam.nu})
    count = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(dev),
            "exp_avg_sq": nu[name].to(dev),
        }
    dp = dp_opt = None
    if jax_state.dp_params is not None:
        dp = torch.from_numpy(np.array(jax_state.dp_params, np.float32)).to(dev)
        o = jax_state.dp_opt_state
        dp_opt = SparseAdamState(
            mu=torch.from_numpy(np.array(o.mu, np.float32)).to(dev),
            nu=torch.from_numpy(np.array(o.nu, np.float32)).to(dev),
            count=torch.tensor(int(np.asarray(o.count)), dtype=torch.int32, device=dev),
        )
    return DeepStapleState(
        step=int(np.asarray(jax_state.step)), sched_steps=int(np.asarray(jax_state.sched_steps)),
        model=model, optimizer=optimizer, dp_params=dp, dp_opt_state=dp_opt,
    )
