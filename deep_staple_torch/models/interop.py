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
of `deep_staple_tpu/train/state.py` with numpy leaves, or the state dict
decoded from its `state.msgpack`): the variables, the optax AdamW moments
and count, the DP vector with its SparseAdam state, and the step counters,
so that a port step can start from any JAX step. `state_to_jax` is its
inverse, the state dict the JAX package writes to `state.msgpack`.
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


def _field(node, name: str):
    """A field of the JAX train state: an attribute of the pytree or a key of
    its decoded msgpack state dict (`train/flax_msgpack.py`)."""
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _find_adam_state(node):
    """The optax ScaleByAdamState (count, mu, nu) inside an optax optimizer
    state: inject_hyperparams' inner_state, chain tuples. Walks the pytree
    (attributes, tuples) or its state dict (keys; a tuple as a dict keyed
    '0', '1', ...)."""
    if isinstance(node, dict):
        if all(k in node for k in ("count", "mu", "nu")):
            return node
        if "inner_state" in node:
            return _find_adam_state(node["inner_state"])
        if node and all(k.isdigit() for k in node):
            return _find_adam_state([node[str(i)] for i in range(len(node))])
        return None
    if all(hasattr(node, k) for k in ("count", "mu", "nu")):
        return node
    children = node.inner_state if hasattr(node, "inner_state") else node
    if isinstance(children, (tuple, list)):
        for child in children:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def _set_hyperparams(optimizer, opt_state):
    """inject_hyperparams' learning rate onto `optimizer` (the driver sets it
    again before each step); its other settings must be the port's AdamW's
    (to float32), else this raises rather than train with other ones."""
    if not (isinstance(opt_state, dict) or hasattr(opt_state, "hyperparams")):
        return
    hyper = {k: np.float32(np.asarray(v)) for k, v in _field(opt_state, "hyperparams").items()}
    for group in optimizer.param_groups:
        if "learning_rate" in hyper:
            group["lr"] = float(hyper["learning_rate"])
        ours = {"b1": group["betas"][0], "b2": group["betas"][1], "eps": group["eps"],
                "eps_root": 0.0, "weight_decay": group["weight_decay"]}
        differ = {k: (float(hyper[k]), v) for k, v in ours.items()
                  if k in hyper and hyper[k] != np.float32(v)}
        if differ:
            raise ValueError(f"the JAX optimizer's hyperparameters differ from the port's "
                             f"AdamW (checkpoint, port): {differ}")


def state_from_jax(jax_state, model: torch.nn.Module, weight_decay: float = 0.01, device=None,
                   optimizer=None):
    """A JAX `DeepStapleState` -> the port's `train.state.DeepStapleState`,
    with `model` loaded and moved to `device` (CUDA unless "cpu" is asked
    for) and its AdamW state set from optax's. `jax_state` is the pytree
    with numpy leaves or its msgpack state dict (`train/flax_msgpack.py`;
    `dp_params` and `dp_opt_state` may be None). AdamW takes
    `weight_decay`; inject_hyperparams' learning rate is set and its other
    settings checked against them. `optimizer`, if given, is loaded in place
    (its parameters must be `model`'s); else a new one is made."""
    from ..core.device import resolve_device
    from ..train.optim import SparseAdamState, make_model_optimizer
    from ..train.state import DeepStapleState

    dev = resolve_device(device)
    load_flax_variables(model, {"params": _field(jax_state, "params"),
                                "batch_stats": _field(jax_state, "batch_stats")})
    model.to(dev)
    opt_state = _field(jax_state, "opt_state")
    if optimizer is None:
        optimizer = make_model_optimizer(model.parameters(), weight_decay)
    _set_hyperparams(optimizer, opt_state)
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (count, mu, nu) in the JAX optimizer state")
    mu = flax_to_state_dict({"params": _field(adam, "mu")})
    nu = flax_to_state_dict({"params": _field(adam, "nu")})
    count = float(np.asarray(_field(adam, "count")))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(dev),
            "exp_avg_sq": nu[name].to(dev),
        }
    dp = dp_opt = None
    if _field(jax_state, "dp_params") is not None:
        dp = torch.from_numpy(np.array(_field(jax_state, "dp_params"), np.float32)).to(dev)
        o = _field(jax_state, "dp_opt_state")
        dp_opt = SparseAdamState(
            mu=torch.from_numpy(np.array(_field(o, "mu"), np.float32)).to(dev),
            nu=torch.from_numpy(np.array(_field(o, "nu"), np.float32)).to(dev),
            count=torch.tensor(int(np.asarray(_field(o, "count"))), dtype=torch.int32, device=dev),
        )
    return DeepStapleState(
        step=int(np.asarray(_field(jax_state, "step"))),
        sched_steps=int(np.asarray(_field(jax_state, "sched_steps"))),
        model=model, optimizer=optimizer, dp_params=dp, dp_opt_state=dp_opt,
    )


def _np_scalar(dtype):
    """0-d numpy arrays (flax writes a JAX scalar as an ndarray, not a
    numpy scalar)."""
    return lambda x: np.array(x, dtype)


def _sorted_tree(tree: dict) -> dict:
    """Keys sorted at every level, as a dict leaves a jitted JAX function."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def state_to_jax(state) -> dict:
    """The inverse of `state_from_jax`: the port's train state -> the JAX
    `DeepStapleState`'s msgpack state dict, as the JAX package writes it
    after a train step (`flax.serialization.to_state_dict`; dict keys sorted
    as a jitted step leaves them; numpy leaves). The optimizer state is
    `optax.inject_hyperparams(optax.adamw)`'s (`deep_staple_tpu/train/
    optim.py:68-70`): its count, the hyperparameters (the last learning
    rate set, betas, eps, eps_root 0, weight decay), and the chain of
    ScaleByAdamState and two empty states. Counts are int32."""
    variables = state_dict_to_flax(state.model.state_dict())
    opt = state.optimizer
    group = opt.param_groups[0]
    mu_sd, nu_sd, count = {}, {}, 0
    for name, p in state.model.named_parameters():
        s = opt.state.get(p, {})
        mu_sd[name] = s.get("exp_avg", torch.zeros_like(p))
        nu_sd[name] = s.get("exp_avg_sq", torch.zeros_like(p))
        count = int(s["step"]) if "step" in s else 0
    f32, i32 = _np_scalar(np.float32), _np_scalar(np.int32)
    hyper = {"b1": f32(group["betas"][0]), "b2": f32(group["betas"][1]), "eps": f32(group["eps"]),
             "eps_root": f32(0.0), "learning_rate": f32(group["lr"]),
             "weight_decay": f32(group["weight_decay"])}
    adam = {"count": i32(count), "mu": _sorted_tree(state_dict_to_flax(mu_sd)["params"]),
            "nu": _sorted_tree(state_dict_to_flax(nu_sd)["params"])}
    dp = dp_opt = None
    if state.dp_params is not None:
        dp = state.dp_params.detach().cpu().numpy().astype(np.float32)
        o = state.dp_opt_state
        dp_opt = {"mu": o.mu.detach().cpu().numpy().astype(np.float32),
                  "nu": o.nu.detach().cpu().numpy().astype(np.float32),
                  "count": i32(int(o.count))}
    return {
        "step": i32(state.step), "sched_steps": i32(state.sched_steps),
        "params": _sorted_tree(variables["params"]),
        "batch_stats": _sorted_tree(variables["batch_stats"]),
        "opt_state": {"count": i32(count), "hyperparams": hyper, "hyperparams_states": {},
                      "inner_state": {"0": adam, "1": {}, "2": {}}},
        "dp_params": dp, "dp_opt_state": dp_opt,
    }
