"""Shared set-up of the port's training tests: a port model with weights from
`init_weights`, BatchNorm statistics moved off their init with numpy, the
same variables as a JAX train state, and tree helpers.

The JAX state is carried back with `models/interop.state_from_jax`, so the
JAX step and the port step start from the same state.
"""

import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.train import optim as joptim
from deep_staple_tpu.train.state import DeepStapleState as JaxState
from deep_staple_torch.models import init_weights
from deep_staple_torch.models.interop import state_dict_to_flax
from deep_staple_torch.train.driver import make_model

SPATIAL = (16, 16, 12)
B, N = 2, 6
CW = np.array([0.5, 1.5], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def _perturb(tree, rng):
    """Move BatchNorm statistics and scales away from their init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.2).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k == "scale":
            out[k] = rng.uniform(0.7, 1.3, v.shape).astype(np.float32)
        elif k == "count":
            out[k] = np.array(rng.randint(1, 9), np.int32)
        else:
            out[k] = np.array(v)
    return out


def port_model(config, seed):
    """(port model with dropout 0, its Flax variables with perturbed stats)."""
    model, _ = make_model(config, 2)
    model.aspp.dropout_rate = 0.0
    init_weights(model, torch.Generator().manual_seed(seed))
    variables = state_dict_to_flax(model.state_dict())
    rng = np.random.RandomState(seed)
    return model, {"params": variables["params"], "batch_stats": _perturb(variables["batch_stats"], rng)}


def batch(seed):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randn(B, *SPATIAL).astype(np.float32),
        "label": (rng.rand(B, *SPATIAL) > 0.8).astype(np.int32),
        "modified_label": (rng.rand(B, *SPATIAL) > 0.8).astype(np.int32),
        "dataset_idx": np.array([1, 3], np.int32),
    }


def jax_state(variables, dp0, tx, warm=False):
    """A JAX train state at `variables`. warm: AdamW as after 10 steps with
    second moments of 1e-4, so that the next update is smooth in the
    gradient rather than the sign-like lr * g / |g| of a first step, whose
    sign flips in near-zero gradients would swamp a comparison."""
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    if warm:
        adam = opt_state.inner_state[0]._replace(
            count=jnp.asarray(10, jnp.int32),
            nu=jax.tree.map(lambda a: jnp.full_like(a, 1e-4), params))
        opt_state = opt_state._replace(inner_state=(adam,) + tuple(opt_state.inner_state[1:]))
    return JaxState(
        step=jnp.zeros((), jnp.int32), sched_steps=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=opt_state, dp_params=jnp.asarray(dp0),
        dp_opt_state=joptim.sparse_adam_init(jnp.asarray(dp0)),
    )


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def norm(tree):
    return math.sqrt(sum(float(np.sum(np.asarray(v, np.float64) ** 2)) for _, v in flat(tree)))


def diff(a, b):
    fb = dict(flat(b))
    return {"/".join(p): np.asarray(v, np.float64) - fb[p] for p, v in flat(a)}
