"""The port's checkpoint: a directory with `config.json` and `state.pt`
(`deep_staple_tpu/train/checkpoint.py`).

`state.pt`, written with `torch.save`, holds the whole train state:

  * "model": the model's state_dict (parameters and BatchNorm buffers,
    `count` included),
  * "dp_params": the float32 DP vector,
  * "optimizer": the AdamW state_dict,
  * "dp_opt_state": SparseAdam's moments and step ({"mu", "nu", "count"}),
  * "step" and "sched_steps": the batch and scheduler counters.

`save_checkpoint` / `restore_checkpoint` write and read the whole state for
the training driver. `save_weights` writes the model and the DP vector alone,
and `restore_weights` reads them from either kind of file: the serving path
needs no optimizer.

The JAX package's `state.msgpack` (`deep_staple_tpu/train/checkpoint.py`,
flax's msgpack form of its `DeepStapleState`) is read too, by the port's own
decoder (`train/flax_msgpack.py`; no `msgpack` package) and
`models/interop.state_from_jax`; `save_jax_checkpoint` writes one. Where a
directory holds both, the port's `state.pt` wins. JAX's `state.orbax` (an
orbax / tensorstore directory, which JAX prefers over its msgpack) is not
read: restoring from a directory whose newest JAX state is orbax raises
`NotImplementedError`.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..core.config import TrainConfig
from .flax_msgpack import msgpack_restore, to_bytes
from .optim import SparseAdamState
from .state import DeepStapleState

# The JAX package's default backend name; the port writes its own state.pt
# for it.
BACKENDS = ("msgpack", "torch")


def check_backend(backend: str):
    if backend == "orbax":
        raise NotImplementedError(
            "checkpoint_backend 'orbax' is the JAX package's format; the port writes its "
            "own single-file format, state.pt (checkpoint_backend 'msgpack' or 'torch')")
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _host(t):
    return t.detach().cpu().clone()


def _write(path, state: dict, config: TrainConfig | None):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / "state.pt.tmp"
    torch.save(state, tmp)
    tmp.replace(path / "state.pt")
    if config is not None:
        (path / "config.json").write_text(json.dumps(config.to_dict(), indent=2, default=str))


def _dp_vector(dp_params) -> torch.Tensor:
    if not isinstance(dp_params, torch.Tensor):
        dp_params = torch.from_numpy(np.array(dp_params, np.float32))
    return _host(dp_params).float().reshape(-1)


def _optimizer_to_host(sd: dict) -> dict:
    return {
        "state": {k: {n: _host(v) if isinstance(v, torch.Tensor) else v for n, v in s.items()}
                  for k, s in sd["state"].items()},
        "param_groups": sd["param_groups"],
    }


def save_checkpoint(path, state: DeepStapleState, config: TrainConfig | None = None,
                    backend: str = "msgpack"):
    """Write the whole train state to `path`/state.pt (and config.json)."""
    check_backend(backend)
    out = {
        "model": {k: _host(v) for k, v in state.model.state_dict().items()},
        "optimizer": _optimizer_to_host(state.optimizer.state_dict()),
        "step": int(state.step),
        "sched_steps": int(state.sched_steps),
        "dp_params": None,
        "dp_opt_state": None,
    }
    if state.dp_params is not None:
        out["dp_params"] = _dp_vector(state.dp_params)
        o = state.dp_opt_state
        out["dp_opt_state"] = {"mu": _host(o.mu), "nu": _host(o.nu), "count": _host(o.count)}
    _write(path, out, config)


def _jax_state_dict(path):
    """The JAX checkpoint's state dict, or None where `path` has `state.pt`.
    Raises for an orbax state that the JAX package would restore."""
    path = Path(path)
    if (path / "state.pt").is_file():
        return None
    if (path / "state.orbax").exists():
        raise NotImplementedError(
            f"{path / 'state.orbax'}: the JAX package's orbax checkpoints are not read by the "
            "port, which does not depend on orbax or tensorstore; the JAX package reads it, "
            "or writes state.msgpack with checkpoint_backend 'msgpack'")
    return msgpack_restore((path / "state.msgpack").read_bytes())


def restore_checkpoint(path, template_state: DeepStapleState) -> DeepStapleState:
    """Load a `save_checkpoint` file, or the JAX package's `state.msgpack`,
    into `template_state` (its model and optimizer are loaded in place, on
    their device) and return the restored state."""
    jax_tree = _jax_state_dict(path)
    if jax_tree is not None:
        from ..models.interop import state_from_jax

        model = template_state.model
        return state_from_jax(jax_tree, model, device=next(model.parameters()).device,
                              optimizer=template_state.optimizer)
    saved = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    if "optimizer" not in saved:
        raise ValueError(f"{path} holds weights only (save_weights); it cannot resume training")
    model = template_state.model
    model.load_state_dict(saved["model"], strict=True)
    template_state.optimizer.load_state_dict(saved["optimizer"])
    dev = next(model.parameters()).device
    dp = dp_opt = None
    if saved["dp_params"] is not None:
        dp = saved["dp_params"].to(dev)
        o = saved["dp_opt_state"]
        dp_opt = SparseAdamState(mu=o["mu"].to(dev), nu=o["nu"].to(dev), count=o["count"].to(dev))
    return DeepStapleState(
        step=int(saved["step"]), sched_steps=int(saved["sched_steps"]), model=model,
        optimizer=template_state.optimizer, dp_params=dp, dp_opt_state=dp_opt,
    )


def checkpoint_exists(path) -> bool:
    """A checkpoint of either package: `state.pt`, or JAX's `state.msgpack`
    or `state.orbax` (`deep_staple_tpu/train/checkpoint.py:116-117`)."""
    path = Path(path)
    return ((path / "state.pt").is_file() or (path / "state.msgpack").is_file()
            or (path / "state.orbax").is_dir())


def jax_checkpoint_only(path) -> bool:
    """True when `path` holds the JAX package's checkpoint (`state.msgpack`
    or `state.orbax`, `deep_staple_tpu/train/checkpoint.py:116-117`) and no
    `state.pt`."""
    path = Path(path)
    return not (path / "state.pt").is_file() and (
        (path / "state.msgpack").is_file() or (path / "state.orbax").exists())


def save_weights(path, model: torch.nn.Module, dp_params, config: TrainConfig | None = None):
    """Write the model's state_dict and the DP vector only (a serving checkpoint)."""
    _write(path, {"model": {k: _host(v) for k, v in model.state_dict().items()},
                  "dp_params": _dp_vector(dp_params)}, config)


def load_config(path) -> TrainConfig:
    return TrainConfig.from_dict(json.loads((Path(path) / "config.json").read_text()))


def save_jax_checkpoint(path, state: DeepStapleState, config: TrainConfig | None = None):
    """Write `state` as the JAX package's checkpoint: `state.msgpack` (the
    bytes `flax.serialization.to_bytes` gives for the JAX state,
    `models/interop.state_to_jax`) and `config.json`."""
    from ..models.interop import state_to_jax

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / "state.msgpack.tmp"
    tmp.write_bytes(to_bytes(state_to_jax(state)))
    tmp.replace(path / "state.msgpack")
    if config is not None:
        (path / "config.json").write_text(json.dumps(config.to_dict(), indent=2, default=str))


def restore_weights(path, model: torch.nn.Module) -> torch.Tensor | None:
    """Load the weights into `model` (strict) and return the DP vector, whose
    length is read from the file, as `deep_staple_tpu/serve.py:70` does;
    from `state.pt` or the JAX package's `state.msgpack` (None where that run
    had no data parameters)."""
    jax_tree = _jax_state_dict(path)
    if jax_tree is not None:
        from ..models.interop import load_flax_variables

        load_flax_variables(model, {"params": jax_tree["params"],
                                    "batch_stats": jax_tree["batch_stats"]})
        dp = jax_tree["dp_params"]
        return None if dp is None else torch.from_numpy(np.array(dp, np.float32))
    saved = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(saved["model"], strict=True)
    return saved["dp_params"]
