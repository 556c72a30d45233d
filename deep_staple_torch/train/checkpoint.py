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
needs no optimizer. The JAX package's flax msgpack and orbax checkpoints are
not read here; `models/interop.py` carries JAX weights across instead.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..core.config import TrainConfig
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


def restore_checkpoint(path, template_state: DeepStapleState) -> DeepStapleState:
    """Load a `save_checkpoint` file into `template_state` (its model and
    optimizer are loaded in place, on their device) and return the restored
    state."""
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
    return (Path(path) / "state.pt").is_file()


def jax_checkpoint_only(path) -> bool:
    """True when `path` holds the JAX package's checkpoint (`state.msgpack`
    or `state.orbax`, `deep_staple_tpu/train/checkpoint.py:116-117`) and no
    `state.pt`."""
    path = Path(path)
    return not checkpoint_exists(path) and (
        (path / "state.msgpack").is_file() or (path / "state.orbax").exists())


def save_weights(path, model: torch.nn.Module, dp_params, config: TrainConfig | None = None):
    """Write the model's state_dict and the DP vector only (a serving checkpoint)."""
    _write(path, {"model": {k: _host(v) for k, v in model.state_dict().items()},
                  "dp_params": _dp_vector(dp_params)}, config)


def load_config(path) -> TrainConfig:
    return TrainConfig.from_dict(json.loads((Path(path) / "config.json").read_text()))


def restore_weights(path, model: torch.nn.Module) -> torch.Tensor:
    """Load the weights into `model` (strict) and return the DP vector, whose
    length is read from the file, as `deep_staple_tpu/serve.py:70` does."""
    saved = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(saved["model"], strict=True)
    return saved["dp_params"]
