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

The JAX package's checkpoints (`deep_staple_tpu/train/checkpoint.py`) are
read too, through `models/interop.state_from_jax`: `state.orbax`, orbax's
directory of its `DeepStapleState` (`train/orbax_io.py`; no orbax or
tensorstore), before `state.msgpack`, flax's msgpack form of it
(`train/flax_msgpack.py`; no `msgpack` package), as JAX restores them.
Where a directory holds the port's `state.pt` too, `state.pt` wins.
The JAX package has no `PlainConvUNet` (`models/plainconvunet3d.py`), so
its formats refuse that network both ways, with a ValueError
(`_require_jax_model`); `state.pt` holds it as any other model.
`save_jax_checkpoint` writes a `state.msgpack`; `save_checkpoint` with
backend 'orbax' writes a `state.orbax` (uncompressed) that the JAX package
restores, and the 'msgpack' and 'torch' backends write `state.pt`. Each
save removes, once its own file has landed, the files that would shadow it
for one package or the other: an orbax save the directory's `state.pt` and
`state.msgpack`, a `state.pt` save its `state.orbax` (JAX's rules,
`deep_staple_tpu/train/checkpoint.py:60-66, 89-98`, under the port's
precedence).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from ..core.config import TrainConfig
from .flax_msgpack import msgpack_restore, to_bytes
from .optim import SparseAdamState
from .orbax_io import read_orbax, write_orbax
from .state import DeepStapleState

# 'msgpack', the JAX package's default name, and 'torch' write the port's
# state.pt; 'orbax' writes JAX's state.orbax.
BACKENDS = ("msgpack", "torch", "orbax")


def check_backend(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _host(t):
    return t.detach().cpu().clone()


def _write_config(path: Path, config: TrainConfig | None):
    if config is not None:
        (path / "config.json").write_text(json.dumps(config.to_dict(), indent=2, default=str))


def _write(path, state: dict, config: TrainConfig | None):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / "state.pt.tmp"
    torch.save(state, tmp)
    tmp.replace(path / "state.pt")
    _write_config(path, config)


def _require_jax_model(model) -> None:
    """Refuse a network the JAX package's checkpoints cannot hold."""
    from ..models.plainconvunet3d import PlainConvUNet3D

    if isinstance(model, PlainConvUNet3D):
        raise ValueError("PlainConvUNet3D has no JAX counterpart: its checkpoint is the port's "
                         "state.pt (backend 'msgpack' or 'torch'), not state.orbax or "
                         "state.msgpack")


def _write_orbax(path: Path, state: DeepStapleState, config: TrainConfig | None):
    """`state` as JAX's `state.orbax`, written beside and moved in place once
    complete; then the port's `state.pt` and JAX's `state.msgpack`, which
    would shadow it, go."""
    from ..models.interop import state_to_jax

    _require_jax_model(state.model)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / "state.orbax.tmp"
    write_orbax(tmp, state_to_jax(state))
    if (path / "state.orbax").exists():
        shutil.rmtree(path / "state.orbax")
    tmp.replace(path / "state.orbax")
    (path / "state.pt").unlink(missing_ok=True)
    (path / "state.msgpack").unlink(missing_ok=True)
    _write_config(path, config)


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
    """Write the whole train state to `path`/state.pt, or with backend
    'orbax' to `path`/state.orbax (and config.json)."""
    check_backend(backend)
    if backend == "orbax":
        _write_orbax(Path(path), state, config)
        return
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
    if (Path(path) / "state.orbax").exists():
        shutil.rmtree(Path(path) / "state.orbax")


def _jax_state_dict(path):
    """The JAX checkpoint's state dict, or None where `path` has `state.pt`:
    `state.orbax` before `state.msgpack`, as JAX restores
    (`deep_staple_tpu/train/checkpoint.py:105-113`)."""
    path = Path(path)
    if (path / "state.pt").is_file():
        return None
    if (path / "state.orbax").is_dir():
        return read_orbax(path / "state.orbax")
    return msgpack_restore((path / "state.msgpack").read_bytes())


def restore_checkpoint(path, template_state: DeepStapleState) -> DeepStapleState:
    """Load a `save_checkpoint` file, or the JAX package's `state.orbax` or
    `state.msgpack`, into `template_state` (its model and optimizer are loaded in place, on
    their device) and return the restored state."""
    jax_tree = _jax_state_dict(path)
    if jax_tree is not None:
        from ..models.interop import state_from_jax

        model = template_state.model
        _require_jax_model(model)
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

    _require_jax_model(state.model)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / "state.msgpack.tmp"
    tmp.write_bytes(to_bytes(state_to_jax(state)))
    tmp.replace(path / "state.msgpack")
    if (path / "state.orbax").exists():  # JAX restores it before state.msgpack
        shutil.rmtree(path / "state.orbax")
    _write_config(path, config)


def restore_weights(path, model: torch.nn.Module) -> torch.Tensor | None:
    """Load the weights into `model` (strict) and return the DP vector, whose
    length is read from the file, as `deep_staple_tpu/serve.py:70` does;
    from `state.pt` or the JAX package's `state.orbax` or `state.msgpack`
    (None where that run had no data parameters)."""
    jax_tree = _jax_state_dict(path)
    if jax_tree is not None:
        from ..models.interop import load_flax_variables

        _require_jax_model(model)
        load_flax_variables(model, {"params": jax_tree["params"],
                                    "batch_stats": jax_tree["batch_stats"]})
        dp = jax_tree["dp_params"]
        return None if dp is None else torch.from_numpy(np.array(dp, np.float32))
    saved = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(saved["model"], strict=True)
    return saved["dp_params"]
