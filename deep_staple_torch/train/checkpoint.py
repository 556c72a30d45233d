"""The port's checkpoint: a directory with `config.json` and `state.pt`.

`state.pt` holds {"model": model state_dict, "dp_params": float32 DP vector},
written with `torch.save`. The JAX package's flax msgpack / orbax checkpoints
are not read here; `models/interop.py` carries weights across instead.
The optimizer states join the file with the training slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..core.config import TrainConfig


def save_checkpoint(path, model: torch.nn.Module, dp_params, config: TrainConfig | None = None):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if not isinstance(dp_params, torch.Tensor):
        dp_params = torch.from_numpy(np.array(dp_params, np.float32))
    state = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "dp_params": dp_params.detach().cpu().float().reshape(-1),
    }
    tmp = path / "state.pt.tmp"
    torch.save(state, tmp)
    tmp.replace(path / "state.pt")
    if config is not None:
        (path / "config.json").write_text(json.dumps(config.to_dict(), indent=2, default=str))


def load_config(path) -> TrainConfig:
    return TrainConfig.from_dict(json.loads((Path(path) / "config.json").read_text()))


def restore_checkpoint(path, model: torch.nn.Module) -> torch.Tensor:
    """Load the weights into `model` (strict) and return the DP vector, whose
    length is read from the file, as `deep_staple_tpu/serve.py:70` does."""
    state = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    return state["dp_params"]
