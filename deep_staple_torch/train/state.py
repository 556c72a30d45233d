"""The train state (`deep_staple_tpu/train/state.py`): the step counters,
the model with its BatchNorm buffers, its AdamW optimizer, the DP vector
and its SparseAdam state. The model's parameters and buffers are updated in
place; the DP vector and its optimizer state are replaced each step."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..models.lraspp3d import init_weights
from .optim import SparseAdamState, make_model_optimizer, sparse_adam_init


@dataclass
class DeepStapleState:
    step: int  # global batch counter
    sched_steps: int  # scheduler step counter (reference quirk :794-795)
    model: nn.Module
    optimizer: torch.optim.Optimizer
    dp_params: Optional[torch.Tensor]  # float32 (dataset_len,), the data parameters
    dp_opt_state: Optional[SparseAdamState]


def make_dp_state(dataset_len: int, init_inst_param: float = 0.0, dp_override_values=None,
                  device=None):
    """The DP vector, a constant fill as the reference's normal(init, std=0)
    (:438), or the given values, and its SparseAdam state."""
    if dp_override_values is not None:
        dp = torch.as_tensor(dp_override_values, dtype=torch.float32).reshape(-1).to(device)
        if dp.shape[0] != dataset_len:
            raise ValueError(f"{dp.shape[0]} DP values for a dataset of {dataset_len}")
    else:
        dp = torch.full((dataset_len,), float(init_inst_param), dtype=torch.float32, device=device)
    return dp, sparse_adam_init(dp)


def create_state(model: nn.Module, dataset_len: int, seed: int = 0, init_inst_param: float = 0.0,
                 use_data_params: bool = True, dp_override_values=None,
                 weight_decay: float = 0.01, device=None) -> DeepStapleState:
    """Draw `model`'s parameters from `seed` (`init_weights`) on the CPU, so
    that every device starts from the same weights, move it to `device`
    (CUDA unless "cpu" is asked for), and build the optimizers."""
    dev = resolve_device(device)
    init_weights(model.cpu(), torch.Generator().manual_seed(seed))
    model.to(dev)
    dp, dp_opt = (make_dp_state(dataset_len, init_inst_param, dp_override_values, dev)
                  if use_data_params else (None, None))
    return DeepStapleState(
        step=0, sched_steps=0, model=model,
        optimizer=make_model_optimizer(model.parameters(), weight_decay),
        dp_params=dp, dp_opt_state=dp_opt,
    )
