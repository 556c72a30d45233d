"""Optimizers of the model and of the data-parameter vector, and the LR
schedules (`deep_staple_tpu/train/optim.py`).

The reference optimizes the DP embedding with `torch.optim.SparseAdam`
(`main_deep_staple.py:442-444`): only rows that received a gradient this
step update their moments and values, while the bias correction counts
every step. Here the DP vector is one dense float32 tensor and a touched-row
mask reproduces those semantics (`optim.py:41-65`).

The model optimizer is `torch.optim.AdamW` with the reference's settings
(betas (0.9, 0.999), eps 1e-8, weight decay 0.01 on every parameter,
BatchNorm included, `optim.py:68-72`); its learning rate is set before each
step (`set_lr`), as the JAX step injects it (`step.py:244-248`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SparseAdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor  # int32 scalar, the global step count


def sparse_adam_init(params: torch.Tensor) -> SparseAdamState:
    return SparseAdamState(
        mu=torch.zeros_like(params),
        nu=torch.zeros_like(params),
        count=torch.zeros((), dtype=torch.int32, device=params.device),
    )


def sparse_adam_update(params, grads, state: SparseAdamState, touched_mask, lr: float,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One torch-SparseAdam step on the rows where `touched_mask` is True."""
    count = state.count + 1
    t = count.float()
    mu = torch.where(touched_mask, b1 * state.mu + (1 - b1) * grads, state.mu)
    nu = torch.where(touched_mask, b2 * state.nu + (1 - b2) * grads * grads, state.nu)
    # 1 - b**t via expm1 keeps float32 accuracy (optim.py:58-61).
    bias_c1 = -torch.expm1(t * math.log(b1))
    bias_c2 = -torch.expm1(t * math.log(b2))
    step_size = lr * torch.sqrt(bias_c2) / bias_c1
    update = step_size * mu / (torch.sqrt(nu) + eps)
    params = torch.where(touched_mask, params - update, params)
    return params, SparseAdamState(mu=mu, nu=nu, count=count)


def row_mask(like: torch.Tensor, idxs: torch.Tensor, dtype=torch.bool) -> torch.Tensor:
    """A vector shaped as `like` (the DP vector), one at the rows `idxs` and
    zero elsewhere, of `dtype`; duplicates count once. Built on `like`'s
    device with no host value: `index_fill_` passes the one as a kernel
    argument, where `mask[idxs] = True` copies it from the host and so waits
    for everything queued on the card before it."""
    return torch.zeros_like(like, dtype=dtype).index_fill_(0, idxs, 1)


def make_model_optimizer(params, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW whose learning rate the caller sets before each step."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def exp_lr(base_lr: float, num_sched_steps: int, gamma: float = 0.99) -> float:
    """torch ExponentialLR value after `num_sched_steps` scheduler steps."""
    return base_lr * (gamma**num_sched_steps)


def cosine_warm_restarts_lr(base_lr: float, num_sched_steps: int, t_0: int = 10, t_mult: int = 2,
                            eta_min: float = 0.0) -> float:
    """torch CosineAnnealingWarmRestarts(T_0, T_mult) value at integer
    scheduler steps (the 2D path, reference :410-411)."""
    t_cur = num_sched_steps
    t_i = t_0
    while t_cur >= t_i:
        t_cur -= t_i
        t_i *= t_mult
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2
