"""Determinism helpers (`deep_staple_tpu/core/determinism.py`).

The reference resets the torch, numpy and random global seeds before data
preparation and training (`utils/torch_utils.py:364-368`). The host-side
numpy stream drives the driver's split draws: the disturbed indices and the
epoch permutations. Device draws come from explicit `torch.Generator`s.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def reset_determinism(seed: int = 0):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def seeded_rng(seed: int) -> np.random.RandomState:
    """Per-index deterministic RNG (mirrors `torch_manual_seeded(idx)` usage,
    `HybridIdLoader.py:407`)."""
    return np.random.RandomState(seed)
