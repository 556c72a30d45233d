"""Label fault injection ("disturbance", `deep_staple_tpu/data/disturbance.py`).

Re-implements `HybridIdLoader.disturb_idxs` (:376-444): a chosen subset of
training labels is corrupted on purpose, to check that data parameters find
corrupted samples (`main_deep_staple.py:564-587`). Two modes:

  * FLIP_ROLL: an axis transpose and a random integer roll (:408-428), drawn
    from `np.random.RandomState(seed)`: the same numbers and labels as the
    JAX package;
  * AFFINE: a strong random affine warp (:430-436), affine strength
    0.09 * s and translation 0.18 * s, no b-spline, nearest with zero
    padding; in 2D a 2D affine of the slice (`disturbance.py:35-53`). The
    draws come from a CPU `torch.Generator` seeded by `seed` through the
    port's `ops/augment.py` (`draw_augment`), the warp is
    `warp_nearest_zeros` or, in 2D, `grid_sample_2d`; the distribution is
    JAX's, the numbers are not. `draws=` takes the draws instead (a test
    feeds JAX's).

Per-index determinism comes from seeding with the dataset index (the
reference's `torch_manual_seeded(idx)`, :407). Runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import LabelDisturbanceMode


def affine_params(strength: float):
    from ..ops.augment import AugmentParams

    return AugmentParams(
        bspline_num_ctl_points=6,
        bspline_strength=0.0,
        bspline_probability=0.0,
        affine_strength=0.09 * strength,
        add_affine_translation=0.18 * strength,
        affine_probability=1.0,
    )


def disturb_label(label: np.ndarray, mode, strength: float, seed: int, use_2d: bool = False,
                  draws=None):
    rng = np.random.RandomState(seed)
    if str(mode) == str(LabelDisturbanceMode.FLIP_ROLL):
        roll_strength = 10.0 * strength
        if use_2d:
            rolled = np.swapaxes(label, -2, -1)
            shifts = (int(rng.randn() * roll_strength), int(rng.randn() * roll_strength))
            return np.roll(rolled, shifts, axis=(-2, -1))
        rolled = np.transpose(label, (1, 2, 0))
        shifts = tuple(int(rng.randn() * roll_strength) for _ in range(3))
        return np.roll(rolled, shifts, axis=(-3, -2, -1))

    if str(mode) == str(LabelDisturbanceMode.AFFINE):
        from ..ops.augment import draw_augment, make_augment_grid, warp_nearest_zeros
        from ..ops.grid_sample import grid_sample_2d

        vol = torch.from_numpy(np.asarray(label)[None].astype(np.float32))
        if draws is None:
            gen = torch.Generator().manual_seed(int(seed))
            draws = draw_augment(gen, tuple(vol.shape), affine_params(strength), 1.0)
        grid = make_augment_grid(draws, tuple(vol.shape[1:]))
        if use_2d:
            out = grid_sample_2d(vol[:, None], grid, "nearest", "zeros")[:, 0]
        else:
            out = warp_nearest_zeros(vol, grid)
        return out[0].numpy().astype(label.dtype)

    raise ValueError(f"Disturbance mode {mode} is not implemented.")
