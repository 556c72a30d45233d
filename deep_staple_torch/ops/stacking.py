"""2D-stack <-> 3D-volume reshaping of the 2D path's validation
(`deep_staple_tpu/ops/stacking.py`, after `deep_staple/utils/torch_utils.py:281-321`)."""

from __future__ import annotations

_STACK_AXES = {"D": 2, "H": 3, "W": 4}


def _check_dim(stack_dim: str):
    if stack_dim not in _STACK_AXES:
        raise ValueError(f"stack_dim '{stack_dim}' must be 'D' or 'H' or 'W'.")


def get_2d_stack_batch_size(b_input_shape, stack_dim: str) -> int:
    assert len(b_input_shape) == 5, f"Input size must be 5D: BxCxDxHxW but is {b_input_shape}"
    _check_dim(stack_dim)
    return b_input_shape[0] * b_input_shape[_STACK_AXES[stack_dim]]


def make_2d_stack_from_3d(b_input, stack_dim: str):
    """(B, C, D, H, W) -> (B * S, C, *the other two axes), S the extent
    along `stack_dim`."""
    assert b_input.dim() == 5, f"Input must be 5D: BxCxDxHxW but is {tuple(b_input.shape)}"
    _check_dim(stack_dim)
    B, C = b_input.shape[:2]
    axis = _STACK_AXES[stack_dim]
    rest = [a for a in (2, 3, 4) if a != axis]
    stack = b_input.permute(0, axis, 1, *rest)
    return stack.reshape((B * b_input.shape[axis], C) + tuple(b_input.shape[a] for a in rest))


def make_3d_from_2d_stack(b_input, stack_dim: str, orig_stack_size: int):
    """The inverse of `make_2d_stack_from_3d`, `orig_stack_size` being B."""
    assert b_input.dim() == 4, f"Input must be 4D: (B*S)xCxSPAT1xSPAT0 but is {tuple(b_input.shape)}"
    _check_dim(stack_dim)
    BS, C, S1, S0 = b_input.shape
    b_input = b_input.reshape(orig_stack_size, BS // orig_stack_size, C, S1, S0)
    order = {"D": (0, 2, 1, 3, 4), "H": (0, 2, 3, 1, 4), "W": (0, 2, 3, 4, 1)}[stack_dim]
    return b_input.permute(*order)
