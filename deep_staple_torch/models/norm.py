"""BatchNorm with the Flax parameter and statistic names.

The counterpart of Flax `nn.BatchNorm` and of `AsyncBatchNorm` /
`SlabBatchNorm` (`deep_staple_tpu/models/norm.py`): parameters `scale` and
`bias`, running statistics `mean` and `var` as buffers, and for the 'async'
and 'slab' modes the `count` buffer (int32 scalar) that seeds their first
statistics update. Eval is the same in every mode
(`deep_staple_tpu/models/norm.py:28`, `:71-78`):

    y = (x - mean) * rsqrt(var + eps) * scale + bias

computed in float32 as x * mul + (bias - mean * mul), one pass, and cast
to the input dtype. The train-mode statistics update comes with the
training slice.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Channels-last BatchNorm over the last axis; `bn_mode` in
    ('batch', 'async', 'slab') decides only whether `count` exists and, in a
    later slice, the train-mode statistics."""

    def __init__(self, num_features: int, bn_mode: str = "batch", momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        if bn_mode not in ("batch", "async", "slab"):
            raise ValueError(f"bn_mode {bn_mode!r} (expected 'batch', 'async' or 'slab')")
        self.bn_mode = bn_mode
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        if bn_mode in ("async", "slab"):
            self.register_buffer("count", torch.zeros((), dtype=torch.int32))

    def forward(self, x, train: bool = False):
        if train:
            raise NotImplementedError(
                "train-mode BatchNorm statistics come with the training slice"
            )
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        add = self.bias - self.mean * mul
        # addcmul promotes a bfloat16 x to float32: one float32 pass, then cast.
        return torch.addcmul(add, x, mul).to(x.dtype)
