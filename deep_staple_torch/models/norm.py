"""BatchNorm with the Flax parameter and statistic names, in its three modes.

The counterpart of Flax `nn.BatchNorm` ('batch') and of `AsyncBatchNorm` /
`SlabBatchNorm` (`deep_staple_tpu/models/norm.py:49-190`): parameters
`scale` and `bias`, running statistics `mean` and `var` as buffers, and for
the 'async' and 'slab' modes the `count` buffer (int32 scalar) that seeds
their first statistics update. Eval is the same in every mode
(`deep_staple_tpu/models/norm.py:28`, `:71-78`):

    y = (x - mean) * rsqrt(var + eps) * scale + bias

computed in float32 as x * mul + (bias - mean * mul), one pass, and cast
to the input dtype. Train mode, per `bn_mode`:

  * 'batch': normalize through this batch's statistics, with their
    gradient, as Flax does; var = max(0, E[x^2] - E[x]^2), biased. The
    normalization is the same one-pass x * mul + (bias - mean * mul) as in
    eval, so that autograd keeps x alone and not also x - mean.
  * 'async': normalize through the running statistics as they were before
    this call (no gradient), then update them from the batch; the first
    update (count == 0) seeds them with the batch's statistics.
  * 'slab': normalize through statistics of a D-stride-4 subsample of this
    batch (the whole batch when D < 4), without their gradient, then update
    the running statistics from them, seeded like 'async'.

Statistics are float32 means of x and x^2 over every axis but the last,
var = E[x^2] - E[x]^2, momentum 0.9. With a data group (`data`, set by
`parallel/mesh.py::attach_data_group`) the means are over the global batch
of every rank, as the JAX step's are under GSPMD: the ranks' means are
averaged, through an all-reduce that carries the gradient in 'batch' mode;
with a model axis that group is the ranks of this rank's model index, and a
BatchNorm after a column conv holds its rank's channels (`parallel/
tensor.py`), one after a row conv all of them. With a space group (`space`,
set by `models/lraspp3d.py::attach_space_group` where the input is a slab
of H) the slabs may differ by a row, so the means there are the sums over
the group (float64, with the count, through the same kind of all-reduce)
over the global count, then averaged over the data group as above; 'slab'
subsamples D, which no space group splits. The running statistics are updated in
place, once per forward: a checkpointed recomputation (`models/remat.py`)
makes no update and normalizes as the first run did.

`InstanceNorm` (nnU-Net's `PlainConvUNet`, `models/plainconvunet3d.py`)
normalizes each sample's channel over its spatial axes, through that
sample's statistics with their gradient, and keeps no running statistics:
parameters `weight` and `bias` (torch's `InstanceNorm3d(affine=True)`
names), eps 1e-5, the biased variance E[x^2] - E[x]^2 from float32 sums of
the channels-last input and of its square (the square in the input dtype),
and the same one-pass x * mul + (bias - mean * mul) as BatchNorm's, in
float32, cast to the input dtype. Train and eval are the same.
"""

from __future__ import annotations

import torch
from torch import nn

from . import remat

SLAB_STRIDE = 4


def _moments(x, data=None, space=None):
    """E[x] and E[x^2] over every axis but the last, in float32 (float64 for
    a float64 x); over the space group's slabs with a space group (their
    sums and counts summed), then over every rank's rows with a data group
    (equal row counts, so the mean of the ranks' means)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = tuple(range(x.dim() - 1))
    if space is None:
        mean, mean2 = xf.mean(axes), (xf * xf).mean(axes)
    else:
        sums = torch.stack([xf.sum(axes), (xf * xf).sum(axes)]).double()
        count = sums.new_full((1, sums.shape[1]), float(xf.numel() // xf.shape[-1]))
        tot = space.sum(torch.cat([sums, count]))
        mean, mean2 = (tot[:2] / tot[2]).to(xf.dtype).unbind(0)
    if data is None:
        return mean, mean2
    return data.mean(torch.stack([mean, mean2])).unbind(0)


class BatchNorm(nn.Module):
    """Channels-last BatchNorm over the last axis; `bn_mode` in
    ('batch', 'async', 'slab') decides whether `count` exists and the
    train-mode statistics."""

    def __init__(self, num_features: int, bn_mode: str = "batch", momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        if bn_mode not in ("batch", "async", "slab"):
            raise ValueError(f"bn_mode {bn_mode!r} (expected 'batch', 'async' or 'slab')")
        self.bn_mode = bn_mode
        self.data = None  # the data group of a data-parallel step
        self.space = None  # the space group where the input is a slab of H
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        if bn_mode in ("async", "slab"):
            self.register_buffer("count", torch.zeros((), dtype=torch.int32))

    def _affine(self, x, mean, var):
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        add = self.bias - mean * mul
        # addcmul promotes a bfloat16 x to float32: one float32 pass, then cast.
        return torch.addcmul(add, x, mul).to(x.dtype)

    @torch.no_grad()
    def _update(self, mean, var, seeded: bool):
        if remat.replaying():
            return
        m = self.momentum
        if seeded:
            m = torch.where(self.count == 0, 0.0, m)
            self.count.add_(1)
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)

    def forward(self, x, train: bool = False):
        if not train:
            return self._affine(x, self.mean, self.var)
        if self.bn_mode == "batch":
            mean, mean2 = _moments(x, self.data, self.space)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            self._update(mean.detach(), var.detach(), seeded=False)
            return self._affine(x, mean, var)
        if self.bn_mode == "async":
            # The statistics as they were before this call, kept for a
            # recomputation (the update below changes the buffers in place).
            mean, var = remat.keep(lambda: (self.mean.clone(), self.var.clone()))
            y = self._affine(x, mean, var)
            with torch.no_grad():
                b_mean, b_mean2 = _moments(x, self.data, self.space)
            self._update(b_mean, b_mean2 - b_mean * b_mean, seeded=True)
            return y
        xs = x[:, ::SLAB_STRIDE] if x.dim() == 5 and x.shape[1] >= SLAB_STRIDE else x
        with torch.no_grad():
            mean, mean2 = _moments(xs, self.data, self.space)
            var = mean2 - mean * mean
        self._update(mean, var, seeded=True)
        return self._affine(x, mean, var)


class InstanceNorm(nn.Module):
    """Channels-last InstanceNorm over every axis but the first (the
    sample) and the last (the channel), affine, no running statistics."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        axes = tuple(range(1, x.dim() - 1))
        acc = torch.promote_types(x.dtype, torch.float32)
        n = x[0, ..., 0].numel()
        # Float32 sums of a bfloat16 x read it as it is, with no float32 copy.
        mean = x.sum(axes, keepdim=True, dtype=acc) / n
        mean2 = (x * x).sum(axes, keepdim=True, dtype=acc) / n
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        add = self.bias - mean * mul
        return torch.addcmul(add, x, mul).to(x.dtype)
