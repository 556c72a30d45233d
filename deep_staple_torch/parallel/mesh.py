"""The data axis: one process a rank, one device a rank.

The counterpart of `deep_staple_tpu/parallel/mesh.py`. A JAX mesh axis
`data = N` is N devices under one jitted step, and GSPMD adds the
collectives. Here it is N ranks of a `torch.distributed` process group, each
running the step on its own rows of the global batch (`DataGroup.rows`).
The step keeps the global-batch semantics of the JAX step by reducing where
the batch couples its rows: BatchNorm moments, the class-weighted CE's
denominator, the DP weights' batch mean, the model gradients, the DP
gradient and its touched rows (`models/norm.py`, `train/losses.py`,
`train/step.py`).

Every reduction is an `all_reduce`: the two backends the port uses take it
for tensors on the card (NCCL when each rank has its own card; gloo when
ranks share one, where NCCL refuses, and on the CPU), and it gives every
rank the same bits, so that replicated state stays bitwise equal. Rows are
gathered the same way (`gather_rows`).

With a model axis (`parallel/tensor.py`) the world is a grid of D x M
ranks, rank r = d * M + m with the model index fastest, as the devices of
JAX's `make_mesh` (`deep_staple_tpu/parallel/mesh.py:29`): the data group
of a rank is the D ranks of its model index m, its model group the M ranks
of its data index d (`make_grid`). The step's sums over the batch span
the data group only; a model group's ranks hold the same rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, whose gradient is the sum of the ranks'
    gradients: the step's loss is the sum of the ranks' shares, so a rank's
    input feeds every rank's share through the sum."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclass(frozen=True)
class DataGroup:
    """This rank's place on the data axis: `size` ranks of the process group
    `group` (None: the default group), this one `rank`, on `device`, over
    `backend` ('nccl' or 'gloo')."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Optional[object] = None

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of a global batch of n rows."""
        if n % self.size:
            raise ValueError(f"global batch of {n} does not divide over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, a new tensor; differentiable (the
        gradient summed over the ranks too) when `t` requires grad."""
        if t.requires_grad:
            return _AllReduceSum.apply(t, self.group)
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of `t` over the ranks (of equal row counts)."""
        return self.sum(t) / self.size

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(n, ...) rows of every rank -> (size * n, ...) in rank order, on
        every rank: each rank's rows in a zero buffer, summed (x + 0 is x)."""
        full = t.new_zeros((t.shape[0] * self.size,) + tuple(t.shape[1:]))
        full[self.rows(full.shape[0])] = t
        dist.all_reduce(full, group=self.group)
        return full

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Overwrite `t` with rank 0's value, in place (a group that holds
        global rank 0: the world's)."""
        buf = t if t.device == self.device else t.to(self.device)
        dist.broadcast(buf, src=0, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_data_group(device) -> Optional[DataGroup]:
    """The whole world as a group of the initialized default process group,
    on this rank's `device`; None for a single process (the counterpart of
    `make_mesh`, `mesh.py:25-30`): the data group without a model axis."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None
    return DataGroup(rank=dist.get_rank(), size=dist.get_world_size(),
                     device=torch.device(device), backend=dist.get_backend())


@dataclass(frozen=True)
class ModelGroup:
    """This rank's place on the model axis (`parallel/tensor.py`): `size`
    ranks of the process group `group`, this one `rank`; `root` is the
    global rank of the group's model rank 0."""

    rank: int
    size: int
    group: object
    root: int


def make_grid(device, model_axis: int = 1):
    """-> (data group, model group) of this rank in the initialized default
    process group, the world a grid of D x M ranks, rank d * M + m: the data
    group the D ranks of this rank's m, the model group the M ranks of its
    d; either None where it holds one rank (both for a single process).
    Every rank calls it once, making every group in the same order."""
    if model_axis <= 1:
        return make_data_group(device), None
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide {world} ranks")
    D, M = world // model_axis, model_axis
    d, m = divmod(rank, M)
    data_groups = [dist.new_group([i * M + j for i in range(D)]) if D > 1 else None
                   for j in range(M)]
    model_groups = [dist.new_group([i * M + j for j in range(M)]) if D > 1 else dist.group.WORLD
                    for i in range(D)]
    data = None if D == 1 else DataGroup(rank=d, size=D, device=torch.device(device),
                                         backend=dist.get_backend(), group=data_groups[m])
    return data, ModelGroup(rank=m, size=M, group=model_groups[d], root=d * M)


def shard_batch(batch: dict, data: Optional[DataGroup]) -> dict:
    """This rank's rows of every array of a global batch (`mesh.py:44-51`);
    the whole batch without a data group."""
    if data is None:
        return batch
    return {k: v[data.rows(v.shape[0])] for k, v in batch.items()}


def attach_data_group(model: torch.nn.Module, data: Optional[DataGroup]) -> torch.nn.Module:
    """Give every module of `model` that couples the batch's rows in train
    mode (BatchNorm's moments, the ASPP's dropout mask) the data group (with
    a model axis, the ranks of this rank's model index)."""
    from ..models.lraspp3d import ASPP3D
    from ..models.norm import BatchNorm

    for mod in model.modules():
        if isinstance(mod, (BatchNorm, ASPP3D)):
            mod.data = data
    return model
