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

With a model axis (`parallel/tensor.py`) or a space axis
(`parallel/spatial.py`) the world is a grid of D x S x M ranks, rank
r = (d * S + s) * M + m with the model index fastest, as the devices of
JAX's `make_mesh` (`deep_staple_tpu/parallel/mesh.py:25-30`, reshaped to
(data, space, model)): the data group of a rank is the D ranks of its
(s, m), its space group the S ranks of its (d, m), its model group the M
ranks of its (d, s) (`make_grid`). The step's sums over the batch span the
data group and the space group: the ranks of a model group hold the same
rows, and those of a space group the same rows cut along H, so that a
rank's share of a sum is its rows' slab (`train/step.py`). The 2D model's
slices are independent: its D x S ranks are one data group
(`batch_group`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of `group` (a group below, or a stand-in with the
    same in-place `all_reduce`), whose gradient is the sum of the ranks'
    gradients: the step's loss is the sum of the ranks' shares, so a rank's
    input feeds every rank's share through the sum."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return group.all_reduce(tensor.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.clone(memory_format=torch.contiguous_format)), None


class _Sums:
    """`sum` for a group with an in-place `all_reduce`."""

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, a new tensor; differentiable (the
        gradient summed over the ranks too) when `t` requires grad."""
        if t.requires_grad:
            return _AllReduceSum.apply(t, self)
        return self.all_reduce(t.clone(memory_format=torch.contiguous_format))


@dataclass(frozen=True)
class DataGroup(_Sums):
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

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        return t

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


@dataclass(frozen=True)
class SpaceGroup(_Sums):
    """This rank's place on the space axis (`parallel/spatial.py`): `size`
    ranks of the process group `group` (None: the default group) over
    `backend`, this one `rank`; each holds a slab of every volume's H
    axis."""

    rank: int
    size: int
    group: Optional[object] = None
    backend: str = "gloo"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place (a group of one rank: `t`)."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t


def make_grid(device, model_axis: int = 1, space_axis: int = 1):
    """-> (data group, model group, space group) of this rank in the
    initialized default process group, the world a grid of D x S x M ranks,
    rank (d * S + s) * M + m: the data group the D ranks of this rank's
    (s, m), the space group the S ranks of its (d, m), the model group the
    M ranks of its (d, s); each None where it holds one rank (all three for
    a single process). Every rank calls it once, making every group in the
    same order: the data groups, then the space groups, then the model
    groups; a group of the whole world is the default group."""
    if model_axis <= 1 and space_axis <= 1:
        return make_data_group(device), None, None
    world, rank = dist.get_world_size(), dist.get_rank()
    S, M = max(space_axis, 1), max(model_axis, 1)
    if world % (S * M):
        raise ValueError(f"a space axis of {S} x a model axis of {M} does not divide {world} ranks")
    D = world // (S * M)
    d, rest = divmod(rank, S * M)
    s, m = divmod(rest, M)

    def groups(n, members):
        if n == 1:
            return {}
        return {key: (dist.new_group(ranks) if len(ranks) < world else dist.group.WORLD)
                for key, ranks in members}

    at = lambda i, j, k: (i * S + j) * M + k  # noqa: E731
    data_groups = groups(D, [((j, k), [at(i, j, k) for i in range(D)])
                             for j in range(S) for k in range(M)])
    space_groups = groups(S, [((i, k), [at(i, j, k) for j in range(S)])
                              for i in range(D) for k in range(M)])
    model_groups = groups(M, [((i, j), [at(i, j, k) for k in range(M)])
                              for i in range(D) for j in range(S)])
    backend = dist.get_backend()
    data = None if D == 1 else DataGroup(rank=d, size=D, device=torch.device(device),
                                         backend=backend, group=data_groups[(s, m)])
    space = None if S == 1 else SpaceGroup(rank=s, size=S, group=space_groups[(d, m)],
                                           backend=backend)
    model = None if M == 1 else ModelGroup(rank=m, size=M, group=model_groups[(d, s)],
                                           root=at(d, s, 0))
    return data, model, space


def batch_group(device, model_axis: int = 1) -> Optional[DataGroup]:
    """The D x S ranks of this rank's model index in the grid of
    `make_grid` as one data group, rank d * S + s (None for one rank): the
    2D model's slices are independent, so a space axis splits the batch's
    rows as the data axis does. Every rank calls it, after `make_grid`,
    making the M groups in the same order; with no model axis the group is
    the whole world."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    M = max(model_axis, 1)
    n = world // M
    if n == 1:
        return None
    q, m = divmod(rank, M)
    groups = [dist.group.WORLD if M == 1 else dist.new_group([i * M + k for i in range(n)])
              for k in range(M)]
    return DataGroup(rank=q, size=n, device=torch.device(device), backend=dist.get_backend(),
                     group=None if M == 1 else groups[m])


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
