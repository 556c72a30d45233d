"""Tensor parallelism: channel-sharded convolutions over a model axis.

The counterpart of `deep_staple_tpu/parallel/tensor.py`. There a model axis
is GSPMD annotation: the leaves get column / row shardings by their module
path and XLA adds the collectives. Here a model axis of M is M ranks (one
device a rank, `parallel/mesh.py`), each holding its channel slice of every
sharded leaf as a parameter or buffer of its own, and the collectives are
explicit, Megatron's pair:

  * `copy_to_model`: the identity forward, an all-reduce of the gradient;
    on the (replicated) input of a column region: an inverted residual's
    expand conv, the ASPP's branches, the head's `ConvBN_0` and scale conv;
  * `reduce_from_model`: an all-reduce forward, the identity backward; on
    a row conv's partial output (the project conv `ConvBN_2`, the ASPP's
    `ConvBN_6`, the head's `Conv_2`), before its bias, which is added once.

The roles are JAX's (`_conv_scope_role`, `_leaf_spec`, `:56-104`), kept here
as the port's own copy and read on the port's state_dict names, which are
the Flax paths joined by dots (`models/interop.py`): a column conv's kernel
shards its output channels, with its BatchNorm vectors; a row conv's kernel
its input channels; a dim that does not divide over M stays replicated,
decided leaf by leaf. The depthwise conv between a column and a row conv
takes the column slice, so K2 and K3 run on it with no communication.

AdamW's moments shard with their parameters (`shard_train_state`); a
checkpoint holds the single-device layout, gathered over the model group
(`gather_train_state`). The ASPP's projection reads the concat of the
branches, of which a rank holds its slice of each 128-channel branch: its
kernel's local input rows are those slices, not a contiguous 1/M of 768
(`shard_plan`'s blocks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import ModelGroup

_COLUMN, _ROW, _REPL = "column", "row", "repl"
_BN_LEAVES = ("scale", "bias", "mean", "var")


def conv_scope_role(names: tuple) -> str:
    """COLUMN / ROW / replicated role of the conv scope owning a leaf
    (`deep_staple_tpu/parallel/tensor.py:56-85`)."""
    for i, n in enumerate(names):
        if n.startswith("ConvBN_"):
            parent = names[i - 1] if i > 0 else ""
            try:
                idx = int(n.split("_", 1)[1])
            except ValueError:
                return _REPL
            if parent.startswith("InvertedResidual3D"):
                return _ROW if idx == 2 else _COLUMN
            if parent == "aspp":
                return _ROW if idx == 6 else _COLUMN
            if parent == "head":
                return _COLUMN if idx == 0 else _REPL
            return _REPL
    if "head" in names:
        nxt_i = names.index("head") + 1
        nxt = names[nxt_i] if nxt_i < len(names) else ""
        if nxt == "Conv_0":  # the sigmoid gate's scale conv (16 -> 128)
            return _COLUMN
        if nxt == "Conv_2":  # the high classifier (128 -> classes)
            return _ROW
    return _REPL


def leaf_spec(names: tuple, shape, size: int) -> Optional[int]:
    """The axis of a leaf of Flax shape `shape` that shards over a model axis
    of `size`, or None (`_leaf_spec`, `:91-104`)."""
    role = conv_scope_role(names)
    leaf = names[-1] if names else ""
    if role == _COLUMN:
        if leaf == "kernel" and len(shape) == 5 and shape[4] % size == 0:
            return 4
        if leaf in _BN_LEAVES and len(shape) == 1 and shape[0] % size == 0:
            return 0
    elif role == _ROW:
        # Only the kernel's contraction dim: the bias (added once, after the
        # all-reduce) and the following BatchNorm stay replicated.
        if leaf == "kernel" and len(shape) == 5 and shape[3] % size == 0:
            return 3
    return None


def _flax_shape(names: tuple, shape) -> tuple:
    """A port leaf's shape as its Flax leaf has it (`models/interop.py`):
    conv kernels (O, I, k...) -> (k..., I, O), depthwise (27, C) ->
    (3, 3, 3, 1, C)."""
    from ..models.interop import _is_depthwise

    shape = tuple(shape)
    if names[-1] != "kernel":
        return shape
    if _is_depthwise(names):
        return (3, 3, 3, 1, shape[-1])
    return shape[2:] + (shape[1], shape[0])


def leaf_dim(key: str, shape, size: int) -> Optional[int]:
    """The dim of the port's state_dict leaf `key` (full shape `shape`) that
    shards over a model axis of `size`, or None."""
    names = tuple(key.split("."))
    ax = leaf_spec(names, _flax_shape(names, shape), size)
    if ax is None:
        return None
    if names[-1] != "kernel":  # BatchNorm vectors
        return 0
    if len(shape) == 2:  # depthwise (27, C)
        return 1
    return 0 if ax == 4 else 1  # (O, I, k, k, k): column O, row I


def count_sharded_leaves(shapes: dict, size: int) -> int:
    """How many leaves of a state_dict ({key: tensor or shape}) shard over a
    model axis of `size` (`count_sharded_leaves`, `:128-134`)."""
    return sum(leaf_dim(k, tuple(getattr(v, "shape", v)), size) is not None
               for k, v in shapes.items())


def shard_plan(shapes: dict, size: int) -> dict:
    """{key: (dim, blocks)} of the leaves that shard, from the full shapes:
    a rank holds its contiguous 1/size of each of `blocks` equal blocks of
    the dim. `blocks` is 1 but for the ASPP projection's input rows when the
    branches shard: the concat of the branches, a block each."""
    shapes = {k: tuple(getattr(v, "shape", v)) for k, v in shapes.items()}
    plan = {}
    for key, shape in shapes.items():
        dim = leaf_dim(key, shape, size)
        if dim is None:
            continue
        blocks = 1
        names = key.split(".")
        if len(names) >= 2 and names[0] == "aspp" and dim == 1 and names[-1] == "kernel":
            branch = "aspp.ConvBN_0.Conv_0.kernel"
            if branch in shapes and leaf_dim(branch, shapes[branch], size) is not None:
                blocks = shape[1] // shapes[branch][0]
        plan[key] = (dim, blocks)
    return plan


def shard_index(n: int, rank: int, size: int, blocks: int = 1) -> torch.Tensor:
    """The indices of a dim of n that rank `rank` of `size` holds: its
    contiguous 1/size of each of `blocks` equal blocks."""
    per = n // blocks
    k = per // size
    return torch.cat([torch.arange(b * per + rank * k, b * per + (rank + 1) * k)
                      for b in range(blocks)])


def shard_state_dict(sd: dict, model_rank: int, size: int, plan: Optional[dict] = None) -> dict:
    """Rank `model_rank`'s part of a single-device state_dict (or of any
    dict keyed like it, such as AdamW's moments by parameter name): each
    sharded leaf its slice, a contiguous tensor of its own; the others as
    they are. `plan` (from the full shapes) defaults to `sd`'s."""
    plan = shard_plan(sd, size) if plan is None else plan
    out = {}
    for key, t in sd.items():
        if key in plan:
            dim, blocks = plan[key]
            idx = shard_index(t.shape[dim], model_rank, size, blocks).to(t.device)
            out[key] = t.index_select(dim, idx).contiguous()
        else:
            out[key] = t
    return out


def gather_state_dict(shards: list, full_shapes: dict, plan: Optional[dict] = None) -> dict:
    """The inverse of `shard_state_dict`: the M ranks' parts, in model rank
    order, -> the single-device state_dict with `full_shapes`; replicated
    leaves are model rank 0's. `plan` defaults to `full_shapes`' (which must
    then hold every leaf, as the plan reads the ASPP's branches)."""
    size = len(shards)
    plan = shard_plan(full_shapes, size) if plan is None else plan
    out = {}
    for key, t in shards[0].items():
        if key not in plan:
            out[key] = t
            continue
        dim, blocks = plan[key]
        full = t.new_empty(tuple(full_shapes[key]))
        for r, part in enumerate(shards):
            idx = shard_index(full.shape[dim], r, size, blocks).to(t.device)
            full.index_copy_(dim, idx, part[key])
        out[key] = full
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # The ranks' parts summed in float32, rounded once (a bfloat16 sum
        # would round at each add).
        total = grad.to(torch.promote_types(grad.dtype, torch.float32),
                        memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x, a tensor replicated over the model group, as the input of that
    group's column region: the identity, whose gradient is summed over the
    group in float32 (each rank's columns give their part of it). No-op
    without a group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A row conv's partial output summed over the model group, the same
    bits on every rank; the gradient passes as it is. No-op without a
    group."""
    return x if group is None else _ReduceFromModel.apply(x, group)


@dataclass
class TensorParallel:
    """What `shard_model` attaches to a model (`model.tp`): the model group,
    the full shapes of its state_dict and the plan of its sharded leaves."""

    group: ModelGroup
    full_shapes: dict
    plan: dict


def _set_leaves(model: torch.nn.Module, tensors: dict) -> None:
    """Replace the named parameters and buffers of `model` by the given
    tensors (of any shape), each a contiguous tensor of its own."""
    for key, t in tensors.items():
        path, leaf = key.rsplit(".", 1)
        mod = model.get_submodule(path)
        with torch.no_grad():
            if leaf in mod._parameters:
                old = mod._parameters[leaf]
                mod._parameters[leaf] = torch.nn.Parameter(
                    t.detach().to(old.device).clone(memory_format=torch.contiguous_format),
                    requires_grad=old.requires_grad)
            else:
                old = mod._buffers[leaf]
                mod._buffers[leaf] = t.to(old.device).clone(memory_format=torch.contiguous_format)


def attach_model_group(model: torch.nn.Module, tp: TensorParallel) -> torch.nn.Module:
    """Give the layers of `model` (whose leaves `tp.plan` shards) their
    collectives: each column region the group for `copy_to_model` on its
    input, each row conv the group for `reduce_from_model`, and a row conv
    whose input stays replicated the indices of its local input channels.
    Also for a model that shares its leaves (`driver.make_warmup_model`)."""
    from ..models.lraspp3d import ASPP3D, Conv3d, InvertedResidual3D, LRASPPHead3D

    plan, group = tp.plan, tp.group
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, (InvertedResidual3D, ASPP3D, LRASPPHead3D)):
            mod.model_group = group.group if f"{pre}ConvBN_0.Conv_0.kernel" in plan else None
        elif isinstance(mod, Conv3d):
            key = f"{pre}kernel"
            row = key in plan and plan[key][0] == 1
            mod.row_group = group.group if row else None
            mod.in_index = None
            if row and name.startswith("aspp.") and "aspp.ConvBN_0.Conv_0.kernel" not in plan:
                # The branches stay replicated: the projection takes its rows
                # of their concat.
                mod.in_index = shard_index(tp.full_shapes[key][1], group.rank, group.size)
    model.tp = tp
    return model


def shard_model(model: torch.nn.Module, group: ModelGroup) -> torch.nn.Module:
    """In place: every leaf of `model`'s state_dict that the rules shard over
    `group.size` replaced by this rank's slice (a parameter or buffer of its
    own), and the layers given their collectives. The 3D LR-ASPP model (the
    2D model has no leaf that the rules shard and stays replicated)."""
    if getattr(model, "head_type", "lraspp") != "lraspp":
        raise NotImplementedError("tensor parallelism shards the LR-ASPP head only")
    sd = model.state_dict()
    full_shapes = {k: tuple(v.shape) for k, v in sd.items()}
    plan = shard_plan(full_shapes, group.size)
    local = shard_state_dict({k: sd[k] for k in plan}, group.rank, group.size, plan)
    _set_leaves(model, local)
    return attach_model_group(model, TensorParallel(group, full_shapes, plan))


def shard_train_state(state, group: Optional[ModelGroup]):
    """In place: the train state's model sharded (`shard_model`) and its
    AdamW rebuilt over the new parameters, with each moment this rank's
    slice of the full one. No-op without a group."""
    if group is None:
        return state
    from ..train.optim import make_model_optimizer

    names = [n for n, _ in state.model.named_parameters()]
    full = state.optimizer.state_dict()
    shard_model(state.model, group)
    plan = state.model.tp.plan
    sd = {"param_groups": full["param_groups"], "state": {}}
    for i, s in full["state"].items():
        sd["state"][i] = {k: _moment_part(names[i], v, plan, group) for k, v in s.items()}
    opt = make_model_optimizer(state.model.parameters(), full["param_groups"][0]["weight_decay"])
    opt.load_state_dict(sd)
    state.optimizer = opt
    return state


def _moment_part(name, v, plan, group):
    if name not in plan or not isinstance(v, torch.Tensor) or v.dim() == 0:
        return v
    return shard_state_dict({name: v}, group.rank, group.size, {name: plan[name]})[name]


def _gather_state_dicts(state) -> tuple:
    """-> (the model's state_dict, AdamW's state_dict), each in the
    single-device layout, on every rank of the model group (a collective:
    every rank calls it). The sharded leaves, all float32, travel as one
    flat buffer a rank (`all_gather`), so the bits are the ranks' own."""
    tp = state.model.tp
    g = tp.group
    names = [n for n, _ in state.model.named_parameters()]
    model_sd = {k: v.detach() for k, v in state.model.state_dict().items()}
    opt_sd = state.optimizer.state_dict()
    # state_dict() shares each parameter's state dict with the optimizer.
    opt_sd["state"] = {i: dict(s) for i, s in opt_sd["state"].items()}
    slots = [(("model", k), model_sd[k]) for k in tp.plan]
    for i, s in opt_sd["state"].items():
        if names[i] in tp.plan:
            slots += [(("opt", i, m), v) for m, v in s.items()
                      if isinstance(v, torch.Tensor) and v.dim() > 0]
    flat = torch.cat([t.reshape(-1).float() for _, t in slots])
    parts = [torch.empty_like(flat) for _ in range(g.size)]
    dist.all_gather(parts, flat, group=g.group)
    sizes = [t.numel() for _, t in slots]
    for (where, t), pieces in zip(slots, zip(*(p.split(sizes) for p in parts))):
        key = where[1] if where[0] == "model" else names[where[1]]
        shards = [{key: piece.view_as(t).to(t.dtype)} for piece in pieces]
        full = gather_state_dict(shards, tp.full_shapes, tp.plan)[key]
        if where[0] == "model":
            model_sd[key] = full
        else:
            opt_sd["state"][where[1]][where[2]] = full
    return model_sd, opt_sd


def gather_train_state(state, full_model: torch.nn.Module):
    """The train state in the single-device layout (a collective over the
    model group): `full_model`, an unsharded model of the same architecture,
    loaded with the gathered leaves, a new AdamW over it with the gathered
    moments, and the state's counters and DP vector. What a checkpoint
    holds; where nothing is sharded (no model group, or the 2D model),
    `state` itself."""
    if getattr(state.model, "tp", None) is None or not state.model.tp.plan:
        return state
    from ..train.optim import make_model_optimizer
    from ..train.state import DeepStapleState

    model_sd, opt_sd = _gather_state_dicts(state)
    full_model.load_state_dict(model_sd, strict=True)
    opt = make_model_optimizer(full_model.parameters(), opt_sd["param_groups"][0]["weight_decay"])
    opt.load_state_dict(opt_sd)
    return DeepStapleState(step=state.step, sched_steps=state.sched_steps, model=full_model,
                           optimizer=opt, dp_params=state.dp_params,
                           dp_opt_state=state.dp_opt_state)


def replicated_parameters(model: torch.nn.Module) -> list:
    """The parameters of a model-sharded `model` that every rank of the
    model group holds whole (those `model.tp.plan` does not shard)."""
    plan = model.tp.plan
    return [p for n, p in model.named_parameters() if n not in plan]
