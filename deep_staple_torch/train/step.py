"""The train step and the eval step (`deep_staple_tpu/train/step.py`).

One `train_step` call does what the reference does per batch
(`main_deep_staple.py:673-795`), in the JAX step's order (`step.py:144-239`):

  1. augmentation on the device (`ops/augment.py`; draws from the step's
     generator unless the caller passes them),
  2. forward, class-weighted CE and an AdamW update of the model (for a
     model with deep-supervision heads, nnU-Net's `PlainConvUNet`, their
     weighted CE, `losses.deep_supervision_ce`; the DP pass and the Dice
     read the full-resolution head alone),
  3. the data-parameter (DP) pass:
       - 'strict' out-of-line: a second train-mode forward with the updated
         parameters (BatchNorm statistics advance twice, except with async
         BatchNorm, whose second forward normalizes through the statistics
         of the step's start and whose update is dropped, `step.py:194-207`),
       - 'fused' out-of-line: the CE pass's logits, detached,
       - not out-of-line: the DP loss backpropagates into the model too,
  4. SparseAdam on the DP rows of the batch (duplicates accumulate),
  5. the train Dice of the argmax against the clean augmented label.

With `use_mind` the network sees the 12 MIND-SSC channels of the image
(`_featurize`, `step.py:41-55`); with `use_2d_normal_to` the batch holds 2D
slices for the 2D model, and the eval step slices full 3D volumes along that
axis and restacks the prediction (`step.py:251-285`).

With a data group (`parallel/mesh.py`) each rank runs the step on its rows
of the global batch and the step keeps the JAX step's global-batch
semantics (GSPMD's collectives, `parallel/mesh.py:1-16`): the augmentation
and dropout draws are the global batch's, of which a rank keeps its rows;
BatchNorm moments, the CE denominator and the DP weights' mean are global
(`models/norm.py`, `train/losses.py`); the model's gradients are summed over
the ranks as one flat buffer before AdamW, and the dense DP gradient with
the touched rows before SparseAdam, so that every rank takes the same
update; the losses are summed and the Dice rows gathered. The separable
warp (K1) warps each rank's own rows, as JAX's `shard_map` does.

While `utils/tracing.py` records, a step's phases are spans:
`step.augment` (the draws where none are given, the warp, the features),
`step.forward` (the forward and its loss; the deep-supervision CE in
`step.ds_loss`, with the counter `ds_heads`, the heads whose loss was
computed), `step.backward` (the gradient of
that loss; under remat it holds the recomputed forward), `step.optimizer`
(AdamW with its collectives), `step.dp_pass` (strict OOL's second forward,
the DP loss and its gradient), `step.dp_optimizer` (SparseAdam's rows) and
`step.dice`; not out of line, the single forward is `step.forward` and the
joint gradient `step.backward`. The eval step's are `eval.resize`,
`eval.forward`, `eval.argmax` and `eval.dice`.

With a model axis as well (`parallel/tensor.py`), `data` is the data group
of this rank's model index and every sum above spans it alone: the ranks of
a model group hold the same rows, so a sum over the world would count the
replicated DP gradients M times. A sharded parameter's gradient is its
rank's slice; a replicated one's is the same on every rank of the model
group, and is taken from its model rank 0, so that replicated parameters
stay bitwise equal where the card's atomic adds (the upsampling's backward)
round otherwise.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core.config import DataParamMode, TrainConfig
from ..ops.augment import AugmentDraws, AugmentParams, augment_sample_pair, check_order, draw_augment
from ..ops.dice import dice_counts, dice_from_counts, dice_from_int_labels
from ..ops.mind import mindssc
from ..ops.resample import interpolate_sample
from ..ops.stacking import make_2d_stack_from_3d, make_3d_from_2d_stack
from ..parallel.mesh import attach_data_group
from ..parallel.spatial import SlabAxis, even_bounds, gather_slabs, slab_axes
from ..parallel.tensor import replicated_parameters
from ..utils import tracing
from .losses import deep_supervision_ce, dp_loss_fn, weighted_cross_entropy
from .optim import row_mask, set_lr, sparse_adam_update
from .state import DeepStapleState


def resolve_augment_order(order: str, num_classes: int) -> str:
    """The augment order for a dataset's class count (`step.py:71-85`): the
    '-int6' and '-sep' warps pack binary labels only and fall back to the
    matching '-int8' order for other class counts."""
    if order.endswith("-int6") and num_classes != 2:
        return order[: -len("-int6")] + "-int8"
    if order.endswith("-sep") and num_classes != 2:
        return order[: -len("-sep")] + "-int8"
    return order


def _featurize(images, use_mind: bool, use_2d: bool):
    """(B, *spatial) images -> (B, *spatial, C) channels-last network input:
    the intensity, or its 12 MIND-SSC channels (reference
    `main_deep_staple.py:691-698`); a 2D slice is a depth-1 volume to MIND."""
    if not use_mind:
        return images[..., None]
    if use_2d:
        return mindssc(images[:, None, None])[:, :, 0].movedim(1, -1)
    return mindssc(images[:, None]).movedim(1, -1)


def _swap_buffers(model, buffers):
    """Copy `buffers` (name -> tensor) into the model's buffers; return the
    values they held."""
    held = {}
    with torch.no_grad():
        for name, b in model.named_buffers():
            held[name] = b.clone()
            b.copy_(buffers[name])
    return held


def _attach_space(model, space) -> None:
    """Shard the 3D `model` over the space group `space` unless its plan is
    already that group's (the driver's models share one plan)."""
    plan = getattr(model, "space", None)
    if space is not None and (plan is None or plan.group is not space):
        from ..models.lraspp3d import attach_space_group

        attach_space_group(model, space)


def rank_draws(draws: AugmentDraws, data) -> AugmentDraws:
    """This rank's rows of the global batch's augmentation draws."""
    if data is None:
        return draws
    return AugmentDraws(*(d[data.rows(d.shape[0])] for d in draws))


def make_train_step(model, config: TrainConfig, class_weights, fixed_weighting,
                    augment_params: AugmentParams = AugmentParams(),
                    pre_interpolation_factor: float = 1.5, augment: bool = True, data=None,
                    space=None):
    """Build `train_step(state, batch, lr, generator=None, draws=None)
    -> (state, metrics)`.

    `model` runs the forward (the state's model, or a model that shares its
    parameters and buffers, `driver.make_warmup_model`); `state.optimizer`
    updates its parameters. `batch` holds, on the model's device, "image"
    (B, D, H, W) float32, "label" and "modified_label" (B, D, H, W) integers
    and "dataset_idx" (B,). `generator` (a torch.Generator on that device)
    feeds the augmentation and dropout; `draws` (`ops.augment.AugmentDraws`)
    replaces the augmentation's draws. metrics: "loss", "ce_loss",
    "dp_loss" (with data parameters), "dice" (B, num_classes), as tensors.

    `data` (a `parallel.mesh.DataGroup`) makes it a data-parallel step: the
    batch holds this rank's rows of the global batch, `draws` (if given) its
    rows of the global draws (`rank_draws`), `generator` is seeded alike on
    every rank, and the metrics are the global batch's (dice (B_global, C)).
    A model sharded by `parallel.tensor.shard_model` makes it a
    tensor-parallel step over its model group as well. `space` (a
    `parallel.mesh.SpaceGroup`) shards the 3D model's H axis over its ranks,
    which pass the same batch: the metrics stay the global batch's on every
    rank.
    """
    use_dp = config.data_param_mode == DataParamMode.INSTANCE_PARAMS
    use_2d = config.use_2d_normal_to is not None
    num_classes = len(class_weights)
    if config.ool_mode not in ("strict", "fused"):
        raise ValueError(f"ool_mode {config.ool_mode!r} (expected 'strict' or 'fused')")
    order = config.augment_order
    if (order.endswith("-int6") or order.endswith("-sep")) and num_classes != 2:
        raise ValueError(
            f"augment_order {order!r} supports binary labels only (got {num_classes} "
            "classes); use 'fast-int8' instead"
        )
    if augment:
        check_order(order)
    device = next(model.parameters()).device
    class_weights = torch.as_tensor(class_weights, dtype=torch.float32).to(device)
    fixed_weighting = torch.as_tensor(fixed_weighting, dtype=torch.float32).to(device)
    async_bn = getattr(model, "bn_mode", "batch") == "async"
    attach_data_group(model, data)
    _attach_space(model, space)
    tp = getattr(model, "tp", None)
    replicated = None if tp is None else {id(p) for p in replicated_parameters(model)}

    def total(share):
        for group in (data, space):
            share = share if group is None else group.sum(share)
        return share

    def forward(x, generator):
        return model(x, train=True, generator=generator)["out"]

    def forward_ce(x, generator, mod):
        """The train forward and the model's loss -> (full-resolution
        logits, loss, whether some parameters may take no part in it): the
        class-weighted CE, or, where the model returns deep-supervision
        heads ("aux"), their weighted CE, in which the head of weight 0
        takes no part."""
        out = model(x, train=True, generator=generator)
        if "aux" not in out:
            ce = weighted_cross_entropy(out["out"], mod, class_weights, data, space)
            return out["out"], ce, False
        with tracing.span("step.ds_loss"):
            loss, used = deep_supervision_ce([out["out"], *out["aux"]], mod, class_weights)
            tracing.count("ds_heads", used)
        return out["out"], loss, used < len(out["aux"]) + 1

    def dp_objective(dp_logits, mod, dp_vec, idxs, voxels):
        fixed = fixed_weighting[idxs] if config.use_fixed_weighting else None
        return dp_loss_fn(dp_logits, mod, dp_vec[idxs], fixed, config.use_risk_regularization,
                          data, voxels)

    def apply_grads(state, params, grads, lr):
        grads = list(grads)
        if data is not None or space is not None:
            flat = total(torch.cat([g.reshape(-1) for g in grads]))
            grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        rep = [i for i, p in enumerate(params) if id(p) in replicated] if replicated else []
        if rep:
            flat = torch.cat([grads[i].reshape(-1) for i in rep])
            dist.broadcast(flat, src=tp.group.root, group=tp.group.group)
            for i, f in zip(rep, flat.split([grads[i].numel() for i in rep])):
                grads[i] = f.view_as(grads[i])
        for p, g in zip(params, grads):
            p.grad = g
        set_lr(state.optimizer, lr)
        state.optimizer.step()
        for p in params:
            p.grad = None

    def train_step(state: DeepStapleState, batch, lr, generator=None, draws=None):
        img, lbl, mod = batch["image"], batch["label"], batch["modified_label"]
        with tracing.span("step.augment"):
            if augment:
                if draws is None:
                    shape = ((img.shape[0] * (1 if data is None else data.size),)
                             + tuple(img.shape[1:]))
                    draws = rank_draws(draw_augment(generator, shape, augment_params,
                                                    pre_interpolation_factor), data)
                img, lbl, mod, _ = augment_sample_pair(img, lbl, mod, draws, augment_params,
                                                       pre_interpolation_factor, order, use_2d)
            x = _featurize(img, config.use_mind, use_2d)
        idxs = batch["dataset_idx"].long()
        params = [p for p in model.parameters() if p.requires_grad]
        metrics = {}
        dp_grads = None
        voxels = None
        if space is not None:
            # The logits are this rank's slab of H: the labels' rows too.
            voxels = math.prod(img.shape[1:])
            rows = slab_axes(img.shape[2], space)[0]
            lbl, mod = lbl[:, :, rows.start:rows.stop], mod[:, :, rows.start:rows.stop]

        if use_dp and not config.use_ool_dp_loss:
            # One forward; the DP loss updates the model and the DP vector.
            dp_vec = state.dp_params.detach().clone().requires_grad_(True)
            with tracing.span("step.forward"):
                logits = forward(x, generator)
                dp_loss = dp_objective(logits, mod, dp_vec, idxs, voxels)
            with tracing.span("step.backward"):
                *grads, dp_grads = torch.autograd.grad(dp_loss, params + [dp_vec])
            with tracing.span("step.optimizer"):
                apply_grads(state, params, grads, lr)
            logits = logits.detach()
            with torch.no_grad():
                ce_loss = total(weighted_cross_entropy(logits, mod, class_weights, data, space))
            metrics["dp_loss"] = total(dp_loss.detach())
        else:
            strict_async = use_dp and config.ool_mode == "strict" and async_bn
            start = {n: b.clone() for n, b in model.named_buffers()} if strict_async else None
            with tracing.span("step.forward"):
                logits, ce_loss, unused = forward_ce(x, generator, mod)
            with tracing.span("step.backward"):
                # A deep-supervision head of weight 0 gets no gradient (None):
                # AdamW then skips its parameters, as nnU-Net's optimizer does.
                grads = torch.autograd.grad(ce_loss, params, allow_unused=unused)
            with tracing.span("step.optimizer"):
                apply_grads(state, params, grads, lr)
            logits, ce_loss = logits.detach(), total(ce_loss.detach())
            if use_dp:
                with tracing.span("step.dp_pass"):
                    if config.ool_mode == "strict":
                        with torch.no_grad():
                            if strict_async:
                                after = _swap_buffers(model, start)
                                dp_logits = forward(x, generator)
                                _swap_buffers(model, after)
                            else:
                                dp_logits = forward(x, generator)
                    else:
                        dp_logits = logits
                    dp_vec = state.dp_params.detach().clone().requires_grad_(True)
                    with torch.enable_grad():
                        dp_loss = dp_objective(dp_logits, mod, dp_vec, idxs, voxels)
                    (dp_grads,) = torch.autograd.grad(dp_loss, [dp_vec])
                    metrics["dp_loss"] = total(dp_loss.detach())

        dp_params, dp_opt = state.dp_params, state.dp_opt_state
        if use_dp and not config.override_embedding_weights:
            with tracing.span("step.dp_optimizer"):
                if data is None and space is None:
                    touched = row_mask(dp_params, idxs)
                else:
                    # The dense gradient and the touched rows of every rank, in
                    # one reduction.
                    hit = row_mask(dp_grads, idxs, dp_grads.dtype)
                    both = total(torch.cat([dp_grads, hit]))
                    dp_grads, touched = both[: len(hit)], both[len(hit):] > 0
                dp_params, dp_opt = sparse_adam_update(dp_params, dp_grads, dp_opt, touched,
                                                       config.lr_inst_param)

        with tracing.span("step.dice"), torch.no_grad():
            if space is None:
                metrics["dice"] = dice_from_int_labels(logits.argmax(dim=-1), lbl, num_classes)
            else:  # the slabs' integer counts, summed over the space group
                metrics["dice"] = dice_from_counts(
                    space.sum(dice_counts(logits.argmax(dim=-1), lbl, num_classes)))
            if data is not None:
                metrics["dice"] = data.gather_rows(metrics["dice"])
        metrics["ce_loss"] = ce_loss
        metrics["loss"] = metrics.get("dp_loss", ce_loss)
        state.step += 1
        state.dp_params, state.dp_opt_state = dp_params, dp_opt
        return state, metrics

    return train_step


def make_eval_step(model, config: TrainConfig, num_classes: int, eval_scale_factor: float = 2.0,
                   space=None):
    """Validation forward on full 3D volumes at the reference's x2.0 eval
    scale (`HybridIdLoader.py:336`). The 2D model sees the volume as a stack
    of slices along `use_2d_normal_to`; its argmax is restacked and scored in
    3D (reference :897-910).

    Returns `eval_step(batch) -> (pred, dice)`: `batch["image"]` (B, D, H, W)
    float32 and `batch["label"]` (B, D, H, W) int on the model's device; pred
    is the int32 argmax at the eval scale and dice (B, num_classes) float32
    against the label interpolated the same way.

    With a space group (`parallel/mesh.py::SpaceGroup`) every rank of the
    group passes the same batch: the eval-scale interpolation (whose
    align_corners=True mapping is global) and the MIND-SSC features run on
    the whole volume, the 3D model on this rank's slab of H
    (`models/lraspp3d.py::attach_space_group`), the 2D model on this rank's
    share of the slice stack (its slices are independent: no halo); the
    argmax is gathered, so that pred and dice are those of one process on
    every rank.
    """
    stack_dim = config.use_2d_normal_to
    if stack_dim is None:
        _attach_space(model, space)

    def eval_step(batch):
        with torch.inference_mode():
            with tracing.span("eval.resize"):
                img, lbl = interpolate_sample(batch["image"], batch["label"], eval_scale_factor,
                                              False)
            if stack_dim is not None:
                with tracing.span("eval.forward"):
                    stack = make_2d_stack_from_3d(img[:, None], stack_dim)[:, 0]
                    if space is not None:
                        share = SlabAxis(space, even_bounds(stack.shape[0], space.size))
                        stack = stack[share.start:share.stop]
                    logits = model(_featurize(stack, config.use_mind, True), train=False)["out"]
                with tracing.span("eval.argmax"):
                    pred2d = logits.argmax(dim=-1).to(torch.int32)
                    if space is not None:
                        pred2d = gather_slabs(pred2d, share, dim=0)
                    pred = make_3d_from_2d_stack(pred2d[:, None], stack_dim, img.shape[0])[:, 0]
            else:
                with tracing.span("eval.forward"):
                    logits = model(_featurize(img, config.use_mind, False), train=False)["out"]
                with tracing.span("eval.argmax"):
                    pred = logits.argmax(dim=-1).to(torch.int32)
                    if space is not None:
                        pred = gather_slabs(pred, model.space.axes[0])
            with tracing.span("eval.dice"):
                b_dice = dice_from_int_labels(pred, lbl, num_classes)
        return pred, b_dice

    return eval_step
