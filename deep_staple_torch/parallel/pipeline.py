"""Pipeline parallelism: GPipe over the model's natural two-stage cut.

The counterpart of `deep_staple_tpu/parallel/pipeline.py`. The stage cut is
the reference's own checkpoint segments (`MobileNet_LR_ASPP_3D.py:206-232`):

  stage 0 (devices[0]): him (blocks 0-1) + lom (blocks 2-9)  - x -> (high, low)
  stage 1 (devices[1]): aspp + head + the final float32 upsample - (high, low) -> logits

Both stages are views over the model's own submodules under their names
(`PipelineStage0`, `PipelineStage1`), so a stage's state-dict keys are a
slice of the model's (`split_variables` / `merge_variables`) and a
checkpoint loads either way.

`GPipe2.run` is the schedule. Every stage-0 forward runs first, without a
graph, and only the stage inputs are kept; then, a microbatch at a time,
stage 1's forward and backward (its parameters' gradients and the
cotangents of high and low), the cotangents sent back to stage 0's device,
and stage 0 recomputed with a graph and its VJP applied. The recomputation
replays the first run (`models/remat.py::record`): no second BatchNorm
update, async BatchNorm normalizing through the statistics it used. CUDA
launches are asynchronous per device, so with two cards stage 0 of later
microbatches runs while stage 1 works on earlier ones, as JAX's
per-device dispatch does.

With `n_micro` > 1, gradients are exact sums over the microbatches, and
BatchNorm's running statistics follow parallel-accumulation semantics:
each microbatch updates from the same initial statistics, then the updates
are averaged - not the serially-threaded statistics of a sequential loop
(JAX's rule, `pipeline.py:36-42`, with the same warning).

`make_pp_train_step` is the whole DeepSTAPLE step on the two stages, with
`train/step.py::make_train_step`'s contract: augmentation on stage 0's
device, the class-weighted CE of each microbatch over the global
denominator (so the sum over microbatches is the batch's CE and gradient),
AdamW on each stage's parameters on its device (element-wise, so the split
cannot change the update), the strict or fused out-of-line DP pass over the
full batch on stage 1 (its batch-mean weights do not decompose over
microbatches), SparseAdam, and the train Dice. With `n_micro` 1 it is the
fused step's arithmetic, draw for draw.
"""

from __future__ import annotations

import warnings

import torch
from torch import nn

from ..models import remat

STAGE0_KEYS = ("him", "lom")
STAGE1_KEYS = ("aspp", "head")


class PipelineStage0(nn.Module):
    """him + lom of a `MobileNetLRASPP3D`: its own submodules, so a view of
    its parameters and buffers (`lraspp3d.py:396-397` glue)."""

    def __init__(self, model):
        super().__init__()
        self.him, self.lom = model.him, model.lom
        self._forward = model.stage0

    def forward(self, x, train: bool = False):
        return self._forward(x, train)


class PipelineStage1(nn.Module):
    """aspp + head + the final float32 upsample to `out_spatial`
    (`lraspp3d.py:398-407` glue)."""

    def __init__(self, model):
        super().__init__()
        self.aspp, self.head = model.aspp, model.head
        self._forward = model.stage1

    def forward(self, high, low, out_spatial, train: bool = False, generator=None):
        return self._forward(high, low, out_spatial, train, generator)


def split_variables(state_dict: dict):
    """A model's state dict -> (stage 0's, stage 1's), by key."""
    pick = lambda keys: {k: v for k, v in state_dict.items() if k.split(".")[0] in keys}
    return pick(STAGE0_KEYS), pick(STAGE1_KEYS)


def merge_variables(sd0: dict, sd1: dict) -> dict:
    """Inverse of `split_variables`, in the model's key order."""
    return {**sd0, **sd1}


def stage_devices(device) -> list:
    """The stages' devices for a run on `device`: stage i on `cuda:(i mod
    visible cards)`, so both on one card where there is one; both on the
    CPU for a CPU run."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device, device]
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(2)]


def _move(state, modules, device):
    """Move `modules` and the optimizer state of their parameters."""
    for mod in modules:
        for p in mod.parameters():
            st = state.optimizer.state.get(p, {})
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and v.device == p.device:
                    st[k] = v.to(device)
        mod.to(device)


def place_model(state, device):
    """The whole model, its optimizer state and the DP state on `device`
    (after an epoch of pipelined steps, for validation, checkpoints and the
    snapshot); nothing moves where all is there already."""
    device = torch.device(device)
    _move(state, [state.model], device)
    if state.dp_params is not None and state.dp_params.device != device:
        state.dp_params = state.dp_params.to(device)
        state.dp_opt_state = type(state.dp_opt_state)(*(t.to(device) for t in state.dp_opt_state))
    return state


def _buffers(module) -> dict:
    return {n: b.clone() for n, b in module.named_buffers()}


@torch.no_grad()
def _load_buffers(module, buffers: dict):
    for n, b in module.named_buffers():
        b.copy_(buffers[n])


@torch.no_grad()
def _mean_buffers(module, runs: list):
    """Each buffer <- its mean over the microbatches' updates."""
    for n, b in module.named_buffers():
        total = sum(r[n].double() for r in runs)
        b.copy_((total / len(runs)).to(b.dtype))


class GPipe2:
    """Two-stage GPipe runner for a `MobileNetLRASPP3D`: stage i's
    submodules on `devices[i]` (two torch.devices, possibly the same)."""

    def __init__(self, model, devices):
        if len(devices) < 2:
            raise ValueError("GPipe2 needs 2 devices (they may be the same)")
        self.model = model
        self.d0, self.d1 = torch.device(devices[0]), torch.device(devices[1])
        self.stage0, self.stage1 = PipelineStage0(model), PipelineStage1(model)
        self._bn_semantics_warned = False

    def _micro(self, x, n_micro: int):
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} not divisible by {n_micro} microbatches")
        if n_micro > 1 and not self._bn_semantics_warned:
            warnings.warn(
                "GPipe2: with n_micro > 1, BatchNorm running statistics follow "
                "parallel-accumulation semantics (each microbatch updates from the same "
                "initial statistics, then the updates are averaged), not the serially-"
                "threaded statistics of a sequential loop. Gradients are exact.",
                stacklevel=3)
            self._bn_semantics_warned = True
        m = x.shape[0] // n_micro
        return [x[i * m:(i + 1) * m].to(self.d0) for i in range(n_micro)]

    def _stage0_all(self, xs):
        """Every microbatch's stage-0 forward, without a graph; -> [(high,
        low, replay)] and each one's BatchNorm buffers (n_micro > 1)."""
        start = _buffers(self.stage0) if len(xs) > 1 else None
        outs, bufs = [], []
        for xi in xs:
            if start is not None:
                _load_buffers(self.stage0, start)
            with torch.no_grad():
                (high, low), replay = remat.record(self.stage0, xi, True)
            outs.append((high, low, replay))
            if start is not None:
                bufs.append(_buffers(self.stage0))
        return outs, bufs

    def run(self, x, n_micro: int, stage1_loss, generator=None):
        """Pipelined forward and backward over n_micro microbatches of the
        network input x (B, D, H, W, C). `stage1_loss(i, logits)` -> the loss
        of microbatch i (on stage 1's device); the step's loss is their sum.

        -> (losses, logits, grads): per microbatch its loss and its logits
        (detached), and the gradient of the summed loss for each trainable
        parameter in `model.parameters()` order. BatchNorm buffers end at
        their parallel-accumulation means."""
        xs = self._micro(x, n_micro)
        out_spatial = tuple(x.shape[1:4])
        params0 = [p for p in self.stage0.parameters() if p.requires_grad]
        params1 = [p for p in self.stage1.parameters() if p.requires_grad]
        start1 = _buffers(self.stage1) if n_micro > 1 else None
        f0, bufs0 = self._stage0_all(xs)
        losses, logits, bufs1 = [], [], []
        g0 = g1 = None
        for i in range(n_micro):
            high, low, replay = f0[i]
            f0[i] = None  # stage 0 keeps only its inputs between the phases
            h1 = high.detach().to(self.d1).requires_grad_(True)
            l1 = low.detach().to(self.d1).requires_grad_(True)
            if start1 is not None:
                _load_buffers(self.stage1, start1)
            with torch.enable_grad():
                out = self.stage1(h1, l1, out_spatial, True, generator)
                loss = stage1_loss(i, out)
            *gp1, gh, gl = torch.autograd.grad(loss, params1 + [h1, l1])
            if start1 is not None:
                bufs1.append(_buffers(self.stage1))
            # The cotangents back to stage 0's device; stage 0 recomputed.
            with torch.enable_grad():
                high0, low0 = replay(xs[i], True)
                gp0 = torch.autograd.grad((high0, low0), params0,
                                          (gh.to(self.d0), gl.to(self.d0)))
            g0 = list(gp0) if g0 is None else [a + b for a, b in zip(g0, gp0)]
            g1 = list(gp1) if g1 is None else [a + b for a, b in zip(g1, gp1)]
            losses.append(loss.detach())
            logits.append(out.detach())
        if n_micro > 1:
            _mean_buffers(self.stage0, bufs0)
            _mean_buffers(self.stage1, bufs1)
        return losses, logits, g0 + g1

    @torch.no_grad()
    def forward(self, x, n_micro: int, generator=None):
        """The pipelined train-mode forward alone -> logits (B, ...) on stage
        1's device; BatchNorm buffers as in `run`."""
        xs = self._micro(x, n_micro)
        out_spatial = tuple(x.shape[1:4])
        start1 = _buffers(self.stage1) if n_micro > 1 else None
        f0, bufs0 = self._stage0_all(xs)
        logits, bufs1 = [], []
        for high, low, _ in f0:
            if start1 is not None:
                _load_buffers(self.stage1, start1)
            logits.append(self.stage1(high.to(self.d1), low.to(self.d1), out_spatial, True,
                                      generator))
            if start1 is not None:
                bufs1.append(_buffers(self.stage1))
        if n_micro > 1:
            _mean_buffers(self.stage0, bufs0)
            _mean_buffers(self.stage1, bufs1)
        return torch.cat(logits, 0)

    def loss_and_grads(self, loss_fn, x, labels, generator=None, n_micro: int = 1):
        """`loss_fn(logits, labels)` averaged over microbatches -> (loss,
        grads): sequential gradient accumulation's loss and gradients."""
        m = x.shape[0] // n_micro
        labels = labels.to(self.d1)
        losses, _, grads = self.run(
            x, n_micro, lambda i, out: loss_fn(out, labels[i * m:(i + 1) * m]) / n_micro,
            generator)
        return sum(losses), grads

    def train_step(self, optimizer, loss_fn, x, labels, generator=None, n_micro: int = 1):
        """`loss_and_grads`, then one step of `optimizer` over the model's
        parameters, each updated on its stage's device. -> the loss."""
        loss, grads = self.loss_and_grads(loss_fn, x, labels, generator, n_micro)
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        for p in params:
            p.grad = None
        return loss


def make_pp_train_step(model, config, class_weights, fixed_weighting, augment_params=None,
                       pre_interpolation_factor: float = 1.5, augment: bool = True,
                       n_micro: int = 1, devices=None):
    """The pipelined drop-in for `train/step.py::make_train_step`
    (`config.mesh_pipe_stages=2`): `step(state, batch, lr, generator=None,
    draws=None) -> (state, metrics)` on the same `DeepStapleState`, the
    model's stage 0 on `devices[0]` and stage 1 on `devices[1]`
    (`stage_devices`). The batch arrives on stage 0's device; the DP vector
    and stage 1 live on stage 1's. Raises for the 2D model and for the
    non-out-of-line DP loss, whose batch-coupled weights backpropagate into
    the model and do not decompose over microbatches (`pipeline.py:
    410-415`)."""
    from ..core.config import DataParamMode
    from ..ops.augment import AugmentParams, augment_sample_pair, check_order, draw_augment
    from ..ops.dice import dice_from_int_labels
    from ..train.losses import _nll, dp_loss_fn
    from ..train.optim import row_mask, set_lr, sparse_adam_update
    from ..train.step import _featurize, _swap_buffers

    augment_params = augment_params or AugmentParams()
    use_dp = config.data_param_mode == DataParamMode.INSTANCE_PARAMS
    if config.use_2d_normal_to is not None:
        raise ValueError("pipeline parallelism supports the 3D model only")
    if use_dp and not config.use_ool_dp_loss:
        raise ValueError(
            "pipeline parallelism requires use_ool_dp_loss=True (the non-OOL DP loss "
            "backprops its batch-coupled weight normalization into the model, which does "
            "not decompose over microbatches)")
    if config.ool_mode not in ("strict", "fused"):
        raise ValueError(f"ool_mode {config.ool_mode!r} (expected 'strict' or 'fused')")
    if augment:
        check_order(config.augment_order)
    if devices is None:
        devices = stage_devices(next(model.parameters()).device)
    pipe = GPipe2(model, devices)
    d0, d1 = pipe.d0, pipe.d1
    num_classes = len(class_weights)
    class_weights = torch.as_tensor(class_weights, dtype=torch.float32).to(d1)
    fixed_weighting = torch.as_tensor(fixed_weighting, dtype=torch.float32).to(d1)
    strict_async = (use_dp and config.ool_mode == "strict"
                    and getattr(model, "bn_mode", "batch") == "async")
    params = [p for p in model.parameters() if p.requires_grad]

    def pp_train_step(state, batch, lr, generator=None, draws=None):
        # Stage 1 and the DP state on stage 1's device (a no-op after the
        # first step of an epoch; the driver gathers them after it).
        _move(state, [pipe.stage1], d1)
        if state.dp_params is not None and state.dp_params.device != d1:
            state.dp_params = state.dp_params.to(d1)
            state.dp_opt_state = type(state.dp_opt_state)(*(t.to(d1) for t in state.dp_opt_state))
        img, lbl, mod = (batch[k].to(d0) for k in ("image", "label", "modified_label"))
        if augment:
            if draws is None:
                draws = draw_augment(generator, img.shape, augment_params,
                                     pre_interpolation_factor)
            img, lbl, mod, _ = augment_sample_pair(img, lbl, mod, draws, augment_params,
                                                   pre_interpolation_factor,
                                                   config.augment_order, False)
        x = _featurize(img, config.use_mind, False)
        m = x.shape[0] // n_micro
        mod1, lbl1 = mod.to(d1), lbl.to(d1)
        w1 = class_weights[mod1.long()]
        denom = w1.sum()

        def ce_share(i, logits):
            # The microbatch's CE numerator over the batch's denominator:
            # the shares sum to the batch's CE, and so do their gradients.
            sl = slice(i * m, (i + 1) * m)
            return (_nll(logits, mod1[sl]) * w1[sl]).sum() / denom

        start = _buffers(model) if strict_async else None
        losses, logits_mb, grads = pipe.run(x, n_micro, ce_share, generator)
        for p, g in zip(params, grads):
            p.grad = g
        set_lr(state.optimizer, lr)
        state.optimizer.step()
        for p in params:
            p.grad = None
        logits = torch.cat(logits_mb, 0)
        ce_loss = torch.stack(losses).sum()
        metrics = {}
        if use_dp:
            if config.ool_mode == "strict":
                # The second pipelined forward with the updated parameters;
                # async BatchNorm normalizes through the step's starting
                # statistics there and keeps the first forward's update.
                if strict_async:
                    after = _swap_buffers(model, start)
                    dp_logits = pipe.forward(x, n_micro, generator)
                    _swap_buffers(model, after)
                else:
                    dp_logits = pipe.forward(x, n_micro, generator)
            else:
                dp_logits = logits
            idxs = batch["dataset_idx"].to(d1).long()
            dp_vec = state.dp_params.detach().clone().requires_grad_(True)
            with torch.enable_grad():
                fixed = fixed_weighting[idxs] if config.use_fixed_weighting else None
                dp_loss = dp_loss_fn(dp_logits, mod1, dp_vec[idxs], fixed,
                                     config.use_risk_regularization)
            (dp_grads,) = torch.autograd.grad(dp_loss, [dp_vec])
            metrics["dp_loss"] = dp_loss.detach()
            if not config.override_embedding_weights:
                touched = row_mask(state.dp_params, idxs)
                state.dp_params, state.dp_opt_state = sparse_adam_update(
                    state.dp_params, dp_grads, state.dp_opt_state, touched, config.lr_inst_param)
        with torch.no_grad():
            metrics["dice"] = dice_from_int_labels(logits.argmax(dim=-1), lbl1, num_classes)
        metrics["ce_loss"] = ce_loss
        metrics["loss"] = metrics.get("dp_loss", ce_loss)
        state.step += 1
        return state, metrics

    return pp_train_step
