"""The first training steps in plain PyTorch, from the raw dataset the
benchmark wrote and the weights it made: the instances' preprocessing, the
class weights and fixed weighting, the augmentation, the model's forward
and backward, the class-weighted CE, the out-of-line data-parameter (DP)
pass with its risk regularisation, AdamW on the model and SparseAdam on the
DP vector (DeepSTAPLE, Weihsbach et al., WBIR 2022;
`main_deep_staple.py:673-795` of the published code).

The instance order is the dataset's: case after case, each case's atlases in
order (the DP vector's rows). The rows of each step are the ones the
program's loop chose; everything computed from them is worked out here
again.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import archs
from . import augment
from .model import update_stats

BETAS, ADAM_EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 0.01
EVAL_SCALE = 2.0


def instances(host: dict, idxs, device):
    """The rows `idxs` -> (image z-normalised float32, label, modified label)
    (B, D, H, W) on `device`."""
    A = host["atlases"].shape[1]
    cases = [int(i) // A for i in idxs]
    img = torch.from_numpy(np.stack([host["images"][c] for c in cases])).to(device)
    d = img.double()
    mean = d.mean(dim=(1, 2, 3), keepdim=True)
    std = ((d - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
    img = ((d - mean) / std).float()
    lbl = torch.from_numpy(np.stack([host["labels"][c] for c in cases])).to(device).long()
    mod = torch.from_numpy(np.stack([host["atlases"][int(i) // A, int(i) % A] for i in idxs]))
    return img, lbl, mod.to(device).long()


def sample_weights(host: dict, train_idxs, num_classes: int, device, chunk: int = 8):
    """-> (class weights (C,), fixed weighting (rows,)) float32: the class
    weights 1 / count^0.35 over the modified labels at the eval scale, over
    their mean; the fixed weighting log(foreground voxels + e) + e."""
    N, A = host["atlases"].shape[:2]
    counts = torch.zeros(num_classes, dtype=torch.float64, device=device)
    fixed = torch.zeros(N * A, dtype=torch.float64, device=device)
    idxs = [int(i) for i in train_idxs]
    for s in range(0, len(idxs), chunk):
        part = idxs[s:s + chunk]
        _, _, mod = instances(host, part, device)
        mod = augment.up_labels(mod, EVAL_SCALE)
        counts += torch.bincount(mod.reshape(-1), minlength=num_classes)[:num_classes].double()
        fixed[part] = (mod > 0).reshape(len(part), -1).sum(dim=1).double()
    cw = 1.0 / counts.pow(0.35)
    cw = cw / cw.mean()
    fixed = torch.log(fixed + math.e) + math.e
    return cw.float(), fixed.float()


def _nll(logits, target):
    return -F.log_softmax(logits, dim=1).gather(1, target[:, None])[:, 0]


def dp_loss(logits, target, dp_rows, fixed_rows, risk: bool):
    """sum over the batch of the voxel-mean CE weighted by sigmoid(DP) over
    its batch mean and the fixed weighting, minus the risk term."""
    B = logits.shape[0]
    ce = _nll(logits, target).reshape(B, -1).mean(dim=1)
    w = torch.sigmoid(dp_rows)
    w = w / w.mean()
    if fixed_rows is not None:
        w = w / fixed_rows
    loss = (ce * w).sum()
    if risk:
        pred = logits.detach().argmax(dim=1)
        share = (pred > 0).reshape(B, -1).sum(dim=1).float() / float(pred[0].numel())
        loss = loss - (w * share).sum()
    return loss


class AdamW:
    """torch.optim.AdamW's update, written out: decoupled weight decay, then
    the bias-corrected moments."""

    def __init__(self, params: dict):
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float):
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - lr * WEIGHT_DECAY)
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + ADAM_EPS))


def sparse_adam(dp, grad, mu, nu, t: int, touched, lr: float):
    """torch.optim.SparseAdam on the rows `touched`; the bias correction
    counts every step."""
    b1, b2 = BETAS
    mu = torch.where(touched, b1 * mu + (1 - b1) * grad, mu)
    nu = torch.where(touched, b2 * nu + (1 - b2) * grad * grad, nu)
    step = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    dp = torch.where(touched, dp - step * mu / (nu.sqrt() + ADAM_EPS), dp)
    return dp, mu, nu


def precision(tf32: bool):
    """Set float32 matmuls and convolutions to TF32 or full float32; ->
    the previous setting, for `restore`."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return prev


def restore(prev):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _lrs(settings: dict, calls: int, per_epoch: int, atlas_count: int) -> list:
    """Each call's learning rate: ExponentialLR(0.99) stepped after every
    batch of the epochs whose index is a multiple of the atlas count, the
    published loop's quirk (`main_deep_staple.py:794-795`)."""
    out, sched = [], 0
    for k in range(calls):
        out.append(settings["lr"] * 0.99 ** sched)
        if settings["use_scheduling"] and (k // per_epoch) % atlas_count == 0:
            sched += 1
    return out


def run_steps(arch: dict, settings: dict, host: dict, rows: list, params0: dict, seed: int,
              train_idxs, device, quant=None, checked: int = 3) -> dict:
    """The steps of a run from `params0`, one a list of rows in `rows`.
    settings: the configuration's training settings. Under async BatchNorm
    the first `bn_warmup_epochs` epochs run slab BatchNorm, and `rows`
    holds those epochs' steps and then `checked` async ones; otherwise
    `checked` steps. -> {"losses": [(ce, dp) a step of the first
    `checked`], "grads": {leaf: the first step's gradient}, "params": {leaf:
    after the first `checked` steps}}, the DP vector as the leaf
    "dp_params"; under async BatchNorm also "async": {"losses": the async
    steps', "grads": the first async step's gradient, "before": {leaf:
    after the warm-up}, "params": {leaf: after the async steps}}. An
    architecture with a `run_steps` of its own runs its steps there
    instead."""
    module = archs.load(arch)
    if hasattr(module, "run_steps"):
        return module.run_steps(arch, settings, host, rows, params0, seed, train_idxs, device,
                                quant=quant, checked=checked)
    Net = module.Net
    order = settings["augment_order"]
    strict = settings["ool_mode"] == "strict"
    factor = float(settings["pre_interpolation_factor"])
    num_classes, rate = arch["num_classes"], arch["dropout_rate"]
    per_epoch = math.ceil(len(train_idxs) / int(settings["batch_size"]))
    warm = 0
    if settings["bn_mode"] == "async":
        warm = int(settings["bn_warmup_epochs"]) * per_epoch
        if strict:
            raise ValueError("the reference runs async BatchNorm with the fused DP pass only")
    if len(rows) != warm + checked:
        raise ValueError(f"{len(rows)} steps' rows; the reference follows {warm} + {checked}")
    lrs = _lrs(settings, len(rows), per_epoch, host["atlases"].shape[1])
    cw, fixed = sample_weights(host, train_idxs, num_classes, device)
    if not settings["use_fixed_weighting"]:
        fixed = None
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    opt = AdamW(params)
    running = {n: (torch.zeros(params[f"{n}.scale"].shape, device=device),
                   torch.ones(params[f"{n}.scale"].shape, device=device))
               for n in module.stat_names(arch)}
    rows_total = host["atlases"].shape[0] * host["atlases"].shape[1]
    dp = torch.full((rows_total,), float(settings["init_inst_param"]), device=device)
    mu, nu = torch.zeros_like(dp), torch.zeros_like(dp)
    gen, dev_gen = augment.generators(seed, device)
    warp = {"fast-sep": augment.warp_fast_sep, "reference": augment.warp_reference}[order]
    losses, first_grads = [], {}

    def leaves():
        out = {k: v.detach().clone() for k, v in params.items()}
        out["dp_params"] = dp.detach().clone()
        return out

    out = {}
    for k, idxs in enumerate(rows):
        bn = settings["bn_mode"] if k >= warm else "slab"
        img, lbl, mod = instances(host, idxs, device)
        draws = augment.draw(gen, dev_gen, tuple(img.shape), factor, device)
        img, lbl, mod = warp(img, lbl, mod, draws, factor)
        del draws, lbl

        def keep(shape):
            return augment.dropout_keep(dev_gen, shape, rate)

        x = img[:, None]
        net = Net(arch, params, bn, quant, stats=running, remat=True)
        logits = net(x, keep)
        if bn in ("slab", "async"):
            running = update_stats(running, net.batch_stats, seeded=k > 0)
        w = cw[mod]
        ce = (_nll(logits, mod) * w).sum() / w.sum()
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(ce, [params[n] for n in names])))
        if k in (0, warm):
            first_grads[k] = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(params, grads, lrs[k])
        del grads
        if strict:
            with torch.no_grad():
                dp_logits = Net(arch, params, bn, quant)(x, keep)
        else:
            dp_logits = logits.detach()
        del logits, net
        idx_t = torch.as_tensor([int(i) for i in idxs], device=device)
        dp_vec = dp.detach().clone().requires_grad_(True)
        loss = dp_loss(dp_logits, mod, dp_vec[idx_t], None if fixed is None else fixed[idx_t],
                       settings["use_risk_regularization"])
        (dp_grad,) = torch.autograd.grad(loss, [dp_vec])
        if k in first_grads:
            first_grads[k]["dp_params"] = dp_grad.detach().clone()
        touched = torch.zeros_like(dp, dtype=torch.bool)
        touched[idx_t] = True
        dp, mu, nu = sparse_adam(dp, dp_grad, mu, nu, k + 1, touched,
                                 settings["lr_inst_param"])
        losses.append((float(ce.detach()), float(loss.detach())))
        del dp_logits, x, img, mod
        if k + 1 == checked:
            out.update(losses=losses[:checked], grads=first_grads[0], params=leaves())
        if warm and k + 1 == warm:
            before = leaves()
    if warm:
        out["async"] = {"losses": losses[warm:], "grads": first_grads[warm], "before": before,
                        "params": leaves()}
    return out
