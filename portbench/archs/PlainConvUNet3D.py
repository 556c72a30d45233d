"""nnU-Net v2's `3d_fullres` network, `PlainConvUNet` with deep supervision
(Isensee et al., Nature Methods 18:203-211, 2021; `MIC-DKFZ/nnUNet` v2,
`dynamic_network_architectures.architectures.unet.PlainConvUNet`), in plain
PyTorch: the reference the benchmark holds the port's network and its
training steps against. It imports nothing of the program.

The configuration's `model` gives the widths: `features` (one a stage),
`strides` (one (D, H, W) triple a stage), `num_classes`, `in_channels`.
Encoder stage s: two blocks of 3x3x3 conv (padding 1, a bias) ->
InstanceNorm (affine, eps 1e-5, biased variance) -> LeakyReLU(0.01), the
first with stride S_s. Decoder stage s (from the deepest up): a transposed
conv with kernel = stride = S_{s+1} (a bias), the concatenation [upsampled,
skip], two blocks, and a 1x1x1 head (a bias). Everything is NCDHW float32
through `F.conv3d`, `F.conv_transpose3d` and `F.instance_norm`.

`run_steps` replays the program's first training steps: the augmentation,
the deep-supervision CE (heads weighted [1, 1/2, 1/4, ...] with the last 0,
normalised; each head's class-weighted CE against the label selected at
its stride, `lbl[:, ::sD, ::sH, ::sW]`), AdamW on the model, the fused
out-of-line DP pass with its risk regularisation on the detached
full-resolution logits, and SparseAdam on the DP rows. TF32 is off while it
runs: this architecture's control is float8 (`quant`).

Departures from the published nnU-Net, all the program's too: no Dice term
in the loss (DeepSTAPLE's objective is the class-weighted CE; the data
parameters weight a per-sample CE), AdamW in place of SGD with Nesterov
momentum, order-0 strided selection of the deep-supervision targets in
place of nnU-Net's order-0 resampling (the same voxels where the extent
divides by the stride), DeepSTAPLE's batch of 8 in place of the planner's 2,
and DeepSTAPLE's augmentation in place of nnU-Net's.

Weights (`make_weights`): nnU-Net's `InitWeights_He(1e-2)`, a normal of
standard deviation sqrt(2 / (1 + 0.01^2)) / sqrt(fan_in) with PyTorch's fan
rule (the weight's dim 1 times its kernel), drawn from the seed on the
device; zero biases; InstanceNorm weight 1 and bias 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import augment
from portbench.reference import train as ref_train

EPS = 1e-5
NEGATIVE_SLOPE = 0.01
HE_A = 1e-2


def _stages(arch: dict):
    feats = [int(f) for f in arch["features"]]
    strides = [tuple(int(s) for s in st) for st in arch["strides"]]
    return feats, strides


def param_shapes(arch: dict) -> dict:
    """name -> (shape, init) under the port's `state_dict` names; init is
    'he' (a conv's weight), 'zero' (biases) or 'one' (InstanceNorm's
    weight)."""
    feats, strides = _stages(arch)
    shapes = {}

    def conv(prefix, cin, cout, kernel, transposed=False):
        shape = (cin, cout, *kernel) if transposed else (cout, cin, *kernel)
        shapes[f"{prefix}.weight"] = (shape, "he")
        shapes[f"{prefix}.bias"] = ((cout,), "zero")

    def block(prefix, cin, cout):
        conv(f"{prefix}.conv", cin, cout, (3, 3, 3))
        shapes[f"{prefix}.norm.weight"] = ((cout,), "one")
        shapes[f"{prefix}.norm.bias"] = ((cout,), "zero")

    cin = int(arch["in_channels"])
    for s, f in enumerate(feats):
        block(f"encoder.{s}.0", cin, f)
        block(f"encoder.{s}.1", f, f)
        cin = f
    for s in range(len(feats) - 1):
        block(f"decoder.{s}.0", 2 * feats[s], feats[s])
        block(f"decoder.{s}.1", feats[s], feats[s])
        conv(f"decoder.{s}.up", feats[s + 1], feats[s], strides[s + 1], transposed=True)
    for s in range(len(feats) - 1):
        conv(f"heads.{s}", feats[s], int(arch["num_classes"]), (1, 1, 1))
    return shapes


def stat_names(arch: dict) -> list:
    return []


def head_bias(arch: dict) -> str:
    return "heads.0.bias"


def dw_calls(arch: dict, batch: int, spatial) -> list:
    return []


def parameter_count(arch: dict) -> int:
    return sum(math.prod(shape) for shape, _ in param_shapes(arch).values())


def forward_flops(arch: dict, batch: int, spatial) -> int:
    """The FLOPs of one train forward (every head): two a multiply-add of
    every conv, every tap of the padded 3x3x3 window counted (the dense
    convs compute them), a transposed conv with kernel = stride one tap an
    output voxel. InstanceNorm, LeakyReLU, the concatenations and the
    losses are left out."""
    feats, strides = _stages(arch)
    ncls, cin = int(arch["num_classes"]), int(arch["in_channels"])
    sp, grids, total = tuple(int(n) for n in spatial), [], 0
    for f, st in zip(feats, strides):
        sp = tuple(-(-n // s) for n, s in zip(sp, st))
        total += 2 * math.prod(sp) * 27 * (cin + f) * f
        grids.append(sp)
        cin = f
    for s in range(len(feats) - 1):
        vox = math.prod(grids[s])
        total += 2 * vox * feats[s + 1] * feats[s]  # the transposed conv
        total += 2 * vox * 27 * (2 * feats[s] + feats[s]) * feats[s]
        total += 2 * vox * feats[s] * ncls
    return batch * total


def first_input_grad_flops(arch: dict, batch: int, spatial) -> int:
    """The first conv's input gradient, which training does not compute."""
    feats, _ = _stages(arch)
    return 2 * batch * math.prod(int(n) for n in spatial) * 27 * int(arch["in_channels"]) * feats[0]


def make_weights(arch: dict, seed: int, device, served: bool = False):
    """-> (params, {}): name -> float32 tensor on `device` (module
    docstring). `served` is not read: no serving cell runs this network."""
    shapes = param_shapes(arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    total = sum(math.prod(s) for s, _ in shapes.values())
    normal = torch.randn(total, generator=gen, device=device)
    gain = math.sqrt(2.0 / (1.0 + HE_A**2))
    params, at = {}, 0
    for name, (shape, init) in shapes.items():
        n = math.prod(shape)
        z = normal[at:at + n].reshape(shape)
        at += n
        if init == "he":
            params[name] = z * (gain / math.sqrt(math.prod(shape[1:])))
        else:
            params[name] = torch.full(shape, float(init == "one"), device=device)
    return {k: v.contiguous() for k, v in params.items()}, {}


def _identity(t):
    return t


class Net:
    """The forward of one set of parameters, NCDHW float32. `quant` rounds
    each conv's input, weights, bias and output and each normalisation's and
    activation's output, with an unrounded gradient (the control);
    `bn_mode`, `stats` and `remat` are not read (no BatchNorm, no remat)."""

    def __init__(self, arch, params, bn_mode=None, quant=None, stats=None, remat=False):
        self.arch, self.p = arch, params
        self.q = quant or _identity
        self.feats, self.strides = _stages(arch)

    def conv(self, name, x, stride=(1, 1, 1), transposed=False):
        w, b = self.q(self.p[f"{name}.weight"]), self.q(self.p[f"{name}.bias"])
        if transposed:
            y = F.conv_transpose3d(self.q(x), w, b, stride)
        else:
            y = F.conv3d(self.q(x), w, b, stride, [k // 2 for k in w.shape[2:]])
        return self.q(y)

    def block(self, name, x, stride=(1, 1, 1)):
        y = self.conv(f"{name}.conv", x, stride)
        y = self.q(F.instance_norm(y, weight=self.p[f"{name}.norm.weight"],
                                   bias=self.p[f"{name}.norm.bias"], eps=EPS))
        return self.q(F.leaky_relu(y, NEGATIVE_SLOPE))

    def heads(self, x, train: bool = True) -> list:
        """x (B, C_in, D, H, W) -> the heads' logits, full resolution
        first; `train` False: the first alone."""
        skips = []
        for s, st in enumerate(self.strides):
            x = self.block(f"encoder.{s}.1", self.block(f"encoder.{s}.0", x, st))
            skips.append(x)
        x, outs = skips.pop(), {}
        for s in reversed(range(len(self.feats) - 1)):
            u = self.conv(f"decoder.{s}.up", x, self.strides[s + 1], transposed=True)
            x = torch.cat([u, skips[s]], dim=1)
            x = self.block(f"decoder.{s}.1", self.block(f"decoder.{s}.0", x))
            if train or s == 0:
                outs[s] = self.conv(f"heads.{s}", x)
        return [outs[s] for s in sorted(outs)]

    def __call__(self, x, keep=None):
        """x (B, C_in, D, H, W) -> float32 logits (B, classes, D, H, W) of
        the full-resolution head."""
        return self.heads(x, train=False)[0]


def ds_weights(heads: int) -> list:
    w = [0.5**k for k in range(heads)]
    w[-1] = 0.0
    return [x / sum(w) for x in w]


def _targets(mod, heads: int, strides) -> list:
    """The order-0 selection of the label at each head's cumulative stride."""
    out, cum = [], [1, 1, 1]
    for k in range(heads):
        cum = [c * s for c, s in zip(cum, strides[k])]
        out.append(mod[:, ::cum[0], ::cum[1], ::cum[2]])
    return out


def ds_loss_blocked(net: Net, params: dict, x, mod, cw):
    """The deep-supervision CE and its gradient, one sample at a time.

    InstanceNorm makes the samples independent, so the batch's loss is the
    sum of each sample's terms once every head's CE denominator, the sum of
    the class weights of its targets, is taken over the whole batch first;
    each sample's forward and backward then runs alone and the gradients
    are summed. That is the whole-batch computation up to the order of the
    sums. -> (loss, {name: gradient, None for the parameters of a head of
    weight 0}, detached full-resolution logits)."""
    names = list(params)
    heads = len(net.feats) - 1
    targets = _targets(mod, heads, net.strides)
    weights = ds_weights(heads)
    dens = [cw[t].sum() for t in targets]
    total, grads, logits = 0.0, None, []
    for b in range(x.shape[0]):
        outs = net.heads(x[b:b + 1])
        loss = None
        for w, out, tgt, den in zip(weights, outs, targets, dens):
            if w == 0.0:
                continue
            t = tgt[b:b + 1]
            term = w * (ref_train._nll(out, t) * cw[t]).sum() / den
            loss = term if loss is None else loss + term
        g = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        grads = list(g) if grads is None else [None if a is None else a + c
                                               for a, c in zip(grads, g)]
        total += float(loss.detach())
        logits.append(outs[0].detach())
        del outs, loss, g
    return total, dict(zip(names, grads)), torch.cat(logits)


def run_steps(arch: dict, settings: dict, host: dict, rows: list, params0: dict, seed: int,
              train_idxs, device, quant=None, checked: int = 3) -> dict:
    """`reference/train.py::run_steps` for this network (its docstring); no
    BatchNorm, so no async steps."""
    prev = ref_train.precision(tf32=False)
    try:
        return _run_steps(arch, settings, host, rows, params0, seed, train_idxs, device, quant,
                          checked)
    finally:
        ref_train.restore(prev)


def _run_steps(arch, settings, host, rows, params0, seed, train_idxs, device, quant, checked):
    if settings["ool_mode"] != "fused" or settings["bn_mode"] != "batch":
        raise ValueError("the reference runs this network with the fused DP pass and no "
                         "BatchNorm mode but 'batch'")
    if len(rows) != checked:
        raise ValueError(f"{len(rows)} steps' rows; the reference follows {checked}")
    factor = float(settings["pre_interpolation_factor"])
    per_epoch = math.ceil(len(train_idxs) / int(settings["batch_size"]))
    lrs = ref_train._lrs(settings, len(rows), per_epoch, host["atlases"].shape[1])
    cw, fixed = ref_train.sample_weights(host, train_idxs, int(arch["num_classes"]), device)
    if not settings["use_fixed_weighting"]:
        fixed = None
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    opt = ref_train.AdamW(params)
    rows_total = host["atlases"].shape[0] * host["atlases"].shape[1]
    dp = torch.full((rows_total,), float(settings["init_inst_param"]), device=device)
    mu, nu = torch.zeros_like(dp), torch.zeros_like(dp)
    gen, dev_gen = augment.generators(seed, device)
    warp = {"fast-sep": augment.warp_fast_sep, "reference": augment.warp_reference}[
        settings["augment_order"]]
    losses, first_grads = [], None
    for k, idxs in enumerate(rows):
        img, lbl, mod = ref_train.instances(host, idxs, device)
        draws = augment.draw(gen, dev_gen, tuple(img.shape), factor, device)
        img, lbl, mod = warp(img, lbl, mod, draws, factor)
        del draws, lbl
        net = Net(arch, params, quant=quant)
        ce, grads, logits = ds_loss_blocked(net, params, img[:, None], mod, cw)
        if k == 0:
            first_grads = {n: torch.zeros_like(params[n]) if g is None else g.detach().clone()
                           for n, g in grads.items()}
        # Parameters without a gradient (a head of weight 0) are skipped, as
        # torch's AdamW skips them: no decay, no moments.
        opt.step({n: params[n] for n, g in grads.items() if g is not None}, grads, lrs[k])
        del grads
        idx_t = torch.as_tensor([int(i) for i in idxs], device=device)
        dp_vec = dp.detach().clone().requires_grad_(True)
        loss = ref_train.dp_loss(logits, mod, dp_vec[idx_t],
                                 None if fixed is None else fixed[idx_t],
                                 settings["use_risk_regularization"])
        (dp_grad,) = torch.autograd.grad(loss, [dp_vec])
        if k == 0:
            first_grads["dp_params"] = dp_grad.detach().clone()
        touched = torch.zeros_like(dp, dtype=torch.bool)
        touched[idx_t] = True
        dp, mu, nu = ref_train.sparse_adam(dp, dp_grad, mu, nu, k + 1, touched,
                                           settings["lr_inst_param"])
        losses.append((ce, float(loss.detach())))
        del logits, img, mod
    out = {k: v.detach().clone() for k, v in params.items()}
    out["dp_params"] = dp.detach().clone()
    return {"losses": losses, "grads": first_grads, "params": out}
