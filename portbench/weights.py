"""The weights both sides are given: drawn on the device from the run's
seed, in a few large calls, under the names of the port's `state_dict`.
The names, shapes and initializer tags are the architecture's
(`archs.load(arch).param_shapes`); an architecture with a `make_weights`
of its own draws its weights there instead.

For MobileNet-LRASPP-3D, kernels follow the initializers' distributions
(the backbone's convs a normal of variance 2 / fan_out cut at two standard
deviations, the ASPP's and head's convs and biases uniform within 1 /
sqrt(fan_in)). For training, BatchNorm starts at the identity (scale 1,
bias 0, running statistics (0, 1)), as a run does. For serving, a trained
model's BatchNorm is stood in for by scales and biases near (1, 0) and
running statistics near (0, 1).
"""

from __future__ import annotations

import math

import torch

from . import archs

CUT = 2.0
CUT_STD = 0.87962566103423978  # standard deviation of N(0, 1) cut at +-2


def _fan(shape, depthwise: bool):
    if depthwise:  # (27, C): every tap of every channel
        return math.prod(shape), math.prod(shape)
    o, i = shape[0], shape[1]
    k3 = math.prod(shape[2:])
    return i * k3, o * k3


def make_weights(arch: dict, seed: int, device, served: bool = False):
    """-> (params, stats): name -> float32 tensor on `device`, and BatchNorm
    prefix -> (running mean, running var)."""
    module = archs.load(arch)
    if hasattr(module, "make_weights"):
        return module.make_weights(arch, seed, device, served)
    shapes = module.param_shapes(arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    total = sum(math.prod(s) for s, _ in shapes.values())
    normal = torch.randn(total, generator=gen, device=device).clamp_(-CUT, CUT)
    uniform = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    params, at = {}, 0
    for name, (shape, init) in shapes.items():
        n = math.prod(shape)
        z, u = normal[at:at + n].reshape(shape), uniform[at:at + n].reshape(shape)
        at += n
        if init == "fan_out":
            _, fan_out = _fan(shape, len(shape) == 2)
            params[name] = z * (math.sqrt(2.0 / fan_out) / CUT_STD)
        elif init == "fan_in":
            fan_in, _ = _fan(shape, False)
            params[name] = u / math.sqrt(fan_in)
        elif init.startswith("fan_in_bias:"):
            fan_in, _ = _fan(shapes[init.split(":", 1)[1]][0], False)
            params[name] = u / math.sqrt(fan_in)
        elif init == "one":
            params[name] = 1.0 + 0.1 * z if served else torch.ones(shape, device=device)
        else:
            params[name] = 0.1 * z if served else torch.zeros(shape, device=device)
    stats = {}
    for i, name in enumerate(module.stat_names(arch)):
        C = shapes[f"{name}.scale"][0][0]
        if served:
            g = torch.Generator(device=device)
            g.manual_seed((seed + 7919 * (i + 1)) % (2**63))
            stats[name] = (0.1 * torch.randn(C, generator=g, device=device),
                           0.5 + torch.rand(C, generator=g, device=device))
        else:
            stats[name] = (torch.zeros(C, device=device), torch.ones(C, device=device))
    return {k: v.contiguous() for k, v in params.items()}, stats


def state_dict_of(params: dict, stats: dict) -> dict:
    """The port's `state_dict` entries for these weights and statistics."""
    sd = dict(params)
    for name, (mean, var) in stats.items():
        sd[f"{name}.mean"], sd[f"{name}.var"] = mean, var
    return sd


def load_into(model, params: dict, stats: dict) -> None:
    """Copy the weights into the port's model; every parameter and running
    statistic must be named (BatchNorm's `count` keeps its start, 0)."""
    sd = state_dict_of(params, stats)
    missing = [k for k in model.state_dict() if k not in sd and not k.endswith(".count")]
    extra = [k for k in sd if k not in model.state_dict()]
    if missing or extra:
        raise ValueError(f"weights do not match the model: missing {missing[:5]}, "
                         f"unknown {extra[:5]}")
    with torch.no_grad():
        for k, t in model.state_dict().items():
            if k in sd:
                t.copy_(sd[k])


def balance_classes(arch: dict, params: dict, stats: dict, volume) -> None:
    """Shift the served head's class-1 bias so that the reference's eval
    forward of `volume` (D, H, W) splits its voxels about evenly between the
    two classes: random weights otherwise tend to give one class
    everywhere, where the argmax check would see no boundary."""
    module = archs.load(arch)
    with torch.no_grad():
        logits = module.Net(arch, params, "eval", stats=stats)(volume[None, None].float())
        diff = (logits[:, 1] - logits[:, 0]).flatten()
        params[module.head_bias(arch)][1] -= diff.median()
