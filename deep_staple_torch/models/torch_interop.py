"""Reference-layout PyTorch state dicts (the reference's own `lraspp.pth`
checkpoints) into the port's models and back.

The counterpart of `deep_staple_tpu/models/torch_interop.py` (3D `:92-237`,
2D `:128-218`), which maps the same layouts to Flax variables. The port's
modules carry the Flax names (`models/interop.py`), so each mapping here
goes through that Flax-form tree: reference key -> Flax path (the JAX
module's tables, copied) -> the port's state_dict key and layout
(`models/interop.py::flax_to_state_dict`).

3D, `MobileNet_LRASPP_3D` (`deep_staple/MobileNet_LR_ASPP_3D.py:261-270`):

  * ``backbone.{1..10}[.module].{0,1,3,4,6,7}.*``: ten inverted-residual
    blocks behind an Identity at index 0; residual blocks wrap the
    Sequential in a ResBlock whose attribute is ``module`` (:118-124).
    Indices 0/3/6 are the expand / depthwise / project convs, 1/4/7 their
    BatchNorms;
  * ``aspp.convs.{0..5}.{0,1}.*``, ``aspp.project.{0,1}.*`` (:88-114);
  * ``head.cbr.{0,1}.*``, ``head.scale.1.*``, ``head.low_classifier.*``,
    ``head.high_classifier.*`` (:21-53);
  * ``him_slice.*`` / ``lom_slice.*``: aliases of the backbone's tensors
    (:201-202 register the same modules twice); ignored, as is
    ``num_batches_tracked``.

2D: torchvision's `lraspp_mobilenet_v3_large` layout (the reference's 2D
model, `main_deep_staple.py:386-394`) <-> `models/lraspp2d.py`.

Torch conv weights are (O, I/groups, *k) on the reference side; the port's
3D depthwise kernels are (27, C). The port's 'async' / 'slab' BatchNorm
`count` has no slot in the reference layout: `load_reference_state_dict`
leaves it as the model has it. No torchvision import: the layouts are
tables here.
"""

from __future__ import annotations

import numpy as np
import torch

from .interop import flax_to_state_dict, state_dict_to_flax
from .lraspp2d import _V3_LARGE_CFG
from .lraspp3d import MID_STRIDE, OUT_CHANNELS

# Residual wrapping per reference Backbone_3d (:151-154): (inc == outc) & stride 1.
_IN_CHANNELS = (1,) + OUT_CHANNELS[:-1]  # for in_num=1
_IS_RES = tuple((_IN_CHANNELS[i] == OUT_CHANNELS[i]) and (MID_STRIDE[i] == 1) for i in range(10))
# (torch Sequential conv index, BatchNorm index) of expand / depthwise / project.
_CONV_BN_IDX = ((0, 1), (3, 4), (6, 7))


def _np(x) -> np.ndarray:
    # A copy: a view of a tensor's storage would follow later in-place updates.
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=np.float32, copy=True)


def _conv_to_flax(w) -> np.ndarray:
    """(O, I/g, *k) -> (*k, I/g, O)."""
    a = _np(w)
    n = a.ndim - 2
    return np.transpose(a, tuple(range(2, n + 2)) + (1, 0))


def _conv_to_torch(k) -> np.ndarray:
    """(*k, I/g, O) -> (O, I/g, *k)."""
    a = np.asarray(k, np.float32)
    n = a.ndim - 2
    return np.ascontiguousarray(np.transpose(a, (n + 1, n) + tuple(range(n))))


def _set(tree: dict, path, leaf):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = leaf


def _get(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node)


def _iter_3d_modules():
    """('convbn', torch conv prefix, torch BN prefix, Flax path) for every
    ConvBN, then ('conv', torch prefix, Flax path, has_bias) for the plain
    convs of the head."""
    for c_idx in range(10):
        tprefix = f"backbone.{c_idx + 1}" + (".module" if _IS_RES[c_idx] else "")
        seg, mod = ("him", f"InvertedResidual3D_{c_idx}") if c_idx < 2 else \
            ("lom", f"InvertedResidual3D_{c_idx - 2}")
        for j, (ci, bi) in enumerate(_CONV_BN_IDX):
            yield ("convbn", f"{tprefix}.{ci}", f"{tprefix}.{bi}", (seg, mod, f"ConvBN_{j}"))
    for b in range(6):  # ASPP branches: 1x1, four dilated 3x3, pooling
        yield ("convbn", f"aspp.convs.{b}.0", f"aspp.convs.{b}.1", ("aspp", f"ConvBN_{b}"))
    yield ("convbn", "aspp.project.0", "aspp.project.1", ("aspp", "ConvBN_6"))
    yield ("convbn", "head.cbr.0", "head.cbr.1", ("head", "ConvBN_0"))
    yield ("conv", "head.scale.1", ("head", "Conv_0"), False)
    yield ("conv", "head.low_classifier", ("head", "Conv_1"), True)
    yield ("conv", "head.high_classifier", ("head", "Conv_2"), True)


def _iter_2d_modules():
    """As `_iter_3d_modules` for torchvision's layout, with ('se', torch
    prefix, Flax path) for the squeeze-excite blocks."""
    yield ("convbn", "backbone.0.0", "backbone.0.1", ("ConvBN2D_0",))
    inc = 16
    for i, (_k, expanded, out, use_se, _act, _s, _d) in enumerate(_V3_LARGE_CFG):
        t = f"backbone.{i + 1}.block"
        f = f"InvertedResidual2D_{i}"
        j = fj = 0  # torch Sequential index; the Flax ConvBN2D index follows it
        if expanded != inc:
            yield ("convbn", f"{t}.{j}.0", f"{t}.{j}.1", (f, f"ConvBN2D_{fj}"))
            j += 1
            fj += 1
        yield ("convbn", f"{t}.{j}.0", f"{t}.{j}.1", (f, f"ConvBN2D_{fj}"))  # depthwise
        j += 1
        fj += 1
        if use_se:
            yield ("se", f"{t}.{j}", (f, "SqueezeExcite_0"))
            j += 1
        yield ("convbn", f"{t}.{j}.0", f"{t}.{j}.1", (f, f"ConvBN2D_{fj}"))  # project
        inc = out
    yield ("convbn", "backbone.16.0", "backbone.16.1", ("ConvBN2D_1",))
    yield ("convbn", "classifier.cbr.0", "classifier.cbr.1", ("ConvBN2D_2",))
    yield ("conv", "classifier.scale.1", ("Conv_0",), False)
    yield ("conv", "classifier.low_classifier", ("Conv_1",), True)
    yield ("conv", "classifier.high_classifier", ("Conv_2",), True)


def _reference_to_flax(state_dict, modules) -> dict:
    params: dict = {}
    stats: dict = {}
    for entry in modules:
        if entry[0] == "convbn":
            _, conv_k, bn_k, fpath = entry
            _set(params, fpath + ("Conv_0", "kernel"), _conv_to_flax(state_dict[f"{conv_k}.weight"]))
            _set(params, fpath + ("BatchNorm_0", "scale"), _np(state_dict[f"{bn_k}.weight"]))
            _set(params, fpath + ("BatchNorm_0", "bias"), _np(state_dict[f"{bn_k}.bias"]))
            _set(stats, fpath + ("BatchNorm_0", "mean"), _np(state_dict[f"{bn_k}.running_mean"]))
            _set(stats, fpath + ("BatchNorm_0", "var"), _np(state_dict[f"{bn_k}.running_var"]))
        elif entry[0] == "se":
            _, t, fpath = entry
            for fc, fconv in (("fc1", "Conv_0"), ("fc2", "Conv_1")):
                _set(params, fpath + (fconv, "kernel"), _conv_to_flax(state_dict[f"{t}.{fc}.weight"]))
                _set(params, fpath + (fconv, "bias"), _np(state_dict[f"{t}.{fc}.bias"]))
        else:
            _, conv_k, fpath, has_bias = entry
            _set(params, fpath + ("kernel",), _conv_to_flax(state_dict[f"{conv_k}.weight"]))
            if has_bias:
                _set(params, fpath + ("bias",), _np(state_dict[f"{conv_k}.bias"]))
    return {"params": params, "batch_stats": stats}


def _flax_to_reference(variables, modules) -> dict:
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}
    for entry in modules:
        if entry[0] == "convbn":
            _, conv_k, bn_k, fpath = entry
            sd[f"{conv_k}.weight"] = _conv_to_torch(_get(params, fpath + ("Conv_0", "kernel")))
            sd[f"{bn_k}.weight"] = _get(params, fpath + ("BatchNorm_0", "scale"))
            sd[f"{bn_k}.bias"] = _get(params, fpath + ("BatchNorm_0", "bias"))
            sd[f"{bn_k}.running_mean"] = _get(stats, fpath + ("BatchNorm_0", "mean"))
            sd[f"{bn_k}.running_var"] = _get(stats, fpath + ("BatchNorm_0", "var"))
        elif entry[0] == "se":
            _, t, fpath = entry
            for fc, fconv in (("fc1", "Conv_0"), ("fc2", "Conv_1")):
                sd[f"{t}.{fc}.weight"] = _conv_to_torch(_get(params, fpath + (fconv, "kernel")))
                sd[f"{t}.{fc}.bias"] = _get(params, fpath + (fconv, "bias"))
        else:
            _, conv_k, fpath, has_bias = entry
            sd[f"{conv_k}.weight"] = _conv_to_torch(_get(params, fpath + ("kernel",)))
            if has_bias:
                sd[f"{conv_k}.bias"] = _get(params, fpath + ("bias",))
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def reference_state_dict_to_port(state_dict) -> dict:
    """The reference `MobileNet_LRASPP_3D` state_dict (tensors or arrays) ->
    the port's `MobileNetLRASPP3D` state_dict (CPU tensors, no BatchNorm
    `count`)."""
    return flax_to_state_dict(_reference_to_flax(state_dict, _iter_3d_modules()))


def port_state_dict_to_reference(state_dict) -> dict:
    """The port's `MobileNetLRASPP3D` state_dict -> the reference layout (CPU
    float32 tensors, without the him/lom_slice aliases: load it into the
    reference model with strict=False)."""
    return _flax_to_reference(state_dict_to_flax(state_dict), _iter_3d_modules())


def torchvision_lraspp2d_to_port(state_dict) -> dict:
    """A torchvision-layout `lraspp_mobilenet_v3_large` state_dict -> the
    port's `LRASPPMobileNetV3Large2D` state_dict."""
    return flax_to_state_dict(_reference_to_flax(state_dict, _iter_2d_modules()))


def port_lraspp2d_to_torchvision(state_dict) -> dict:
    """The port's `LRASPPMobileNetV3Large2D` state_dict -> torchvision's
    layout (CPU float32 tensors)."""
    return _flax_to_reference(state_dict_to_flax(state_dict), _iter_2d_modules())


def load_reference_state_dict(model: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Load a reference-layout state_dict into the port's 3D or 2D model
    (chosen by the model's class): every parameter and statistic must be
    there; a BatchNorm `count` keeps the model's value."""
    from .lraspp2d import LRASPPMobileNetV3Large2D

    to_port = torchvision_lraspp2d_to_port if isinstance(model, LRASPPMobileNetV3Large2D) \
        else reference_state_dict_to_port
    result = model.load_state_dict(to_port(state_dict), strict=False)
    missing = [k for k in result.missing_keys if not k.endswith(".count")]
    if missing or result.unexpected_keys:
        raise KeyError(f"state_dict does not fit {type(model).__name__}: missing {missing}, "
                       f"unexpected {result.unexpected_keys}")
    return model
