"""nnU-Net v2's `PlainConvUNet` in the benchmark: its architecture module
resolves from the configuration, its counts are pinned, its weights load
into the port's network, the sample-blocked reference steps equal a
whole-batch computation, and the two metrics it brings read a synthetic
trace."""

from __future__ import annotations

import json
import math

import pytest
import torch

from portbench import archs, run as prun, traffic, weights
from portbench.archs import PlainConvUNet3D as unet
from portbench.reference import train as ref_train

from .conftest import REPO

CONFIG = json.loads((REPO / "portbench/configs/nnunet3d-production.json").read_text())
ARCH = CONFIG["model"]
TINY = {**ARCH, "features": [4, 8, 16], "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 1]]}
SPATIAL = (192, 192, 96)


def _load_metric(name):
    return prun.load_module(REPO / "portbench" / "metrics" / f"{name}.py",
                            "test_metric_" + name.replace(".", "_"))


def test_the_cell_resolves_to_this_architecture():
    spec = prun.cell_spec(REPO, "train-nnunet-b8")
    assert spec["config"]["model"]["arch"] == "PlainConvUNet3D"
    assert archs.load(ARCH) is unet
    assert unet.parameter_count(ARCH) == ARCH["parameters"] == 30_785_994
    assert unet.stat_names(ARCH) == [] and unet.dw_calls(ARCH, 8, SPATIAL) == []
    assert spec["traffic"]["size"] == [128, 128, 64]
    assert [math.floor(s * CONFIG["train"]["pre_interpolation_factor"])
            for s in spec["traffic"]["size"]] == list(SPATIAL)


def test_forward_flops_are_pinned():
    assert unet.forward_flops(ARCH, 1, SPATIAL) == 1_612_000_714_752
    assert unet.forward_flops(ARCH, 8, SPATIAL) == 8 * 1_612_000_714_752
    assert unet.first_input_grad_flops(ARCH, 1, SPATIAL) == 2 * 192 * 192 * 96 * 27 * 32


def test_weights_load_into_the_port_model():
    from deep_staple_torch.models.plainconvunet3d import PlainConvUNet3D

    model = PlainConvUNet3D()
    params, stats = weights.make_weights(ARCH, 2**31 + 11, "cpu")
    assert stats == {}
    weights.load_into(model, params, stats)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in params.items())
    w = params["encoder.3.1.conv.weight"]
    want = math.sqrt(2.0 / (1.0 + 1e-4)) / math.sqrt(256 * 27)
    assert abs(float(w.std()) / want - 1) < 0.01
    assert float(params["encoder.3.1.norm.weight"].min()) == 1.0
    assert float(params["heads.0.bias"].abs().max()) == 0.0


def _whole_batch(net, params, x, mod, cw):
    """The deep-supervision CE of the whole batch in one forward."""
    names = list(params)
    heads = net.heads(x)
    loss = None
    for w, out, tgt in zip(unet.ds_weights(len(heads)), heads,
                           unet._targets(mod, len(heads), net.strides)):
        if w:
            term = w * (ref_train._nll(out, tgt) * cw[tgt]).sum() / cw[tgt].sum()
            loss = term if loss is None else loss + term
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return float(loss.detach()), dict(zip(names, grads)), heads[0].detach()


def test_blocked_loss_equals_the_whole_batch():
    params, _ = unet.make_weights(TINY, 5, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).requires_grad_(True)
              for k, v in params.items()}
    x = torch.randn(3, 1, 16, 16, 8, generator=gen)
    mod = (torch.rand(3, 16, 16, 8, generator=gen) < 0.3).long()
    cw = torch.tensor([0.7, 1.3])
    net = unet.Net(TINY, params)
    got = unet.ds_loss_blocked(net, params, x, mod, cw)
    want = _whole_batch(net, params, x, mod, cw)
    assert abs(got[0] - want[0]) / want[0] < 1e-6
    assert float((got[2] - want[2]).abs().max() / want[2].abs().max()) < 1e-5
    med = sorted(float(g.norm()) for g in want[1].values() if g is not None)[len(want[1]) // 2]
    for k, g in want[1].items():
        if g is None:
            assert got[1][k] is None, k
            continue
        assert float((got[1][k] - g).norm()) / max(float(g.norm()), med) < 1e-5, k


def test_run_steps_blocked_equals_whole_batch(tmp_path, monkeypatch):
    """`run_steps` on a tiny fixture, then again with the blocked loss
    swapped for the whole batch's: losses, first gradients and the leaves
    after the steps agree."""
    tr = json.loads((REPO / "portbench/traffic/train-b8-d64.json").read_text())
    tr.update(cases=4, atlases=3, bad_atlases=1, size=[16, 16, 8], num_val_images=1)
    host = traffic.train_fixture(tmp_path / "data", tr, 2**31 + 5, "cpu")
    settings = {**CONFIG["train"], "batch_size": 3}
    params0, _ = unet.make_weights(TINY, 7, "cpu")
    train_idxs = list(range(3, 12))
    rows = [[3, 7, 10], [4, 5, 11]]
    args = (TINY, settings, host, rows, params0, 9, train_idxs, "cpu")
    blocked = unet.run_steps(*args, checked=2)
    monkeypatch.setattr(unet, "ds_loss_blocked", _whole_batch)
    whole = unet.run_steps(*args, checked=2)
    for (a, b), (c, d) in zip(blocked["losses"], whole["losses"]):
        assert abs(a - c) / c < 1e-5 and abs(b - d) / abs(d) < 1e-5
    med = sorted(float(g.norm()) for g in whole["grads"].values())[len(whole["grads"]) // 2]
    for k, g in whole["grads"].items():
        assert float((blocked["grads"][k] - g).norm()) / max(float(g.norm()), med) < 1e-5, k
    # A conv bias before an InstanceNorm has a gradient of round-off alone,
    # which AdamW's first steps turn into lr * sign(g): such leaves are left
    # out, as the benchmark's change gaps leave them out.
    for k, p in whole["params"].items():
        if float(whole["grads"][k].norm()) < 1e-3 * med:
            continue
        before = params0[k] if k in params0 else torch.zeros_like(p)
        moved = float((p - before).norm())
        assert float((blocked["params"][k] - p).norm()) <= 1e-4 * moved, k


def _rec(kernels):
    return {"kind": "train", "arch": ARCH, "batch": 8, "spatial": SPATIAL, "dtype": "bfloat16",
            "trace": {"kernels": kernels, "units": 5}}


def test_conv_roofline_and_nonconv_readers():
    conv, rest = _load_metric("conv_roofline.train"), _load_metric("nonconv_ms_per_step.train")
    kernels = {"sm90_xmma_fprop_implicit_gemm_bf16": 0.20, "sm90_xmma_dgrad_implicit_gemm": 0.15,
               "sm90_xmma_wgrad_implicit_gemm": 0.15, "dw3d_fwd_kernel": 0.01,
               "sep_warp_x_kernel": 0.02, "vectorized_elementwise_kernel": 0.30,
               "reduce_kernel": 0.10}
    work = 3 * unet.forward_flops(ARCH, 8, SPATIAL) - unet.first_input_grad_flops(ARCH, 8, SPATIAL)
    want = 100.0 * work / 989e12 / (0.50 / 5)
    assert conv.read(_rec(kernels)) == pytest.approx(want)
    assert rest.read(_rec(kernels)) == pytest.approx(0.40 / 5 * 1e3)
    plain = {"vectorized_elementwise_kernel": 0.3, "dw3d_fwd_kernel": 0.1}
    assert conv.read(_rec(plain)) is None and rest.read(_rec(plain)) is None
    mobilenet = json.loads((REPO / "portbench/configs/lraspp3d-production.json").read_text())
    assert conv.read({**_rec(kernels), "arch": mobilenet["model"]}) is None
