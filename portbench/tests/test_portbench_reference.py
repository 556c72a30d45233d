"""The plain reference against the port at a tiny size on the CPU: the
model (slab BatchNorm warming up async BatchNorm too), the augmentation's
draws and warps, and the first training step through `train_dl`."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import compare, weights
from portbench import run as prun
from portbench.reference import augment
from portbench.reference.model import Net, update_stats

from .conftest import REPO

ARCH = json.loads((REPO / "portbench/configs/lraspp3d-production.json").read_text())["model"]


@pytest.mark.parametrize("served", [True, False])
def test_eval_forward(served):
    from deep_staple_torch.models import MobileNetLRASPP3D

    m = MobileNetLRASPP3D(num_classes=2, use_checkpointing=False)
    params, stats = weights.make_weights(ARCH, 2**31 + 5, "cpu", served=served)
    weights.load_into(m, params, stats)
    x = torch.randn(2, 24, 24, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = Net(ARCH, params, "eval", stats=stats)(x[:, None])
        got = m(x[..., None], train=False)["out"].permute(0, 4, 1, 2, 3)
    assert (ref - got).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("bn_mode", ["slab", "batch"])
def test_train_forward_with_dropout(bn_mode):
    from deep_staple_torch.models import MobileNetLRASPP3D

    m = MobileNetLRASPP3D(num_classes=2, use_checkpointing=bn_mode == "batch", bn_mode=bn_mode)
    params, stats = weights.make_weights(ARCH, 7, "cpu")
    weights.load_into(m, params, stats)
    x = torch.randn(2, 24, 24, 16, generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    got = m(x[..., None], train=True, generator=g)["out"].permute(0, 4, 1, 2, 3)
    g2 = torch.Generator().manual_seed(3)
    ref = Net(ARCH, params, bn_mode, remat=True)(
        x[:, None], lambda shape: augment.dropout_keep(g2, shape, ARCH["dropout_rate"]))
    assert (ref - got).abs().max() <= 1e-4 * ref.abs().max()


def test_async_after_slab_warmup():
    """Two slab BatchNorm forwards, then an async one, on the port's model
    (the warm-up model sharing its parameters and statistics, as the
    driver builds it) and on the reference: the async output, and the
    running statistics after each phase."""
    from deep_staple_torch.models import MobileNetLRASPP3D

    m = MobileNetLRASPP3D(num_classes=2, use_checkpointing=False, bn_mode="async")
    warm = MobileNetLRASPP3D(num_classes=2, use_checkpointing=False, bn_mode="slab")
    mods = dict(m.named_modules())
    for name, mod in warm.named_modules():
        mod._parameters, mod._buffers = mods[name]._parameters, mods[name]._buffers
    params, stats = weights.make_weights(ARCH, 11, "cpu")
    weights.load_into(m, params, stats)
    running = stats
    gen = torch.Generator().manual_seed(4)
    for k, model in enumerate((warm, warm, m)):
        x = torch.randn(2, 24, 24, 16, generator=gen)
        got = model(x[..., None], train=True, generator=torch.Generator().manual_seed(k))
        got = got["out"].permute(0, 4, 1, 2, 3)
        g2 = torch.Generator().manual_seed(k)
        net = Net(ARCH, params, "slab" if k < 2 else "async", stats=running, remat=True)
        ref = net(x[:, None], lambda shape: augment.dropout_keep(g2, shape, ARCH["dropout_rate"]))
        assert (ref - got).abs().max() <= 1e-4 * ref.abs().max(), k
        running = update_stats(running, net.batch_stats, seeded=k > 0)
        sd = m.state_dict()
        for name, (mean, var) in running.items():
            assert torch.allclose(sd[f"{name}.mean"], mean, rtol=1e-4, atol=1e-5), (k, name)
            assert torch.allclose(sd[f"{name}.var"], var, rtol=1e-4, atol=1e-5), (k, name)


def test_draws_follow_the_loop():
    from deep_staple_torch.ops.augment import draw_augment

    gen, dev_gen = augment.generators(12345, "cpu")
    ours = augment.draw(gen, dev_gen, (3, 16, 12, 8), 1.5, "cpu")
    gen2 = torch.Generator().manual_seed(12345)
    dev2 = torch.Generator()
    dev2.manual_seed(int(torch.randint(2**62, (1,), generator=gen2)))
    theirs = draw_augment(gen2, (3, 16, 12, 8), pre_interpolation_factor=1.5,
                          noise_generator=dev2)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("order", ["fast-sep", "reference"])
def test_warps(order):
    from deep_staple_torch.ops.augment import augment_sample_pair

    gen, dev_gen = augment.generators(99, "cpu")
    shape = (2, 16, 12, 8)
    d = augment.draw(gen, dev_gen, shape, 1.5, "cpu")
    g = torch.Generator().manual_seed(4)
    img = torch.randn(shape, generator=g)
    lbl = (torch.rand(shape, generator=g) > 0.6).long()
    mod = torch.roll(lbl, 1, dims=1)
    warp = augment.warp_fast_sep if order == "fast-sep" else augment.warp_reference
    ri, rl, rm = warp(img, lbl, mod, d, 1.5)
    pi, pl, pm, _ = augment_sample_pair(img, lbl, mod, d, pre_interpolation_factor=1.5,
                                        order=order)
    assert (ri - pi).abs().max() <= 1e-4
    assert (rl != pl).float().mean() <= 1e-3 and (rm != pm).float().mean() <= 1e-3


@pytest.mark.parametrize("cell", ["train-ref-b8", "train-prod-b8"])
def test_first_step_through_train_dl(tiny_root, cell):
    """The loop's first step and the reference's from the same raw data and
    weights: the CE loss, and every model leaf's first gradient."""
    spec = prun.cell_spec(tiny_root, cell)
    spec["traffic"]["checked_steps"] = 1
    entry = prun.load_module(tiny_root / "portbench/entries/train.py", "entry_train_t")
    ctx = {"spec": spec, "seed": 2**31 + 17, "seconds": 0.0, "trace": False,
           "device": torch.device("cpu"), "t_process": 0.0, "log": lambda m: None}
    record = entry.drive(ctx, window=False)
    ref = entry.reference(record, ctx["device"])
    ce_p, ce_r = record["losses"][0][0], ref["losses"][0][0]
    tol = 1e-5 if cell == "train-ref-b8" else 2e-2  # bfloat16 program, float32 reference
    assert abs(ce_p - ce_r) <= tol * ce_r
    model = [k for k in ref["grads"] if k != "dp_params"]
    gaps = compare.leaf_gaps(record["grads"], ref["grads"], model)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= (1e-2 if cell == "train-ref-b8" else 0.3), worst
