"""nnU-Net v2's `PlainConvUNet` in the port (`models/plainconvunet3d.py`) on
the CPU, held to the benchmark's plain reference
(`portbench/archs/PlainConvUNet3D.py`) at a tiny width: the forward of every
head, one train step (deep-supervision CE, DP loss, gradients, the DP
vector's SparseAdam update), the published width's parameter count, the
initializer, the configuration's refusals, checkpoints, the spans and
counters, and `train_dl`."""

import math

import numpy as np
import pytest
import torch

from deep_staple_torch.core.config import TrainConfig
from deep_staple_torch.models import MobileNetLRASPP3D
from deep_staple_torch.models.norm import InstanceNorm
from deep_staple_torch.models.plainconvunet3d import PlainConvUNet3D, init_weights
from deep_staple_torch.train import checkpoint as ckpt
from deep_staple_torch.train import driver
from deep_staple_torch.train.state import create_state
from deep_staple_torch.train.step import make_train_step
from deep_staple_torch.utils import tracing
from portbench.archs import PlainConvUNet3D as ref
from portbench.reference import train as ref_train

torch.set_num_threads(1)

FEATURES = (4, 8, 16)
STRIDES = ((1, 1, 1), (2, 2, 2), (2, 2, 1))
ARCH = {"arch": "PlainConvUNet3D", "in_channels": 1, "num_classes": 2,
        "features": list(FEATURES), "strides": [list(s) for s in STRIDES]}
SPATIAL = (16, 16, 8)
UNET = dict(model_arch="plainconvunet3d", bn_mode="batch", use_checkpointing=False)


def tiny(dtype=None, seed=0):
    """The tiny port model with seeded weights (biases and InstanceNorm's
    affine moved off their start, so that every parameter matters), and the
    same weights for the reference."""
    params, _ = ref.make_weights(ARCH, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen) if v.dim() == 1 else v
              for k, v in params.items()}
    model = PlainConvUNet3D(2, 1, FEATURES, STRIDES, dtype=dtype)
    model.load_state_dict(params, strict=True)
    return model, params


def inputs(seed=0, batch=2):
    gen = torch.Generator().manual_seed(100 + seed)
    x = torch.randn((batch, *SPATIAL, 1), generator=gen)
    lbl = (torch.rand((batch, *SPATIAL), generator=gen) < 0.3).long()
    return x, lbl


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_forward_float32_matches_the_reference_at_every_head():
    model, params = tiny()
    x, _ = inputs()
    with torch.no_grad():
        out = model(x, train=True)
    heads = [out["out"], *out["aux"]]
    want = ref.Net(ARCH, params).heads(x.permute(0, 4, 1, 2, 3))
    assert len(heads) == len(want) == len(FEATURES) - 1
    for got, w in zip(heads, want):
        w = w.permute(0, 2, 3, 4, 1)
        assert got.shape == w.shape and got.dtype == torch.float32
        assert float((got - w).abs().max() / w.abs().max()) < 1e-5
    assert list(model(x)) == ["out"]
    assert torch.equal(model(x)["out"], out["out"])


def test_forward_bfloat16_within_its_rounding():
    """bfloat16 keeps 8 significant bits: each conv's input, weights and
    output, each normalisation's output are rounded (relative 2^-9 each),
    over four blocks between input and output at this depth; the float32
    reference's logits are held within 3% of their largest, about 8 such
    roundings accumulated."""
    model, params = tiny(torch.bfloat16)
    x, _ = inputs()
    with torch.no_grad():
        got = model(x)["out"]
        want = ref.Net(ARCH, params)(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert got.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    assert 0 < err < 0.03


def test_one_train_step_matches_the_reference():
    """The port's step (augmentation off, float32, fused out-of-line DP)
    against the reference's pieces on the same weights and labels: the
    deep-supervision CE, the DP loss, each leaf's gradient (from AdamW's
    first moment) and the DP rows after SparseAdam."""
    model, params = tiny()
    cfg = TrainConfig.tpu_production(compute_dtype="float32", **UNET)
    cw = np.array([0.6, 1.4], np.float32)
    fixed = np.linspace(3.0, 4.0, 6).astype(np.float32)
    state = create_state(model, dataset_len=6, device="cpu")
    model.load_state_dict(params)
    step = make_train_step(model, cfg, cw, fixed, augment=False)
    x, lbl = inputs()
    idx = torch.tensor([4, 1])
    batch = {"image": x[..., 0], "label": lbl, "modified_label": lbl, "dataset_idx": idx}
    state, metrics = step(state, batch, 1e-3, generator=torch.Generator())

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    net = ref.Net(ARCH, p)
    cwt = torch.as_tensor(cw)
    ce, grads, logits = ref.ds_loss_blocked(net, p, x.permute(0, 4, 1, 2, 3), lbl, cwt)
    dp0 = torch.zeros(6)
    dp_vec = dp0.clone().requires_grad_(True)
    dp = ref_train.dp_loss(logits, lbl, dp_vec[idx], torch.as_tensor(fixed)[idx], True)
    (dp_grad,) = torch.autograd.grad(dp, [dp_vec])
    touched = torch.zeros(6, dtype=torch.bool)
    touched[idx] = True
    dp_after, _, _ = ref_train.sparse_adam(dp0, dp_grad, torch.zeros(6), torch.zeros(6), 1,
                                           touched, cfg.lr_inst_param)

    assert abs(float(metrics["ce_loss"]) - ce) / ce < 1e-5
    dp = float(dp.detach())
    assert abs(float(metrics["dp_loss"]) - dp) / abs(dp) < 1e-5
    moments = state.optimizer.state
    # A conv bias right before an InstanceNorm has a gradient of zero up to
    # round-off, so each leaf's gap is over the larger of its own norm and the
    # median leaf's, as the benchmark's `grad_gap` reads it.
    median = float(np.median([float(g.norm()) for g in grads.values() if g is not None]))
    skipped = {n for n, g in grads.items() if g is None}
    assert skipped == {"heads.1.weight", "heads.1.bias"}  # the head of weight 0
    for name, prm in state.model.named_parameters():
        if name in skipped:
            assert prm not in moments and torch.equal(prm.detach(), params[name])
            continue
        g = moments[prm]["exp_avg"] / (1 - ref_train.BETAS[0])
        gap = float((g.double() - grads[name].double()).norm())
        assert gap / max(float(grads[name].norm()), median) < 1e-5, name
    assert rel(state.dp_params, dp_after) < 1e-5
    assert torch.equal(state.dp_params[~touched], dp0[~touched])


def test_strict_step_reads_the_dp_loss_after_the_update():
    """Strict out-of-line DP (TrainConfig's default `ool_mode`): the DP
    loss reads a second train-mode forward's full-resolution head with the
    updated parameters, which the reference computes from the step's own
    parameters afterwards (InstanceNorm keeps no statistics to advance)."""
    model, params = tiny()
    cfg = TrainConfig(compute_dtype="float32", use_fixed_weighting=True, **UNET)
    assert cfg.ool_mode == "strict"
    fixed = np.linspace(3.0, 4.0, 6).astype(np.float32)
    state = create_state(model, dataset_len=6, device="cpu")
    model.load_state_dict(params)
    step = make_train_step(model, cfg, np.array([0.6, 1.4], np.float32), fixed,
                           augment=False)
    x, lbl = inputs(seed=1)
    idx = torch.tensor([2, 5])
    batch = {"image": x[..., 0], "label": lbl, "modified_label": lbl, "dataset_idx": idx}
    state, metrics = step(state, batch, 1e-3, generator=torch.Generator())

    after = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    assert not torch.equal(after["encoder.0.0.conv.weight"], params["encoder.0.0.conv.weight"])
    with torch.no_grad():
        logits = ref.Net(ARCH, after)(x.permute(0, 4, 1, 2, 3))
        dp = ref_train.dp_loss(logits, lbl, torch.zeros(6)[idx], torch.as_tensor(fixed)[idx],
                               cfg.use_risk_regularization)
    assert abs(float(metrics["dp_loss"]) - float(dp)) / abs(float(dp)) < 1e-5


def test_published_width_parameter_count():
    model = PlainConvUNet3D()
    assert sum(p.numel() for p in model.parameters()) == 30_785_994
    published = {**ARCH, "features": [32, 64, 128, 256, 320, 320],
                 "strides": [[1, 1, 1]] + [[2, 2, 2]] * 4 + [[2, 2, 1]]}
    assert ref.parameter_count(published) == 30_785_994
    assert model.divisor() == (32, 32, 16)


def test_init_weights_is_he_with_zero_biases():
    model = PlainConvUNet3D(features=(32, 64, 128), strides=STRIDES)
    for p in model.parameters():
        torch.nn.init.normal_(p)
    init_weights(model, torch.Generator().manual_seed(3))
    gain = math.sqrt(2.0 / (1.0 + 1e-2**2))
    convs = [(n, p) for n, p in model.named_parameters() if p.dim() == 5]
    assert len(convs) == 3 * 2 + 2 * 3 + 2
    for name, w in convs:
        if w.numel() < 4096:  # the one-channel input conv and the heads: too few draws
            continue
        want = gain / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
        assert abs(float(w.detach().std()) / want - 1) < 0.05, name
    for mod in model.modules():
        if isinstance(mod, InstanceNorm):
            assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0)
    assert all(torch.all(p == 0) for n, p in model.named_parameters() if n.endswith("bias")
               and ".norm." not in n)


def test_indivisible_extent_is_refused():
    model, _ = tiny()
    with pytest.raises(ValueError, match=r"divisible by \(4, 4, 2\).*\(16, 14, 8\)"):
        model(torch.zeros(1, 16, 14, 8, 1))


@pytest.mark.parametrize("bad", [
    dict(bn_mode="async"), dict(bn_mode="slab"), dict(use_checkpointing=True),
    dict(use_2d_normal_to="D"), dict(mesh_data_axis=2), dict(mesh_model_axis=2),
    dict(mesh_space_axis=2), dict(mesh_pipe_stages=2), dict(checkpoint_backend="orbax"),
    dict(use_ool_dp_loss=False),
])
def test_config_refuses_what_the_network_cannot_run(bad):
    with pytest.raises(ValueError, match="plainconvunet3d"):
        TrainConfig(**{**UNET, **bad})


def test_config_arch_names_and_defaults():
    with pytest.raises(ValueError, match="model_arch"):
        TrainConfig(model_arch="unet")
    for cfg in (TrainConfig(), TrainConfig.tpu_production()):
        model, _ = driver.make_model(cfg, 2)
        assert type(model) is MobileNetLRASPP3D
        assert "model_arch" not in cfg.to_dict()
    cfg = TrainConfig.tpu_production(**UNET)
    model, _ = driver.make_model(cfg, 2)
    assert type(model) is PlainConvUNet3D and model.dtype == torch.bfloat16
    assert TrainConfig.from_dict(cfg.to_dict()).model_arch == "plainconvunet3d"


def test_state_pt_round_trips_and_jax_formats_refuse(tmp_path):
    model, _ = tiny()
    cfg = TrainConfig.tpu_production(compute_dtype="float32", **UNET)
    state = create_state(model, dataset_len=4, seed=5, device="cpu")
    step = make_train_step(model, cfg, np.ones(2, np.float32), np.ones(4, np.float32),
                           augment=False)
    x, lbl = inputs()
    batch = {"image": x[..., 0], "label": lbl, "modified_label": lbl,
             "dataset_idx": torch.tensor([0, 3])}
    state, _ = step(state, batch, 1e-3, generator=torch.Generator())
    ckpt.save_checkpoint(tmp_path / "a", state, cfg)
    fresh = create_state(PlainConvUNet3D(2, 1, FEATURES, STRIDES), dataset_len=4, seed=9,
                         device="cpu")
    back = ckpt.restore_checkpoint(tmp_path / "a", fresh)
    for (n, a), b in zip(state.model.state_dict().items(), back.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert torch.equal(back.dp_params, state.dp_params) and back.step == state.step
    assert ckpt.load_config(tmp_path / "a").model_arch == "plainconvunet3d"
    with pytest.raises(ValueError, match="no JAX counterpart"):
        ckpt.save_jax_checkpoint(tmp_path / "b", state, cfg)
    with pytest.raises(ValueError, match="no JAX counterpart"):
        ckpt.save_checkpoint(tmp_path / "c", state, None, backend="orbax")
    assert not (tmp_path / "b" / "state.msgpack").exists()


def test_spans_and_counters_under_record():
    model, _ = tiny()
    cfg = TrainConfig.tpu_production(compute_dtype="float32", **UNET)
    state = create_state(model, dataset_len=4, device="cpu")
    step = make_train_step(model, cfg, np.ones(2, np.float32), np.ones(4, np.float32),
                           augment=False)
    x, lbl = inputs()
    batch = {"image": x[..., 0], "label": lbl, "modified_label": lbl,
             "dataset_idx": torch.tensor([0, 3])}
    rec = tracing.record()
    try:
        step(state, batch, 1e-3, generator=torch.Generator())
    finally:
        rec.stop()
    summary = rec.summary()
    spans = summary["spans"]
    for name in ("unet.encoder", "unet.decoder", "unet.heads"):
        assert spans[f"step.forward/{name}"]["calls"] == 1
    assert spans["step.forward/step.ds_loss"]["calls"] == 1
    # Two heads at this depth, the second of weight 0: one loss computed.
    assert summary["counters"]["ds_heads"] == {"step.forward/step.ds_loss": 1}
    flops = summary["counters"]["unet.conv_flops"]
    assert sum(flops.values()) == ref.forward_flops(ARCH, 2, SPATIAL)
    assert set(flops) == {"step.forward/unet.encoder", "step.forward/unet.decoder",
                          "step.forward/unet.heads"}


def test_train_dl_trains_the_network(tmp_path, monkeypatch):
    """`train_dl` end to end with `model_arch='plainconvunet3d'` at the tiny
    width: every step's losses finite, the weights moved, the snapshot
    written, and the model's eval forward at validation's x2.0 scale."""
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.train.prepare import prepare_data

    generate_synthetic_crossmoda(str(tmp_path / "d"), num_cases=3, atlas_count=2,
                                 size=(16, 16, 8), seed=1)
    monkeypatch.setattr(driver, "PlainConvUNet3D",
                        lambda **kw: PlainConvUNet3D(features=FEATURES, strides=STRIDES, **kw))
    cfg = TrainConfig.tpu_production(
        dataset="synthetic", reg_state="synthetic", dataset_directory=str(tmp_path / "d"),
        crop_3d_w_dim_range=None, epochs=2, batch_size=2, num_val_images=1,
        output_dir=str(tmp_path / "out"), mdl_save_prefix=str(tmp_path / "m"), **UNET)
    dataset, atlas_count = prepare_data(cfg)
    before = PlainConvUNet3D(features=FEATURES, strides=STRIDES)
    init_weights(before, torch.Generator().manual_seed(cfg.seed))
    res = driver.train_dl("unet", cfg, dataset, atlas_count, device="cpu")[0]
    state = res["state"]
    assert type(state.model) is PlainConvUNet3D and state.step == 4
    moved = [n for (n, a), b in zip(state.model.state_dict().items(),
                                    before.state_dict().values()) if not torch.equal(a, b)]
    # Every parameter but those of the head of weight 0, which get no gradient.
    assert sorted(set(before.state_dict()) - set(moved)) == ["heads.1.bias", "heads.1.weight"]
    assert np.isfinite(state.dp_params.numpy()).all()
    assert res["snapshot_path"].is_file()
    assert (tmp_path / "m" / "unet_fold0_epx1" / "state.pt").is_file()
