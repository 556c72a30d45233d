"""The 2D path (`use_2d_normal_to`) of the port against the JAX package, on
the CPU: the stacking helpers, the LR-ASPP MobileNetV3 model with weights
carried by `models/interop.py`, the 2D sampler and augmentation with JAX's
draws, the 2D train step (augmentation off, and on with injected draws), the
2D eval step, the 2D AFFINE disturbance and `train_dl` in 2D on the
synthetic fixture of `tests/test_2d_path.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.core.config import TrainConfig as JaxConfig
from deep_staple_tpu.models.lraspp2d import LRASPPMobileNetV3Large2D as Jax2D
from deep_staple_tpu.ops import augment as jaug
from deep_staple_tpu.ops import grid_sample as jgs
from deep_staple_tpu.ops import stacking as jstack
from deep_staple_tpu.train import optim as joptim
from deep_staple_torch.core.config import LabelDisturbanceMode, TrainConfig
from deep_staple_torch.data import disturbance as pdist
from deep_staple_torch.models import LRASPPMobileNetV3Large2D
from deep_staple_torch.models.interop import (
    load_flax_variables, state_dict_to_flax, state_from_jax,
)
from deep_staple_torch.models.lraspp2d import init_weights
from deep_staple_torch.ops import augment as aug
from deep_staple_torch.ops import grid_sample as pgs
from deep_staple_torch.ops import stacking as pstack
from torch_port_state import _perturb, jax_state

torch.set_num_threads(1)

CW = np.array([0.5, 1.5], np.float32)
N = 6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("stack_dim", ["D", "H", "W"])
def test_stacking_round_trip_matches_jax(stack_dim):
    x = np.arange(2 * 3 * 4 * 5 * 6, dtype=np.int32).reshape(2, 3, 4, 5, 6)
    got = pstack.make_2d_stack_from_3d(_t(x), stack_dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jstack.make_2d_stack_from_3d(
        jnp.asarray(x), stack_dim)))
    assert pstack.get_2d_stack_batch_size(x.shape, stack_dim) == got.shape[0] == \
        jstack.get_2d_stack_batch_size(x.shape, stack_dim)
    np.testing.assert_array_equal(pstack.make_3d_from_2d_stack(got, stack_dim, 2).numpy(), x)
    with pytest.raises(ValueError, match="must be 'D' or 'H' or 'W'"):
        pstack.make_2d_stack_from_3d(_t(x), "Q")


def _variables(seed, in_ch=1):
    """Port 2D model from `init_weights` and its Flax variables, BatchNorm
    statistics moved off their init."""
    model = LRASPPMobileNetV3Large2D(num_classes=2, in_channels=in_ch)
    init_weights(model, torch.Generator().manual_seed(seed))
    v = state_dict_to_flax(model.state_dict())
    return model, {"params": v["params"],
                   "batch_stats": _perturb(v["batch_stats"], np.random.RandomState(seed))}


def test_lraspp2d_eval_logits_match_jax():
    """Logits at 40x48 with Flax variables (JAX's tree, numpy values drawn
    at the scale of the initializers) carried across, the parameter count
    and names, and the state_dict's way back."""
    jm = Jax2D(num_classes=2)
    x = np.random.RandomState(1).randn(2, 40, 48, 1).astype(np.float32)
    rng = np.random.RandomState(2)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def draw(path, a):
        if path[-1].key == "kernel":  # fan-in scaled, as the initializers
            return (rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)
        return (rng.rand(*a.shape) * 0.2 + (0.9 if path[-1].key in ("scale", "var") else -0.1)
                ).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    variables = {k: dict(v) for k, v in variables.items()}
    model = load_flax_variables(LRASPPMobileNetV3Large2D(num_classes=2), variables).eval()
    assert sum(p.numel() for p in model.parameters()) == 3_218_020
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a)["out"])(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(_t(x))["out"]
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 40, 48, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    back = state_dict_to_flax(model.state_dict())
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(variables)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode, padding", [("bilinear", "border"), ("nearest", "zeros")])
def test_grid_sample_2d_matches_jax(mode, padding):
    """The image's and the labels' samplers of the 2D warp, at a grid that
    reaches outside the image."""
    rng = np.random.RandomState(3)
    inp = rng.randn(2, 3, 9, 11).astype(np.float32)
    theta = (np.eye(2, 3)[None] + 0.3 * rng.randn(2, 2, 3)).astype(np.float32)
    grid = pgs.affine_grid_2d(_t(theta), (7, 13))
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgs.affine_grid_2d(
        jnp.asarray(theta), (7, 13))), rtol=0, atol=1e-6)
    got = pgs.grid_sample_2d(_t(inp), grid, mode, padding)
    want = jgs.grid_sample_2d(jnp.asarray(inp), jnp.asarray(grid.numpy()), mode=mode,
                              padding_mode=padding, align_corners=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="Unsupported"):
        pgs.grid_sample_2d(_t(inp), grid, mode, "reflection")


def _jax_parts_2d(key, B, spatial, params):
    """The 2D warp's parts JAX's make_augment_grid draws from `key`
    (`augment.py:123-147`): (eff_theta (B, 2, 3), ctl (B, 2, n, n) with the
    b-spline coin folded in)."""
    k_coin_b, k_coin_a, k_bspline, k_affine, k_dir = jax.random.split(key, 5)
    do_b = (jax.random.uniform(k_coin_b, (B,)) < params.bspline_probability).astype(jnp.float32)
    do_a = (jax.random.uniform(k_coin_a, (B,)) < params.affine_probability).astype(jnp.float32)
    n = params.bspline_num_ctl_points
    ctl = jax.random.normal(k_bspline, (B, 2, n, n), jnp.float32)
    ctl = ctl * (jnp.array(spatial, jnp.float32) * params.bspline_strength * 0.5).reshape(1, 2, 1, 1)
    for _ in range(3):
        ctl = jaug._avg_pool_same(ctl, 2)
    eye = jnp.broadcast_to(jnp.eye(2, 3, dtype=jnp.float32), (B, 2, 3))
    theta = eye + params.affine_strength * jax.random.normal(k_affine, (B, 2, 3), jnp.float32)
    alpha = jax.random.uniform(k_dir, (B,)) * 2 * jnp.pi
    theta = theta.at[:, :, -1].set(params.add_affine_translation
                                   * jnp.stack([jnp.cos(alpha), jnp.sin(alpha)], axis=-1))
    eff_theta = eye + do_a[:, None, None] * (theta - eye)
    return _t(eff_theta), _t(ctl * do_b.reshape(B, 1, 1, 1))


def _jax_draws_2d(key, B, base, params, factor=2.0):
    """What JAX's augment_sample_pair draws from `key` in 2D."""
    k_noise, k_spatial = jax.random.split(key)
    noise = jax.random.normal(k_noise, (B, *base), jnp.float32)
    return aug.AugmentDraws(_t(noise), *_jax_parts_2d(k_spatial, B, aug.post_spatial(base, factor),
                                                      params))


def _strong():
    return jaug.AugmentParams(bspline_probability=1.0, affine_probability=1.0,
                              add_affine_translation=0.1)


def _slices(seed, B=3, base=(16, 16)):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, *base).astype(np.float32)
    lbl = np.zeros((B, *base), np.int32)
    lbl[:, 4:11, 3:10] = 1
    return img, lbl, np.roll(lbl, 2, axis=1)


def test_augment_2d_matches_jax():
    """Every order takes the reference path in 2D; the draws' distribution
    follows the 2D branch (a (B, 2, 3) affine, a (B, 2, n, n) field)."""
    B, key, params = 3, jax.random.PRNGKey(4), _strong()
    img, lbl, mod = _slices(5, B)
    draws = _jax_draws_2d(key, B, img.shape[1:], params)
    mine = aug.draw_augment(torch.Generator().manual_seed(0), img.shape, aug.AugmentParams(*params),
                            2.0)
    assert tuple(mine.eff_theta.shape) == (B, 2, 3) and tuple(mine.ctl.shape) == (B, 2, 6, 6)
    for order in ("reference", "fast-int6"):
        want = jax.jit(jaug.augment_sample_pair, static_argnames=(
            "params", "pre_interpolation_factor", "use_2d", "order"))(
            key, jnp.asarray(img), jnp.asarray(lbl), jnp.asarray(mod), params=params,
            pre_interpolation_factor=2.0, use_2d=True, order=order)
        got = aug.augment_sample_pair(_t(img), _t(lbl), _t(mod), draws, aug.AugmentParams(*params),
                                      2.0, order, use_2d=True)
        assert tuple(got[0].shape) == (B, 32, 32) and got[1].dtype == torch.int32
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
        for g, w in zip(got[1:3], want[1:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _step_pair(augment, seed):
    """One fused out-of-line 2D step in JAX and in the port from one state."""
    from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
    from deep_staple_torch.train.step import make_train_step

    kw = dict(use_2d_normal_to="D", ool_mode="fused", use_checkpointing=False)
    model, variables = _variables(seed)
    rng = np.random.RandomState(seed)
    dp0 = (rng.randn(N) * 0.1).astype(np.float32)
    fixed = (4.0 + rng.rand(N)).astype(np.float32)
    img, lbl, mod = _slices(seed, 3, (16, 16) if augment else (32, 32))
    batch = {"image": img, "label": lbl, "modified_label": mod,
             "dataset_idx": np.array([1, 4, 2], np.int32)}
    tx = joptim.make_model_optimizer(0.01)
    jstate = jax_state(variables, dp0, tx, warm=True)
    key = jax.random.PRNGKey(seed)
    jstep = jax_make_train_step(Jax2D(num_classes=2), tx, JaxConfig(**kw), CW, fixed,
                                pre_interpolation_factor=2.0, augment=augment)
    jnew, jmet = jstep(jstate, batch, 0.01, key)
    draws = None
    if augment:  # the JAX step augments with the first of its key's three parts
        draws = _jax_draws_2d(jax.random.split(key, 3)[0], 3, (16, 16), jaug.AugmentParams())
    pstate = state_from_jax(jax.tree.map(np.asarray, jstate), model, device="cpu")
    step = make_train_step(model, TrainConfig(**kw), CW, fixed, pre_interpolation_factor=2.0,
                           augment=augment)
    pnew, pmet = step(pstate, {k: _t(v) for k, v in batch.items()}, 0.01, draws=draws)
    return jnew, jmet, pnew, pmet, dp0


@pytest.mark.parametrize("augment", [False, True])
def test_2d_train_step_matches_jax(augment):
    """Losses to 1e-4, the DP vector to 1e-4 of its step, the batch's
    running statistics and the Dice."""
    jnew, jmet, pnew, pmet, dp0 = _step_pair(augment, 6 + augment)
    np.testing.assert_allclose(float(pmet["ce_loss"]), float(jmet["ce_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(pmet["dp_loss"]), float(jmet["dp_loss"]), rtol=1e-4)
    step = np.abs(np.asarray(jnew.dp_params) - dp0).max()
    np.testing.assert_allclose(pnew.dp_params.numpy(), np.asarray(jnew.dp_params), rtol=0,
                               atol=1e-4 * step + 1e-7)
    np.testing.assert_allclose(pmet["dice"].numpy(), np.asarray(jmet["dice"]), atol=2e-3)
    got = state_dict_to_flax(pnew.model.state_dict())["batch_stats"]
    want = jax.tree.map(np.asarray, jnew.batch_stats)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max())
    assert pnew.step == 1


def test_2d_eval_step_matches_jax():
    """A full 3D volume at x2.0, sliced along D, H or W through the 2D model
    and restacked, scored in 3D."""
    from deep_staple_tpu.train.state import DeepStapleState as JaxState
    from deep_staple_tpu.train.step import make_eval_step as jax_make_eval_step
    from deep_staple_torch.train.step import make_eval_step

    model, variables = _variables(8)
    model = load_flax_variables(model, variables).eval()
    rng = np.random.RandomState(9)
    img = rng.randn(1, 8, 16, 12).astype(np.float32)
    lbl = (rng.rand(1, 8, 16, 12) > 0.6).astype(np.int32)
    jstate = JaxState(step=0, sched_steps=0, params=variables["params"],
                      batch_stats=variables["batch_stats"], opt_state=None, dp_params=None,
                      dp_opt_state=None)
    for stack_dim in ("D", "W"):
        jpred, jdice = jax_make_eval_step(Jax2D(num_classes=2), JaxConfig(use_2d_normal_to=stack_dim),
                                          2)(jstate, {"image": jnp.asarray(img),
                                                      "label": jnp.asarray(lbl)})
        pred, dice = make_eval_step(model, TrainConfig(use_2d_normal_to=stack_dim), 2)(
            {"image": _t(img), "label": _t(lbl)})
        assert pred.dtype == torch.int32 and tuple(pred.shape) == (1, 16, 32, 24)
        assert (pred.numpy() == np.asarray(jpred)).mean() >= 0.999
        np.testing.assert_allclose(dice.numpy(), np.asarray(jdice), rtol=0, atol=2e-3)


@pytest.mark.parametrize("strength", [0.5, 1.0])
def test_2d_affine_disturbance(strength):
    """AFFINE on a slice: the port's warp on JAX's draws against JAX's label,
    and with its own draws deterministic per seed, binary, of the slice's
    shape and moved (as the 3D case)."""
    from deep_staple_tpu.core.config import LabelDisturbanceMode as JaxMode
    from deep_staple_tpu.data import disturbance as jdist

    lbl = np.zeros((20, 18), np.int32)
    lbl[5:13, 4:11] = 1
    seed = 7
    want = jdist.disturb_label(lbl, JaxMode.AFFINE, strength, seed, use_2d=True)
    params = jaug.AugmentParams(**pdist.affine_params(strength)._asdict())
    parts = _jax_parts_2d(jax.random.PRNGKey(seed), 1, lbl.shape, params)
    draws = aug.AugmentDraws(torch.zeros((1, *lbl.shape)), *parts)
    got = pdist.disturb_label(lbl, LabelDisturbanceMode.AFFINE, strength, seed, use_2d=True,
                              draws=draws)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got == want).mean() >= 0.999
    a = pdist.disturb_label(lbl, LabelDisturbanceMode.AFFINE, strength, seed, use_2d=True)
    np.testing.assert_array_equal(
        a, pdist.disturb_label(lbl, LabelDisturbanceMode.AFFINE, strength, seed, use_2d=True))
    assert a.shape == lbl.shape and a.dtype == lbl.dtype and set(np.unique(a)) <= {0, 1}
    assert not np.array_equal(a, lbl)
    assert not np.array_equal(a, pdist.disturb_label(lbl, LabelDisturbanceMode.AFFINE, strength,
                                                     seed + 1, use_2d=True))


def test_train_dl_2d(tmp_path, monkeypatch):
    """`train_dl` in 2D on the fixture of `tests/test_2d_path.py` (3 cases x
    2 atlases at 8x16x16, slices along D), 2 epochs on the CPU: the training
    ids are the slices of the training volumes as JAX picks them, the sample
    metrics are JAX's, the learning rate follows the cosine warm restarts,
    validation scores 3D volumes, and the snapshot holds DP-sorted slices at
    the x2.0 eval scale, which the consensus stage reads."""
    from deep_staple_tpu.train import driver as jd
    from deep_staple_tpu.train.prepare import prepare_data as jax_prepare
    from deep_staple_torch.consensus.evaluate import evaluate_consensus
    from deep_staple_torch.data.snapshot_io import load_snapshot
    from deep_staple_torch.data.synthetic import generate_synthetic_crossmoda
    from deep_staple_torch.train import driver as pd
    from deep_staple_torch.train.prepare import prepare_data

    generate_synthetic_crossmoda(tmp_path / "ds", num_cases=3, atlas_count=2, size=(8, 16, 16),
                                 seed=0)
    kw = dict(dataset="synthetic", reg_state="synthetic", dataset_directory=str(tmp_path / "ds"),
              crop_3d_w_dim_range=None, use_2d_normal_to="D", use_checkpointing=False,
              epochs=2, batch_size=8, num_val_images=1, log_jsonl=False,
              output_dir=str(tmp_path / "out"), mdl_save_prefix=str(tmp_path / "models"))
    cfg = TrainConfig(**kw)
    dataset, atlas_count = prepare_data(cfg)
    jds, _ = jax_prepare(JaxConfig(**kw))
    assert len(dataset) == len(jds) == 6 * 8 and dataset[0]["image"].shape == (16, 16)

    lrs = []
    monkeypatch.setattr(pd, "exp_lr", lambda *a: pytest.fail("exp_lr in 2D"))
    cosine = pd.cosine_warm_restarts_lr
    monkeypatch.setattr(pd, "cosine_warm_restarts_lr", lambda *a: lrs.append(cosine(*a)) or lrs[-1])
    res = pd.train_dl("r2d", cfg, dataset, atlas_count, device="cpu")[0]

    train_3d = set(range(2, 6))  # the first atlas_count 3D indices validate
    want_ids = [d["2d_id"] for d in jds.get_id_dicts() if d["3d_dataset_idx"] in train_3d]
    np.testing.assert_array_equal(res["train_idxs"], jds.switch_2d_identifiers(want_ids))
    assert len(res["train_idxs"]) == 4 * 8
    want = jd.precompute_sample_metrics(jds, res["train_idxs"], 2, True)
    got = pd.precompute_sample_metrics(dataset, res["train_idxs"], 2, True, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # 32 slices at batch 8, two epochs; the scheduler steps per batch in the
    # epochs where epx % atlas_count == 0, here epoch 0 only.
    assert lrs == [cosine(cfg.lr, k) for k in range(4)] + [cosine(cfg.lr, 4)] * 4
    history = res["writer"].history
    assert any("scores/val_dice_mean_wo_bg_fold0" in h for h in history)

    snap = load_snapshot(res["snapshot_path"])
    assert snap["train_predictions"].shape == (32, 32, 32)
    assert snap["labels"].shape == snap["modified_labels"].shape == (32, 32, 32)
    assert list(snap["data_parameters"]) == sorted(snap["data_parameters"])
    assert all(d.endswith(tuple(f"D{k:03d}" for k in range(8))) for d in snap["d_ids"])
    dp = res["state"].dp_params.numpy()
    moved = np.flatnonzero(dp != cfg.init_inst_param)
    assert set(moved) <= set(res["train_idxs"]) and len(moved) > 0
    assert len(evaluate_consensus(res["snapshot_path"], staple_max_iterations=3, device="cpu")) > 0
