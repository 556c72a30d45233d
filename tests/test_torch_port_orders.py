"""The augment orders beyond 'reference' and 'fast-sep' against the JAX
package, on the CPU: the three packed warps on the same volume and grid
(random and edge-exact coordinates), `augment_sample_pair` in every order
with JAX's draws ('fast-sep' in `test_torch_port_augment.py`), the int6
noise budget, 'fast' against 'reference' under the identity warp, and a
fused train step in 'fast-int8' on three classes.

Tolerances: labels exact; the 'fast' and 'reference' images to 1e-5; the
packed images (bfloat16, int8, int6 quanta) to one quantum on at most 1e-4
of the voxels and 1e-5 elsewhere. The 'reference-bf16' and 'reference-int8'
orders quantize after the x1.5 interpolation, where `F.interpolate` and
JAX's matrix resize round apart by up to 2e-6; that moves about 0.3% of the
voxels by one quantum end to end, so those two are held to the bound above
on the port's own interpolated image (the composition) and to one quantum on
at most 1% of the voxels against JAX's whole order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.ops import augment as jaug
from deep_staple_torch.ops import augment as aug
from test_torch_port_augment import BASE, FACTOR, _batch, _jax_draws, _strong_params, _t

torch.set_num_threads(1)

PACKED = {
    "bf16": (aug.warp_trilinear_border_bf16pack, jaug._warp_trilinear_border_bf16pack),
    "int8": (aug.warp_trilinear_border_int8pack, jaug._warp_trilinear_border_int8pack),
    "int6": (aug.warp_fused_int6pack, jaug._warp_fused_int6pack),
}


def _quantum(packing, vol):
    """The largest step of one quantum of the packing, per sample (B, 1, 1, 1)."""
    absmax = np.abs(np.asarray(vol)).reshape(len(vol), -1).max(1).reshape(-1, 1, 1, 1)
    return {"bf16": absmax * 2.0 ** -7, "int8": absmax / 127.0, "int6": absmax / 31.0}[packing]


def _assert_within_quantum(got, want, quantum, share=1e-4):
    d = np.abs(np.asarray(got) - np.asarray(want))
    off = d > 1e-5
    assert off.mean() <= share, (off.mean(), d.max())
    assert (d <= quantum * 1.0001 + 1e-5).all(), d.max()


def _warp(packing, fn, vol, lbl, mod, grid):
    if packing == "int6":
        return fn(vol, lbl, mod, grid)
    return (fn(vol, grid),)


def _random_case(seed, B=2, base=(14, 13, 9), out=(10, 11, 7)):
    rng = np.random.RandomState(seed)
    vol = rng.randn(B, *base).astype(np.float32)
    lbl = (rng.rand(B, *base) > 0.8).astype(np.int32)
    mod = (rng.rand(B, *base) > 0.7).astype(np.int32)
    draws = _jax_draws(jax.random.PRNGKey(seed), B, base=out, params=_strong_params())
    return vol, lbl, mod, aug.make_augment_grid(draws, out)


@pytest.mark.parametrize("packing", list(PACKED))
def test_packed_warp_matches_jax(packing):
    """Each packed warp on the same volume and grid as JAX's private
    function: image within one quantum, labels (int6) exact."""
    port, ref = PACKED[packing]
    vol, lbl, mod, grid = _random_case(11)
    got = _warp(packing, port, _t(vol), _t(lbl), _t(mod), grid)
    want = _warp(packing, ref, jnp.asarray(vol), jnp.asarray(lbl), jnp.asarray(mod),
                 jnp.asarray(grid.numpy()))
    assert got[0].dtype == torch.float32 and tuple(got[0].shape) == (2, 10, 11, 7)
    _assert_within_quantum(got[0].numpy(), want[0], _quantum(packing, vol))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("packing", ["exact", *PACKED])
def test_warp_edge_exact_coordinates(packing):
    """x and y exactly on the last voxel (`tests/test_fast_warp.py:75, :149,
    :214`): the pair-clamped corners put the whole weight on the border
    voxel, as JAX's warps and the exact sampler do."""
    B, D, H, W = 1, 4, 4, 4
    vol = np.arange(B * D * H * W, dtype=np.float32).reshape(B, D, H, W)
    lbl = (np.arange(B * D * H * W, dtype=np.int32).reshape(B, D, H, W) % 2)
    grid = np.zeros((B, 2, 2, 2, 3), np.float32)
    grid[..., 0] = (2 * (W - 1) + 1) / W - 1
    grid[..., 1] = (2 * (H - 1) + 1) / H - 1
    port, ref = (aug.warp_trilinear_border, jaug._warp_trilinear_border) if packing == "exact" \
        else PACKED[packing]
    got = _warp(packing, port, _t(vol), _t(lbl), _t(lbl), _t(grid))
    want = _warp(packing, ref, jnp.asarray(vol), jnp.asarray(lbl), jnp.asarray(lbl),
                 jnp.asarray(grid))
    exact = jaug.grid_sample_3d(jnp.asarray(vol)[:, None], jnp.asarray(grid), mode="bilinear",
                                padding_mode="border", align_corners=False)[:, 0]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    quantum = 0.0 if packing == "exact" else float(_quantum(packing, vol).max())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(exact), rtol=0, atol=quantum / 2 + 1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(aug.warp_nearest_zeros(
            _t(lbl.astype(np.float32)), _t(grid))))


def _run_both(order, seed, params=None, factor=FACTOR, B=2):
    key = jax.random.PRNGKey(seed)
    params = params or _strong_params()
    img, lbl, mod = _batch(seed + 1, B)
    want = jaug.augment_sample_pair(key, jnp.asarray(img), jnp.asarray(lbl), jnp.asarray(mod),
                                    params=params, pre_interpolation_factor=factor, order=order)
    draws = _jax_draws(key, B, params=params)
    if factor != FACTOR:
        draws = draws._replace(ctl=torch.zeros_like(draws.ctl))
    got = aug.augment_sample_pair(_t(img), _t(lbl), _t(mod), draws, aug.AugmentParams(*params),
                                  factor, order)
    return img, lbl, mod, draws, got, want


# 'fast-sep' is held the same way by `test_torch_port_augment.py`
# (`test_augment_sample_pair_matches_jax`), within one int12 quantum.
@pytest.mark.parametrize("order", [o for o in aug.ORDERS if o != "fast-sep"])
def test_augment_sample_pair_every_order_matches_jax(order):
    img, _, _, draws, got, want = _run_both(order, 20)
    out = (2, *aug.post_spatial(BASE, FACTOR))
    assert tuple(got[0].shape) == out and tuple(got[1].shape) == out
    assert got[1].dtype == got[2].dtype == torch.int32
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    noisy = img + 0.05 * draws.noise.numpy()
    packing = order.split("-")[1] if "-" in order else None
    if packing is None:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    elif order in ("reference-bf16", "reference-int8"):
        # The composition, on the port's own interpolated image and grid.
        up, _ = aug.interpolate_sample(_t(noisy), None, FACTOR)
        on_port = PACKED[packing][1](jnp.asarray(up.numpy()), jnp.asarray(got[3].numpy()))
        _assert_within_quantum(got[0].numpy(), on_port, _quantum(packing, up.numpy()))
        _assert_within_quantum(got[0].numpy(), want[0], _quantum(packing, up.numpy()), share=1e-2)
    else:
        _assert_within_quantum(got[0].numpy(), want[0], _quantum(packing, noisy))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-5, atol=1e-5)


def test_int6_noise_budget():
    """Per sample, noise strength sqrt(max(s^2 - (absmax / 31)^2 / 12, 0)):
    a sample whose quantizer alone exceeds the budget gets no noise."""
    img = np.stack([np.full(BASE, 0.1, np.float32), np.full(BASE, 6.0, np.float32)])
    got = aug.int6_noise_strength(_t(img), 0.05).numpy().reshape(-1)
    want = np.sqrt(np.maximum(0.05 ** 2 - (np.array([0.1, 6.0]) / 31.0) ** 2 / 12.0, 0.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == 0.0 and got[0] > 0.049
    # End to end under the identity warp at factor 1: what JAX computes.
    never = jaug.AugmentParams(bspline_probability=0.0, affine_probability=0.0)
    for order in ("fast-int6", "reference-int6"):
        img, lbl, _, _, got, want = _run_both(order, 30, params=never, factor=1.0)
        np.testing.assert_array_equal(got[1].numpy(), lbl)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _assert_within_quantum(got[0].numpy(), want[0], _quantum("int6", img + 0.05))


def test_fast_equals_reference_under_identity_warp():
    """With both coins off the warp is the identity, so warping before or
    after the interpolation gives the same volumes (`augment.py:540-541`)."""
    never = aug.AugmentParams(bspline_probability=0.0, affine_probability=0.0)
    img, lbl, mod = _batch(40, 2)
    draws = aug.draw_augment(torch.Generator().manual_seed(4), img.shape, never)
    fast = aug.augment_sample_pair(_t(img), _t(lbl), _t(mod), draws, never, FACTOR, "fast")
    ref = aug.augment_sample_pair(_t(img), _t(lbl), _t(mod), draws, never, FACTOR, "reference")
    np.testing.assert_allclose(fast[0].numpy(), ref[0].numpy(), rtol=0, atol=1e-5)
    for a, b in zip(fast[1:3], ref[1:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_train_step_fast_int8_three_classes_matches_jax():
    """One fused out-of-line step (async BatchNorm, float32, dropout 0) in
    'fast-int8' on three classes, the order the production preset falls back
    to on a non-binary dataset: the port gets the JAX step's draws; the CE
    loss agrees to 1e-4 (as `test_torch_port_step_aug.py`)."""
    from deep_staple_tpu.core.config import TrainConfig as JaxConfig
    from deep_staple_tpu.models import MobileNetLRASPP3D as JaxLRASPP
    from deep_staple_tpu.train import optim as joptim
    from deep_staple_tpu.train.state import DeepStapleState as JaxState
    from deep_staple_tpu.train.step import make_train_step as jax_make_train_step
    from deep_staple_torch.core.config import TrainConfig
    from deep_staple_torch.models import init_weights
    from deep_staple_torch.models.interop import state_dict_to_flax, state_from_jax
    from deep_staple_torch.train.driver import make_model
    from deep_staple_torch.train.step import make_train_step

    B, N, base, nc = 2, 5, (12, 12, 8), 3
    kw = dict(ool_mode="fused", bn_mode="async", use_checkpointing=False, augment_order="fast-int8")
    model, _ = make_model(TrainConfig(**kw), nc)
    model.aspp.dropout_rate = 0.0
    init_weights(model, torch.Generator().manual_seed(1))
    variables = state_dict_to_flax(model.state_dict())
    rng = np.random.RandomState(2)
    img = rng.randn(B, *base).astype(np.float32)
    lbl = np.zeros((B, *base), np.int32)
    lbl[:, 3:9, 2:8, 2:6] = 1
    lbl[:, 1:4, 1:4, 1:4] = 2
    mod = np.roll(lbl, 1, axis=2)
    batch = {"image": img, "label": lbl, "modified_label": mod,
             "dataset_idx": np.array([4, 1], np.int32)}
    cw = np.array([0.5, 1.5, 1.0], np.float32)
    fixed = (4.0 + rng.rand(N)).astype(np.float32)
    dp0 = (rng.randn(N) * 0.1).astype(np.float32)

    jm = JaxLRASPP(num_classes=nc, use_checkpointing=False, dropout_rate=0.0, bn_mode="async")
    tx = joptim.make_model_optimizer(0.01)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxState(
        step=jnp.zeros((), jnp.int32), sched_steps=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), dp_params=jnp.asarray(dp0),
        dp_opt_state=joptim.sparse_adam_init(jnp.asarray(dp0)),
    )
    key = jax.random.PRNGKey(5)
    jstep = jax_make_train_step(jm, tx, JaxConfig(**kw), cw, fixed, augment=True)
    _, jmet = jstep(jstate, batch, 0.01, key)

    draws = _jax_draws(jax.random.split(key, 3)[0], B, base)
    pstate = state_from_jax(jax.tree.map(np.asarray, jstate), model, device="cpu")
    step = make_train_step(model, TrainConfig(**kw), cw, fixed, augment=True)
    _, pmet = step(pstate, {k: _t(v) for k, v in batch.items()}, 0.01, draws=draws)
    assert tuple(pmet["dice"].shape) == (B, nc)
    np.testing.assert_allclose(float(pmet["ce_loss"]), float(jmet["ce_loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(pmet["dp_loss"]), float(jmet["dp_loss"]), rtol=1e-4)
