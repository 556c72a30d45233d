"""The port's augmentation (the 'reference' and 'fast-sep' orders, K1's plain
pass) against the JAX package, on the CPU.

The JAX side draws its random numbers from a key; the same numbers (the
unit-normal noise and the warp's parts `(eff_theta, ctl)`) are handed to the
port as `AugmentDraws`. K1 itself is held against `sep_warp_pass_plain` on
the card by `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.ops import augment as jaug
from deep_staple_tpu.ops import sep_warp as jsep
from deep_staple_torch.ops import augment as aug
from deep_staple_torch.ops import sep_warp as sep

torch.set_num_threads(1)

BASE = (12, 10, 8)
FACTOR = 1.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(key, B, base=BASE, params=jaug.AugmentParams()):
    """The numbers JAX's augment_sample_pair draws from `key`."""
    k_noise, k_spatial = jax.random.split(key)
    noise = jax.random.normal(k_noise, (B, *base), jnp.float32)
    out = aug.post_spatial(base, FACTOR)
    eff_theta, ctl = jaug.make_augment_parts(k_spatial, B, base, params, strength_spatial=out)
    return aug.AugmentDraws(_t(noise), _t(eff_theta), _t(ctl))


def _batch(seed, B=2, base=BASE):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, *base).astype(np.float32)
    lbl = np.zeros((B, *base), np.int32)
    lbl[:, 3:9, 2:8, 2:6] = 1
    mod = np.roll(lbl, 1, axis=2)
    return img, lbl, mod


def _strong_params():
    # Affine and b-spline on in every sample, so that both parts are exercised.
    return jaug.AugmentParams(bspline_probability=1.0, affine_probability=1.0,
                              add_affine_translation=0.1)


def _ulp(a):
    return np.spacing(np.abs(a).astype(np.float32))


def test_sep_pass_plain_matches_xla():
    rng = np.random.RandomState(0)
    for L in (50, 7, 1):
        n = 6
        img = rng.randn(n, L).astype(np.float32) * 900
        code = rng.randint(0, 4, (n, L)).astype(np.int32)
        word = jsep._pack_pass(jnp.asarray(img), jnp.asarray(code), 1.0)
        cc = rng.uniform(-3, L + 2, (n, L)).astype(np.float32)
        cc[:, :4] = np.array([-0.5, 0.5, L - 0.5, L - 1.5], np.float32)[: cc.shape[1]] \
            if L >= 4 else cc[:, :4]
        want_img, want_code = jsep._sep_pass_xla(word, jnp.asarray(cc), L)
        got_word = sep.pack_pass(_t(img), _t(code), torch.tensor(1.0))
        np.testing.assert_array_equal(got_word.numpy().view(np.uint32), np.asarray(word))
        got_img, got_code = sep.sep_warp_pass(got_word, _t(cc), L)
        np.testing.assert_array_equal(got_code.numpy(), np.asarray(want_code))
        diff = np.abs(got_img.numpy() - np.asarray(want_img))
        assert (diff <= _ulp(np.asarray(want_img))).all(), diff.max()


def test_sep_warp_fields_match_jax():
    B = 3
    draws = _jax_draws(jax.random.PRNGKey(1), B, params=_strong_params())
    want = jsep.sep_warp_fields(jnp.asarray(draws.eff_theta.numpy()), jnp.asarray(draws.ctl.numpy()), BASE)
    got = sep.sep_warp_fields(draws.eff_theta, draws.ctl, BASE)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, *BASE)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_sep_warp_apply_matches_jax():
    B = 2
    draws = _jax_draws(jax.random.PRNGKey(2), B, params=_strong_params())
    img, lbl, mod = _batch(3, B)
    fields = jsep.sep_warp_fields(jnp.asarray(draws.eff_theta.numpy()), jnp.asarray(draws.ctl.numpy()), BASE)
    want = jsep.sep_warp_apply(jnp.asarray(img), jnp.asarray(lbl), jnp.asarray(mod), fields, impl="xla")
    got = sep.sep_warp_apply(_t(img), _t(lbl), _t(mod), sep.SepWarpFields(*(_t(f) for f in fields)))
    for g, w in zip(got[1:], want[1:]):
        assert (g.numpy() == np.asarray(w)).mean() >= 0.999
    quantum = np.abs(img).reshape(B, -1).max(1).reshape(B, 1, 1, 1) / 2047.0
    assert (np.abs(got[0].numpy() - np.asarray(want[0])) <= quantum).all()


def test_reference_warps_match_jax():
    B = 2
    draws = _jax_draws(jax.random.PRNGKey(4), B, params=_strong_params())
    img, lbl, mod = _batch(5, B)
    grid = aug.make_augment_grid(draws, BASE)
    jgrid = jaug.affine_grid_3d(jnp.asarray(draws.eff_theta.numpy()), BASE) + \
        jaug._bspline_field_from_ctl(jnp.asarray(draws.ctl.numpy()), BASE)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), rtol=1e-6, atol=1e-6)
    jgrid = jnp.asarray(grid.numpy())
    np.testing.assert_allclose(
        aug.warp_trilinear_border(_t(img), grid).numpy(),
        np.asarray(jaug._warp_trilinear_border(jnp.asarray(img), jgrid)), rtol=1e-5, atol=1e-6)
    packed = (lbl + 256 * mod).astype(np.float32)
    np.testing.assert_array_equal(
        aug.warp_nearest_zeros(_t(packed), grid).numpy(),
        np.asarray(jaug._warp_nearest_zeros(jnp.asarray(packed), jgrid)))


def test_ctl_smoothing_matches_jax():
    B, n = 2, 6
    key = jax.random.PRNGKey(6)
    out = aug.post_spatial(BASE, FACTOR)
    normal = jax.random.normal(jax.random.split(key, 5)[2], (B, 3, n, n, n), jnp.float32)
    want = jaug._bspline_ctl_3d(jax.random.split(key, 5)[2], B, n, 0.03, out)
    got = aug.smooth_ctl(_t(normal), 0.03, out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("order", ["reference", "fast-sep"])
def test_augment_sample_pair_matches_jax(order):
    B = 2
    key = jax.random.PRNGKey(7)
    params = _strong_params()
    img, lbl, mod = _batch(8, B)
    want = jaug.augment_sample_pair(key, jnp.asarray(img), jnp.asarray(lbl), jnp.asarray(mod),
                                    params=params, pre_interpolation_factor=FACTOR, order=order)
    draws = _jax_draws(key, B, params=params)
    got = aug.augment_sample_pair(_t(img), _t(lbl), _t(mod), draws, aug.AugmentParams(*params),
                                  FACTOR, order)
    out = (B, *aug.post_spatial(BASE, FACTOR))
    assert tuple(got[0].shape) == tuple(got[1].shape) == out and got[1].dtype == torch.int32
    for g, w in zip(got[1:3], want[1:3]):
        assert (g.numpy() == np.asarray(w)).mean() >= 0.999
    if order == "reference":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    else:
        quantum = np.abs(img + 0.05 * draws.noise.numpy()).max() / 2047.0
        assert np.abs(got[0].numpy() - np.asarray(want[0])).max() <= quantum
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-5, atol=1e-5)


def test_draws_follow_the_generator():
    gen = torch.Generator().manual_seed(3)
    a = aug.draw_augment(gen, (4, *BASE))
    b = aug.draw_augment(torch.Generator().manual_seed(3), (4, *BASE))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert tuple(a.noise.shape) == (4, *BASE) and tuple(a.eff_theta.shape) == (4, 3, 4)
    assert tuple(a.ctl.shape) == (4, 3, 6, 6, 6)
    c = aug.draw_augment(gen, (4, *BASE))
    assert not torch.equal(a.noise, c.noise)
    never = aug.AugmentParams(bspline_probability=0.0, affine_probability=0.0)
    d = aug.draw_augment(gen, (4, *BASE), never)
    assert torch.equal(d.ctl, torch.zeros_like(d.ctl))
    assert torch.equal(d.eff_theta, torch.eye(3, 4).expand(4, 3, 4))


@pytest.mark.parametrize("order", ["fast", "fast-int6", "reference-bf16"])
def test_unported_orders_raise(order):
    img, lbl, mod = _batch(9, 1)
    draws = aug.draw_augment(torch.Generator().manual_seed(0), (1, *BASE))
    with pytest.raises(NotImplementedError, match="later slice"):
        aug.augment_sample_pair(_t(img), _t(lbl), _t(mod), draws, order=order)
