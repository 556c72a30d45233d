"""The port's augmentation (the 'reference' and 'fast-sep' orders, three of
the others, the separable warp's plain passes and tile plan) against the JAX
package, on the CPU; every order is in `test_torch_port_orders.py`.

The JAX side draws its random numbers from a key; the same numbers (the
unit-normal noise and the warp's parts `(eff_theta, ctl)`) are handed to the
port as `AugmentDraws`. The warp's kernels themselves are held against
`sep_warp_apply_plain` on the card by `chip_smoke.py`.
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


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_sep_pass_plain_matches_xla(axis):
    """The in-place axis pass against JAX's packed word and XLA pass on the
    same data moved to the last axis."""
    rng = np.random.RandomState(axis)
    for L in (50, 7, 2, 1):
        shape = [2, 3, 4, 5]
        shape[axis] = L
        img = rng.randn(*shape).astype(np.float32) * 900
        code = rng.randint(0, 4, shape).astype(np.int32)
        cc = rng.uniform(-3, L + 2, shape).astype(np.float32)
        edges = np.array([-0.5, 0.5, L - 0.5, L - 1.5], np.float32)[:L]
        np.moveaxis(cc, axis, -1)[..., :len(edges)] = edges
        word = jsep._pack_pass(jnp.asarray(np.moveaxis(img, axis, -1)),
                               jnp.asarray(np.moveaxis(code, axis, -1)), 1.0)
        want_img, want_code = (np.moveaxis(np.asarray(a), -1, axis) for a in jsep._sep_pass_xla(
            word, jnp.asarray(np.moveaxis(cc, axis, -1)), L))
        t = sep.encode(_t(img), _t(code))
        gi = np.asarray(word).astype(np.int64)
        np.testing.assert_array_equal(np.moveaxis((t >> 2).numpy(), axis, -1),
                                      ((gi & 0xFFF) ^ 0x800) - 0x800)
        np.testing.assert_array_equal(np.moveaxis((t & 3).numpy(), axis, -1), (gi >> 24) & 3)
        got_img, got_code = sep.sep_axis_pass_plain(t, _t(cc), axis)
        np.testing.assert_array_equal(got_code.numpy(), want_code)
        diff = np.abs(got_img.numpy() - want_img)
        assert (diff <= _ulp(want_img)).all(), diff.max()


def _pack_pass(img, code, scale):
    """The packed word of the port before its passes were fused (the
    counterpart of JAX's `_pack_pass`)."""
    q = torch.round(img / scale).clamp_(-2047, 2047).to(torch.int32) & 0xFFF
    qn = torch.cat([q[..., 1:], q[..., -1:]], dim=-1)
    code = code.to(torch.int32)
    cn = torch.cat([code[..., 1:], code[..., -1:]], dim=-1)
    return q | (qn << 12) | (code << 24) | (cn << 26)


def _packed_pass(word, cc, L):
    """One pass over rows of packed words (the counterpart of `_sep_pass_xla`)."""
    cimg = cc.clamp(0.0, L - 1.0)
    i0 = torch.floor(cimg).to(torch.int32).clamp_(0, max(L - 2, 0))
    w = cimg - i0.float()
    g = torch.gather(word, -1, i0.long())
    v0 = (((g & 0xFFF) ^ 0x800) - 0x800).float()
    v1 = ((((g >> 12) & 0xFFF) ^ 0x800) - 0x800).float()
    img = v0 * (1.0 - w) + v1 * w
    sel = torch.round(cc) >= (i0 + 1).float()
    code = torch.where(sel, (g >> 26) & 0x3, (g >> 24) & 0x3)
    valid = (cc >= -0.5) & (cc < L - 0.5)
    return img, torch.where(valid, code, 0)


def _packed_composition(img, lbl, mod, fields):
    """The port's warp before its passes were fused: a packed word an element
    each pass and transposes between the passes."""
    B, D, H, W = img.shape
    scale = img.reshape(B, -1).abs().amax(dim=1).reshape(B, 1, 1, 1) / 2047.0
    scale = scale.clamp(min=1e-12)
    code = (lbl + 2 * mod).to(torch.int32)
    one = torch.ones_like(scale)
    x1, c1 = _packed_pass(_pack_pass(img.float(), code, scale), sep.unnormalize(fields.fx, W), W)
    x1 = x1.permute(0, 1, 3, 2).contiguous()
    c1 = c1.permute(0, 1, 3, 2).contiguous()
    ccy = sep.unnormalize(fields.fy, H).permute(0, 1, 3, 2).contiguous()
    x2, c2 = _packed_pass(_pack_pass(x1, c1, one), ccy, H)
    x2 = x2.permute(0, 3, 2, 1).contiguous()
    c2 = c2.permute(0, 3, 2, 1).contiguous()
    ccz = sep.unnormalize(fields.fz, D).permute(0, 2, 3, 1).contiguous()
    x3, c3 = _packed_pass(_pack_pass(x2, c2, one), ccz, D)
    code_out = c3.permute(0, 3, 1, 2).contiguous()
    return x3.permute(0, 3, 1, 2) * scale, code_out & 1, code_out >> 1


@pytest.mark.parametrize("shape", [(2, *BASE), (1, 1, 1, 1), (2, 3, 5, 1), (1, 2, 1, 2), (1, 7, 9, 37)])
def test_sep_warp_apply_matches_packed_composition(shape):
    """The fused passes' plain version equals the packed-word, transposed
    composition they replace: the image bitwise, both labels exactly."""
    draws = aug.draw_augment(torch.Generator().manual_seed(sum(shape)), shape, aug.AugmentParams(
        *_strong_params()))
    fields = sep.sep_warp_fields(draws.eff_theta, draws.ctl, shape[1:])
    rng = np.random.RandomState(len(shape) + shape[-1])
    img = _t(rng.randn(*shape).astype(np.float32) * 3)
    lbl, mod = (_t((rng.rand(*shape) < 0.4).astype(np.int32)) for _ in range(2))
    got = sep.sep_warp_apply(img, lbl, mod, fields)
    want = _packed_composition(img, lbl, mod, fields)
    assert got[0].dtype == torch.float32 and got[1].dtype == got[2].dtype == torch.int32
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(8, 128, 128, 50), (2, *BASE), (1, 1, 1, 1), (2, 3, 5, 1),
                                   (1, 7, 9, 37), (2, 5, 100, 130), (1, 1024, 8, 9),
                                   (1, 2, 2000, 50), (1, 1, 2, 30_000),
                                   (1, sep.MAX_AXIS, 1, 1), (1, 1, 1, sep.MAX_AXIS)])
def test_tile_plan_fits_and_covers(shape):
    """Each pass's tile fits a block's shared memory, and the kernels' blocks
    (as `sep_warp_pass.cu` enumerates them) take every row of the pass
    axis's lines exactly once."""
    B, D, H, W = shape
    plan = sep.tile_plan(shape)
    tiles = (plan.rows_x * W, H * plan.cols_y, D * plan.cols_z)
    assert sep.TILE_BYTES * max(tiles) <= sep.SMEM_MAX
    for lines, per in ((D * H, plan.rows_x), (W, plan.cols_y), (H * W, plan.cols_z)):
        seen = np.zeros(lines, np.int64)
        for k in range(-(-lines // per)):
            seen[k * per:min(lines, (k + 1) * per)] += 1
        assert (seen == 1).all() and 1 <= per <= lines


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_tile_plan_raises_beyond_limit(axis):
    shape = [2, 3, 4, 5]
    shape[axis] = sep.MAX_AXIS + 1
    with pytest.raises(ValueError, match=f"at most {sep.MAX_AXIS} voxels"):
        sep.tile_plan(tuple(shape))
    with pytest.raises(ValueError, match="65,535 samples"):
        sep.tile_plan((65_536, 1, 1, 1))


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
    """Orders that raised before the port's slice 5a now compute what JAX
    does with the same draws (every order: `test_torch_port_orders.py`):
    labels exact; the image to 1e-5 ('fast'), within one int6 quantum
    ('fast-int6'), and within one bfloat16 quantum on at most 1% of the
    voxels ('reference-bf16' rounds after an interpolation that the two
    packages round apart)."""
    key = jax.random.PRNGKey(9)
    img, lbl, mod = _batch(9, 1)
    want = jaug.augment_sample_pair(key, jnp.asarray(img), jnp.asarray(lbl), jnp.asarray(mod),
                                    pre_interpolation_factor=FACTOR, order=order)
    got = aug.augment_sample_pair(_t(img), _t(lbl), _t(mod), _jax_draws(key, 1), order=order)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d = np.abs(got[0].numpy() - np.asarray(want[0]))
    if order == "fast":
        assert d.max() <= 1e-5
        return
    absmax = np.abs(got[0].numpy()).max() * 1.01
    quantum, share = (absmax / 31.0, 1e-4) if order == "fast-int6" else (absmax * 2.0 ** -7, 1e-2)
    assert (d > 1e-5).mean() <= share and d.max() <= quantum, (d.max(), (d > 1e-5).mean())
