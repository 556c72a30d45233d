"""The registration toolbox of the port against the JAX package, on the CPU:
`grid_sample_3d` (values and the gradient with respect to the grid) and the
`align_corners` affine grid, `dilate_label_class`, the shifted-FMA depthwise
conv with its hand-written backward, every function of
`ops/registration.py`, and `affine_register` (the first scale's loss and
gradient, the first Adam steps, and the recovery of a known affine).

Inputs are made with numpy from a seed and fed to both packages. None of
these functions reaches a Pallas kernel in JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_staple_tpu.ops import registration as jreg
from deep_staple_torch.ops import registration as reg

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode,padding", [("bilinear", "zeros"), ("bilinear", "border"),
                                          ("nearest", "zeros"), ("nearest", "border")])
def test_grid_sample_3d_matches_jax(mode, padding, align_corners):
    """Values within 1e-6 (the same corner sums in the same order; float32
    rounding of the unnormalized coordinates). The grid reaches past the
    volume so that both paddings act."""
    from deep_staple_tpu.ops.grid_sample import grid_sample_3d as jax_gs
    from deep_staple_torch.ops.grid_sample import grid_sample_3d

    rng = np.random.RandomState(0)
    inp = rng.randn(2, 3, 5, 6, 7).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 3, 5, 3)).astype(np.float32)
    want = np.asarray(jax_gs(jnp.asarray(inp), jnp.asarray(grid), mode, padding, align_corners))
    got = grid_sample_3d(_t(inp), _t(grid), mode, padding, align_corners).numpy()
    assert got.shape == want.shape == (2, 3, 4, 3, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_3d_grid_gradient_matches_jax(padding, align_corners):
    """d <out, cot> / d grid by autograd against jax.grad: within 1e-5
    relative to the largest entry (both differentiate the corner weights;
    float32 products in the same order). Grid points lie off the voxel
    lattice and off the border clamp's kinks."""
    from deep_staple_tpu.ops.grid_sample import grid_sample_3d as jax_gs
    from deep_staple_torch.ops.grid_sample import grid_sample_3d

    rng = np.random.RandomState(1)
    inp = rng.randn(1, 2, 6, 5, 7).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (1, 3, 4, 5, 3)).astype(np.float32)
    cot = rng.randn(1, 2, 3, 4, 5).astype(np.float32)
    want = np.asarray(jax.grad(lambda g: jnp.sum(
        jax_gs(jnp.asarray(inp), g, "bilinear", padding, align_corners) * cot))(jnp.asarray(grid)))
    g = _t(grid).requires_grad_(True)
    (grid_sample_3d(_t(inp), g, "bilinear", padding, align_corners) * _t(cot)).sum().backward()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(g.grad.numpy(), want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_grid_3d_matches_jax(align_corners):
    """Within 1e-6: the same elementwise products and sums (D = 1 takes the
    size-1 branch under align_corners)."""
    from deep_staple_tpu.ops.grid_sample import affine_grid_3d as jax_ag
    from deep_staple_torch.ops.grid_sample import affine_grid_3d

    theta = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32)
    for spatial in ((4, 5, 6), (1, 3, 2)):
        want = np.asarray(jax_ag(jnp.asarray(theta), spatial, align_corners))
        got = affine_grid_3d(_t(theta), spatial, align_corners).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel_sz", [1, 2, 3, 4])
@pytest.mark.parametrize("use_2d", [False, True])
def test_dilate_label_class_matches_jax(use_2d, kernel_sz):
    """Exactly equal labels, odd and even windows, dtype kept."""
    from deep_staple_tpu.ops import dilate_label_class as jax_dilate
    from deep_staple_torch.ops import dilate_label_class

    rng = np.random.RandomState(3)
    shape = (2, 9, 8) if use_2d else (2, 7, 8, 6)
    lab = (rng.rand(*shape) < 0.1).astype(np.int32) * 2 + (rng.rand(*shape) < 0.2)
    want = np.asarray(jax_dilate(jnp.asarray(lab), 2, 2, use_2d, kernel_sz))
    got = dilate_label_class(_t(lab), 2, 2, use_2d, kernel_sz)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv3d_shifted_matches_jax(stride):
    """Forward and JAX's custom VJP (input and weight gradients) within
    1e-5 relative to each output's largest entry: 27 float32 products
    summed in the same order; the weight gradient's sums run over the batch
    in another order."""
    from deep_staple_tpu.ops.conv3d import depthwise_conv3d_shifted as jax_dw
    from deep_staple_torch.ops.conv3d import depthwise_conv3d_shifted

    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 6, 5, 4).astype(np.float32)
    k = rng.randn(3, 3, 3, 1, 4).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jax_dw(a, b, stride), jnp.asarray(x), jnp.asarray(k))
    cot = rng.randn(*y.shape).astype(np.float32)
    gx_want, gk_want = (np.asarray(a) for a in vjp(jnp.asarray(cot)))
    xt, kt = _t(x).requires_grad_(True), _t(k).requires_grad_(True)
    yt = depthwise_conv3d_shifted(xt, kt, stride)
    yt.backward(_t(cot))
    for got, want in ((yt.detach().numpy(), np.asarray(y)), (xt.grad.numpy(), gx_want),
                      (kt.grad.numpy(), gk_want)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("align_corners", [None, True])
def test_keypoint_and_flow_conversions_match_jax(align_corners):
    shape = (10, 12, 14)
    pts = np.random.RandomState(5).rand(1, 7, 3).astype(np.float32) * 9
    for jfn, fn in ((jreg.kpts_pt, reg.kpts_pt), (jreg.kpts_world, reg.kpts_world),
                    (jreg.flow_pt, reg.flow_pt), (jreg.flow_world, reg.flow_world)):
        want = np.asarray(jfn(jnp.asarray(pts), shape, align_corners))
        np.testing.assert_allclose(fn(_t(pts), shape, align_corners).numpy(), want,
                                   rtol=1e-6, atol=1e-6)


def test_random_kpts_matches_jax():
    """All keypoints of the stride-2 grid equal JAX's (same order); a subset
    drawn from a torch.Generator is num_points distinct rows of them."""
    rng = np.random.RandomState(6)
    mask = (rng.rand(1, 1, 12, 10, 8) < 0.3).astype(np.float32)
    want = np.asarray(jreg.random_kpts(jnp.asarray(mask), 2))
    got = reg.random_kpts(_t(mask), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    sub = reg.random_kpts(_t(mask), 2, num_points=5, generator=torch.Generator().manual_seed(0))
    assert sub.shape == (1, 5, 3)
    rows = {tuple(r) for r in got[0].tolist()}
    assert len({tuple(r) for r in sub[0].tolist()} & rows) == 5


@pytest.mark.parametrize("p", [1, 2])
def test_pdist_and_pdist2_match_jax(p):
    rng = np.random.RandomState(7)
    x = rng.rand(2, 6, 3).astype(np.float32)
    y = rng.rand(2, 5, 3).astype(np.float32)
    np.testing.assert_allclose(reg.pdist(_t(x), p).numpy(), np.asarray(jreg.pdist(jnp.asarray(x), p)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(reg.pdist2(_t(x), _t(y), p).numpy(),
                               np.asarray(jreg.pdist2(jnp.asarray(x), jnp.asarray(y), p)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("include_self", [False, True])
def test_knn_and_lbp_graphs_match_jax(include_self):
    """Indices and adjacency equal (distinct random distances: no ties),
    masked distances within 1e-6; the LBP edge list and reverse index equal."""
    x = np.random.RandomState(8).rand(1, 12, 3).astype(np.float32)
    ind, dist, A = reg.knn_graph(_t(x), 3, include_self)
    jind, jdist, jA = jreg.knn_graph(jnp.asarray(x), 3, include_self)
    np.testing.assert_array_equal(ind.numpy(), np.asarray(jind))
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5, atol=1e-6)
    edges, rev = reg.lbp_graph(_t(x), 3)
    jedges, jrev = jreg.lbp_graph(jnp.asarray(x), 3)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(jedges))
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))


@pytest.mark.parametrize("padding_mode", ["replicate", "zeros"])
def test_filters_match_jax(padding_mode):
    """filter1d along each axis, smooth and mean_filter within 1e-6: the same
    weighted sums in the same order."""
    rng = np.random.RandomState(9)
    img = rng.rand(1, 2, 8, 9, 10).astype(np.float32)
    w = rng.rand(5).astype(np.float32)
    for dim in (0, 1, 2):
        want = np.asarray(jreg.filter1d(jnp.asarray(img), jnp.asarray(w), dim, padding_mode))
        np.testing.assert_allclose(reg.filter1d(_t(img), _t(w), dim, padding_mode).numpy(), want,
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(reg.smooth(_t(img), 0.8).numpy(),
                               np.asarray(jreg.smooth(jnp.asarray(img), 0.8)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(reg.mean_filter(_t(img), 2).numpy(),
                               np.asarray(jreg.mean_filter(jnp.asarray(img), 2)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("disp_radius,disp_step,patch_radius", [(2, 1, 1), (3, 2, 3)])
def test_ssd_cost_volume_matches_jax(disp_radius, disp_step, patch_radius):
    """Costs within 1e-5 relative to the largest (the grouped correlation
    and the window sums are float32 convolutions, summed in another order
    by each library); the argmin over the window equal."""
    rng = np.random.RandomState(10)
    shape = (14, 13, 12)
    feat_f = rng.rand(1, 3, *shape).astype(np.float32)
    feat_m = np.roll(feat_f, 1, axis=3) + 0.05 * rng.rand(1, 3, *shape).astype(np.float32)
    kw = np.array([[[6.0, 5.0, 7.0], [3.0, 8.0, 4.0], [9.0, 6.5, 6.0], [7.2, 2.0, 9.1]]], np.float32)
    kpts = np.asarray(jreg.kpts_pt(jnp.asarray(kw), shape, align_corners=True))
    want = np.asarray(jreg.ssd_cost_volume(jnp.asarray(kpts), jnp.asarray(feat_f), jnp.asarray(feat_m),
                                           shape, disp_radius, disp_step, patch_radius))
    got = reg.ssd_cost_volume(_t(kpts), _t(feat_f), _t(feat_m), shape, disp_radius, disp_step,
                              patch_radius).numpy()
    w = 2 * disp_radius + 1
    assert got.shape == want.shape == (1, 4, w, w, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(got.reshape(4, -1).argmin(1), want.reshape(4, -1).argmin(1))


def test_minconv_and_sparse_minconv_match_jax():
    rng = np.random.RandomState(11)
    cost = rng.rand(4, 5, 5, 5).astype(np.float32)
    np.testing.assert_allclose(reg.minconv(_t(cost)).numpy(), np.asarray(jreg.minconv(jnp.asarray(cost))),
                               rtol=0, atol=1e-6)
    mdc = rng.rand(3, 6).astype(np.float32)
    c0 = rng.rand(3, 6, 3).astype(np.float32)
    c1 = rng.rand(3, 6, 3).astype(np.float32)
    np.testing.assert_allclose(
        reg.sparse_minconv(_t(mdc), _t(c0), _t(c1)).numpy(),
        np.asarray(jreg.sparse_minconv(jnp.asarray(mdc), jnp.asarray(c0), jnp.asarray(c1))),
        rtol=0, atol=1e-6)


def _smooth_volume(shape, seed, coarse=6):
    """`tests/test_register.py::_smooth_volume`: a band-limited random volume."""
    from deep_staple_tpu.ops.resample import resize_nd

    base = np.random.RandomState(seed).rand(coarse, coarse, coarse).astype(np.float32)
    return np.asarray(resize_nd(jnp.asarray(base), tuple(shape), mode="linear"))


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4)
    m[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return m


def _pair():
    """A fixed volume and a moving one of another shape made from it by a
    known affine (`tests/test_register.py`'s construction): -> fixed,
    moving, the pull-back P (fixed voxel -> moving voxel)."""
    from deep_staple_tpu.tools.register import affine_sample_np

    fixed = _smooth_volume((32, 32, 24), seed=7)
    P = _rot_z(0.08)
    P[:3, 3] = [1.0, -1.5, 0.8]
    moving = affine_sample_np(fixed, np.linalg.inv(P), (34, 32, 26), mode="linear")
    return fixed, moving, P


def test_affine_register_first_scale_loss_and_gradient_match_jax():
    """At the identity on the first pyramid level (scale 4), the loss and its
    gradient with respect to (mat, trans). On JAX's own z-normalized levels:
    the loss within 1e-6 relative, the gradient within 1e-5 of its largest
    entry (the same trilinear sums; at the identity every border voxel lies
    on the border clamp's bound, where both take half the gradient, as
    `jnp.clip` does). On the port's levels: within 2e-5 and 1e-4, and the
    levels within 2e-5 + 5e-5 relative of JAX's: JAX's float32 mean of the
    fixed volume is 1.7e-6 off its float64 mean (the port's 4.5e-8) and its
    std of the moving one 1.6e-5 relative (the port's 1.7e-8), and the
    pyramid's resize is a matrix product in JAX and `F.interpolate` here."""
    from deep_staple_tpu.ops.resample import resize_nd as jax_resize

    fixed, moving, _ = _pair()
    f = jreg._znorm(jnp.asarray(fixed))
    m = jreg._znorm(jnp.asarray(moving))
    f4 = jax_resize(f, tuple(s // 4 for s in f.shape), mode="linear")
    m4 = jax_resize(m, tuple(s // 4 for s in m.shape), mode="linear")

    def jax_loss(p):
        return jnp.mean((jreg._resample_normalized(m4, p["mat"], p["trans"], f4.shape) - f4) ** 2)

    want, wgrad = jax.value_and_grad(jax_loss)({"mat": jnp.eye(3), "trans": jnp.zeros(3)})
    f_s = reg.pyramid_level(reg.znorm(_t(fixed)), 4)
    m_s = reg.pyramid_level(reg.znorm(_t(moving)), 4)
    np.testing.assert_allclose(f_s.numpy(), np.asarray(f4), rtol=5e-5, atol=2e-5)
    np.testing.assert_allclose(m_s.numpy(), np.asarray(m4), rtol=5e-5, atol=2e-5)
    for levels, rel, gtol in (((torch.tensor(np.asarray(f4)), torch.tensor(np.asarray(m4))), 1e-6, 1e-5),
                              ((f_s, m_s), 2e-5, 1e-4)):
        mat = torch.eye(3, requires_grad=True)
        trans = torch.zeros(3, requires_grad=True)
        loss = reg.affine_loss(mat, trans, *levels)
        loss.backward()
        assert float(loss) == pytest.approx(float(want), rel=rel)
        for got, w in ((mat.grad, wgrad["mat"]), (trans.grad, wgrad["trans"])):
            w = np.asarray(w)
            np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=gtol * np.abs(w).max())


@pytest.mark.parametrize("steps", [1, 5])
def test_affine_register_first_adam_steps_match_jax(steps):
    """The voxel map after the first 1 and 5 Adam steps of the first scale:
    within 1e-4 (the hand-written update follows optax's formula; the
    gradients differ by about 1e-6 relative, which Adam's normalized steps
    do not amplify at first)."""
    fixed, moving, _ = _pair()
    want = jreg.affine_register(fixed, moving, scales=(4,), iters=(steps,))
    got = reg.affine_register(fixed, moving, scales=(4,), iters=(steps,), device="cpu")
    assert got.shape == (4, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_affine_register_recovers_the_same_affine_as_jax():
    """`tests/test_register.py::test_estimate_pullback_recovers_known_affine`'s
    case through both packages at the default scales and iterations: each
    estimate resamples the moving volume to within its bound of the known
    pull-back (interior RMS < 0.08 of the volume's std; measured 0.054 JAX,
    0.053 port), and the two resampled volumes lie within 0.02 std of each
    other (measured 0.0074: 240 Adam steps of lr 0.03 from gradients 2e-5
    apart end about 0.035 apart in the matrix)."""
    from deep_staple_tpu.tools.register import affine_sample_np, resample_to_reference

    shape = (36, 36, 30)
    fixed = _smooth_volume(shape, seed=7)
    P = _rot_z(0.08)
    P[:3, 3] = [1.0, -1.5, 0.8]
    moving = affine_sample_np(fixed, np.linalg.inv(P), shape, mode="linear")
    want = jreg.affine_register(fixed, moving)
    got = reg.affine_register(fixed, moving, device="cpu")
    sl = (slice(5, -5),) * 3
    scale = float(np.std(fixed))

    def pulled(M):
        return resample_to_reference(moving, np.eye(4), shape, np.eye(4), pullback_lps=M)[sl]

    ref = pulled(P)
    for M in (want, got):
        assert float(np.sqrt(np.mean((pulled(M) - ref) ** 2))) < 0.08 * scale
    assert float(np.sqrt(np.mean((pulled(got) - pulled(want)) ** 2))) < 0.02 * scale


def test_affine_register_default_device_is_the_card(monkeypatch):
    """Without CUDA the default device raises; it never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.affine_register(np.zeros((4, 4, 4)), np.zeros((4, 4, 4)))
