"""`tests/test_register.py`'s cases through the port's `tools/register.py`, on
the CPU, each beside the JAX package's result on the same numpy inputs.

The tool is a numpy copy (equal results expected, bit for bit) but for
`estimate_pullback_lps`, which calls the port's `affine_register`
(`device="cpu"` here; on the card by default).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep_staple_tpu.tools import register as jax_tool
from deep_staple_torch.tools import register as tool

torch.set_num_threads(1)


def _smooth_volume(shape, seed=0, coarse=6):
    """`tests/test_register.py::_smooth_volume`: a band-limited random volume."""
    from deep_staple_tpu.ops.resample import resize_nd

    base = np.random.RandomState(seed).rand(coarse, coarse, coarse).astype(np.float32)
    return np.asarray(resize_nd(jnp.asarray(base), tuple(shape), mode="linear"))


def _rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4)
    m[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return m


def test_read_itk_tfm_center_semantics(tmp_path):
    M = _rot_z(0.3)[:3, :3]
    t = np.array([1.0, -2.0, 3.0])
    c = np.array([10.0, 20.0, -5.0])
    vals = " ".join(f"{v:.17g}" for v in list(M.reshape(-1)) + list(t))
    p = tmp_path / "x.tfm"
    p.write_text(
        "#Insight Transform File V1.0\n#Transform 0\n"
        "Transform: AffineTransform_double_3_3\n"
        f"Parameters: {vals}\n"
        f"FixedParameters: {c[0]} {c[1]} {c[2]}\n"
    )
    T = tool.read_itk_tfm(p)
    x = np.array([3.0, -7.0, 11.0])
    np.testing.assert_allclose(T[:3, :3] @ x + T[:3, 3], M @ (x - c) + t + c, rtol=1e-12)
    np.testing.assert_array_equal(T, jax_tool.read_itk_tfm(p))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tfm_roundtrip_across_packages(tmp_path, writer):
    T = _rot_z(0.2)
    T[:3, 3] = [4.0, -1.5, 2.0]
    p = tmp_path / "t.tfm"
    write, read = (tool.write_itk_tfm, jax_tool.read_itk_tfm) if writer == "port" else \
        (jax_tool.write_itk_tfm, tool.read_itk_tfm)
    write(p, T)
    np.testing.assert_allclose(read(p), T, atol=1e-12)
    np.testing.assert_allclose(tool.read_itk_tfm(p), T, atol=1e-12)


def test_read_itk_tfm_rejects_non_affine(tmp_path):
    p = tmp_path / "b.tfm"
    p.write_text(
        "#Insight Transform File V1.0\nTransform: BSplineTransform_double_3_3\n"
        "Parameters: 0 0 0\nFixedParameters:\n"
    )
    with pytest.raises(ValueError, match="unsupported transform class"):
        tool.read_itk_tfm(p)


@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_affine_sample_matches_jax(mode):
    """Identity and an integer shift as `tests/test_register.py` checks them,
    and a rotation with a shift equal to JAX's bit for bit."""
    vol = np.arange(4 * 5 * 6, dtype=np.float32).reshape(4, 5, 6)
    np.testing.assert_allclose(tool.affine_sample_np(vol, np.eye(4), vol.shape, mode=mode), vol,
                               atol=1e-6)
    M = np.eye(4)
    M[0, 3] = 1.0
    shifted = tool.affine_sample_np(vol, M, vol.shape, mode=mode)
    np.testing.assert_allclose(shifted[:-1], vol[1:], atol=1e-5)
    np.testing.assert_array_equal(shifted[-1], 0)
    R = _rot_z(0.3)
    R[:3, 3] = [0.4, -0.7, 1.2]
    np.testing.assert_array_equal(tool.affine_sample_np(vol, R, (5, 4, 6), mode=mode, default_value=-1.0),
                                  jax_tool.affine_sample_np(vol, R, (5, 4, 6), mode=mode,
                                                            default_value=-1.0))


def test_resample_to_reference_known_transform_recovery():
    """`tests/test_register.py`'s recovery of a known-transformed series on a
    reference grid of other spacing, to its bounds, and equal to JAX's."""
    shape = (40, 40, 32)
    fixed = _smooth_volume(shape, seed=3)
    a_fix = np.eye(4)
    a_mov = np.diag([1.25, 1.25, 1.25, 1.0])
    a_mov[:3, 3] = [-10.0, -10.0, -8.0]
    P = _rot_z(0.1)
    P[:3, 3] = [1.5, -2.0, 0.5]
    vox_map = np.linalg.inv(a_fix) @ np.linalg.inv(P) @ a_mov
    moving = tool.affine_sample_np(fixed, vox_map, (52, 52, 40), mode="linear")
    got = tool.resample_to_reference(moving, a_mov, shape, a_fix, pullback_lps=P)
    np.testing.assert_array_equal(got, jax_tool.resample_to_reference(moving, a_mov, shape, a_fix,
                                                                      pullback_lps=P))
    sl = (slice(4, -4),) * 3
    err = np.abs(got[sl] - fixed[sl])
    assert np.quantile(err, 0.95) < 0.04, float(err.max())
    assert float(np.sqrt(np.mean(err ** 2))) < 0.1 * float(np.std(fixed))


def test_estimate_pullback_recovers_known_affine():
    """The port's estimate (its `affine_register` on the CPU) resamples the
    moving volume to `tests/test_register.py`'s bound (interior RMS < 0.08 of
    the volume's std) against the known pull-back; JAX's estimate passes
    the same bound (`tests/test_torch_port_registration.py` holds the two
    to each other)."""
    shape = (36, 36, 30)
    fixed = _smooth_volume(shape, seed=7)
    P = _rot_z(0.08)
    P[:3, 3] = [1.0, -1.5, 0.8]
    moving = tool.affine_sample_np(fixed, np.linalg.inv(P), shape, mode="linear")
    est = tool.estimate_pullback_lps(moving, np.eye(4), fixed, np.eye(4), device="cpu")
    got = tool.resample_to_reference(moving, np.eye(4), shape, np.eye(4), pullback_lps=est)
    ref = tool.resample_to_reference(moving, np.eye(4), shape, np.eye(4), pullback_lps=P)
    sl = (slice(5, -5),) * 3
    rms = float(np.sqrt(np.mean((got[sl] - ref[sl]) ** 2)))
    assert rms < 0.08 * float(np.std(fixed)), rms


def test_estimate_pullback_conjugates_by_the_affines(monkeypatch):
    """The LPS pull-back is A_mov @ V @ A_fix^-1 of the voxel map V that
    `affine_register` returns, as in JAX (`affine_register` stubbed on both
    sides with the same V)."""
    from deep_staple_tpu.ops import registration as jreg
    from deep_staple_torch.ops import registration as reg

    V = _rot_z(0.05)
    V[:3, 3] = [0.5, 1.0, -2.0]
    monkeypatch.setattr(reg, "affine_register", lambda *a, **k: V)
    monkeypatch.setattr(jreg, "affine_register", lambda *a, **k: V)
    a_mov = np.diag([1.5, 1.0, 2.0, 1.0])
    a_fix = np.diag([1.0, 0.5, 1.0, 1.0])
    a_fix[:3, 3] = [3.0, -1.0, 2.0]
    vol = np.zeros((4, 4, 4), np.float32)
    got = tool.estimate_pullback_lps(vol, a_mov, vol, a_fix, device="cpu")
    np.testing.assert_array_equal(got, jax_tool.estimate_pullback_lps(vol, a_mov, vol, a_fix))
    np.testing.assert_allclose(got, a_mov @ V @ np.linalg.inv(a_fix), atol=1e-12)


def test_applied_transform_and_contours():
    T = _rot_z(0.2)
    T[:3, 3] = [2.0, 0.0, -1.0]
    A = tool.applied_transform_lps(T)
    np.testing.assert_allclose(A @ T, np.eye(4), atol=1e-12)
    pts = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]])
    (out,) = tool.transform_contours_lps([pts], T)
    np.testing.assert_allclose(out, pts @ A[:3, :3].T + A[:3, 3], atol=1e-12)
    np.testing.assert_array_equal(out, jax_tool.transform_contours_lps([pts], T)[0])


def test_series_index_affine_swaps_row_col():
    a = np.eye(4)
    a[:3, 0] = [1, 2, 3]
    a[:3, 1] = [4, 5, 6]
    s = tool.series_index_affine(a)
    np.testing.assert_array_equal(s[:3, 0], [4, 5, 6])
    np.testing.assert_array_equal(s[:3, 1], [1, 2, 3])
    np.testing.assert_array_equal(s, jax_tool.series_index_affine(a))


def test_find_case_tfm(tmp_path):
    case = tmp_path / "vs_gk_7"
    (case / "MR_t1").mkdir(parents=True)
    tfm = case / "MR_t1" / "inv_T1_LPS_to_T2_LPS.tfm"
    tool.write_itk_tfm(tfm, np.eye(4))
    assert tool.find_case_tfm(case, "mr_t1", "mr_t2") == tfm == jax_tool.find_case_tfm(case, "mr_t1", "mr_t2")
    assert tool.find_case_tfm(case, "mr_t2", "mr_t1") is None


def test_estimate_pullback_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.zeros((4, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.estimate_pullback_lps(vol, np.eye(4), vol, np.eye(4))
