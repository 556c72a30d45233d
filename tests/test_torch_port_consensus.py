"""The port's DP voting, STAPLE and K4's plain version against the JAX package,
on the CPU.

Inputs are made with numpy from a seed and fed to both. The JAX side runs as
its own tests run it here: the fused Pallas iteration in interpret mode. K4
itself (`csrc/staple_em.cu`) is held against its plain version on the card
by `chip_smoke.py`.

Iteration counts. At the default epsilon 1e-7 the stop test sits at float32's
rounding noise: delta sums 2R differences of float32 values near 1, whose
last bits depend on the order of the sums and on the log and exp of each
library. There JAX's own XLA and Pallas paths stop 1-2 iterations apart on
these rater sets (12 and 11, 13 and 15), and the port may stop at yet
another iteration or, where its float32 map falls into a cycle, run to
max_iterations; the results agree to the noise all the same. So the
iteration count is held equal to both JAX paths where the stop lies above
that noise (epsilon 1e-5, or a max_iterations that binds first), and the
results at every setting.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


def _pallas_raters(rng, shape=(10, 12, 11), n_good=4, n_bad=2):
    """`tests/test_staple_pallas.py::_raters`."""
    truth = np.zeros(shape, np.int32)
    truth[2:8, 3:9, 3:9] = 1
    out = []
    for _ in range(n_good):
        r = truth.copy()
        flip = rng.rand(*shape) < 0.03
        r[flip] = 1 - r[flip]
        out.append(r)
    for _ in range(n_bad):
        out.append(np.roll(truth, (4, 4, 0), axis=(0, 1, 2)))
    return out


def _consensus_raters(rng, shape=(12, 12, 12), n_good=4, n_bad=2):
    """`tests/test_consensus.py::_make_raters` (its raters only)."""
    truth = np.zeros(shape, np.int32)
    truth[3:9, 3:9, 3:9] = 1
    raters = []
    for _ in range(n_good):
        r = truth.copy()
        flip = rng.rand(*shape) < 0.02
        r[flip] = 1 - r[flip]
        raters.append(r)
    for _ in range(n_bad):
        raters.append(np.roll(truth, (5, 5, 0), axis=(0, 1, 2)))
    return raters


RATER_SETS = {
    "pallas_10x12x11": lambda: _pallas_raters(np.random.RandomState(0)),
    "pallas_7x9x5": lambda: _pallas_raters(np.random.RandomState(0), (7, 9, 5), 3, 0),
    "consensus_12cube": lambda: _consensus_raters(np.random.RandomState(0)),
    "consensus_12cube_3_2": lambda: _consensus_raters(np.random.RandomState(0), n_good=3, n_bad=2),
}


def _jax_coefs(p, q, prior):
    """coef and base as `staple_pallas.py:133-146` computes them."""
    eps = 1e-12
    log_p, log_1mp = np.log(np.maximum(p, eps)), np.log(np.maximum(1 - p, eps))
    log_q, log_1mq = np.log(np.maximum(q, eps)), np.log(np.maximum(1 - q, eps))
    coef = ((log_p - log_1mp) - (log_1mq - log_q)).astype(np.float32)
    base = np.float32(np.log(prior) - np.log1p(-prior) + np.sum(log_1mp - log_q))
    return coef, base


@pytest.mark.parametrize("R,V", [(3, 315), (17, 1001), (6, 1320), (1, 7)])
def test_em_iteration_plain_matches_pallas(R, V):
    """One fused E+M pass: `staple_em_iter_plain` against the Pallas kernel
    (`staple_pallas.em_iteration`, interpret mode), at the same coef and
    base. Odd V, R = 1, 3, 17 (not a multiple of the TPU's 16)."""
    from deep_staple_tpu.consensus.staple_pallas import BLK, em_iteration
    from deep_staple_torch.consensus.staple_fused import staple_em_iter, staple_em_iter_plain

    rng = np.random.RandomState(R * 1000 + V)
    d = (rng.rand(R, V) < 0.3).astype(np.uint8)
    p = rng.uniform(0.7, 0.999, R).astype(np.float32)
    q = rng.uniform(0.8, 0.9999, R).astype(np.float32)
    coef, base = _jax_coefs(p, q, np.float32(0.3))
    r_pad, v_pad = max(16, -(-R // 16) * 16), -(-V // BLK) * BLK
    d_pad = np.zeros((r_pad, v_pad), np.float32)
    d_pad[:R, :V] = d
    c_pad = np.zeros(r_pad, np.float32)
    c_pad[:R] = coef
    want_wd, want_ws = em_iteration(jnp.asarray(d_pad), jnp.asarray(c_pad), float(base), V)

    args = (torch.from_numpy(d)[None], torch.from_numpy(coef)[None], torch.tensor([base]))
    wd, ws = staple_em_iter_plain(*args)
    np.testing.assert_allclose(wd[0].numpy(), np.asarray(want_wd)[:R], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ws[0]), float(want_ws), rtol=1e-5)
    # The wrapper takes the plain version for a CPU tensor.
    wd2, ws2 = staple_em_iter(*args, torch.ones(1, dtype=torch.bool))
    assert torch.equal(wd, wd2) and torch.equal(ws, ws2)


def _assert_staple_close(got, want):
    np.testing.assert_array_equal(got.consensus.numpy(), np.asarray(want.consensus))
    np.testing.assert_allclose(got.sensitivities.numpy(), np.asarray(want.sensitivities),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.specificities.numpy(), np.asarray(want.specificities),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.probabilities.numpy(), np.asarray(want.probabilities), atol=1e-5)


@pytest.mark.parametrize("max_iterations,epsilon", [(200, 1e-7), (200, 1e-5), (6, 1e-7)])
@pytest.mark.parametrize("rater_set", sorted(RATER_SETS))
def test_staple_consensus_matches_jax(rater_set, max_iterations, epsilon):
    from deep_staple_tpu.consensus.staple import staple_consensus as jax_staple
    from deep_staple_tpu.consensus.staple_pallas import staple_consensus_pallas
    from deep_staple_torch.consensus.staple import staple_consensus

    raters = RATER_SETS[rater_set]()
    got = staple_consensus(raters, max_iterations=max_iterations, epsilon=epsilon, device="cpu")
    assert got.consensus.dtype == torch.int32 and got.consensus.shape == raters[0].shape
    for ref in (jax_staple, staple_consensus_pallas):
        want = ref(raters, max_iterations=max_iterations, epsilon=epsilon)
        _assert_staple_close(got, want)
        if epsilon > 1e-7 or max_iterations < 10:  # above the noise: see the docstring
            assert int(got.iterations) == int(want.iterations)


def _freeze_stacks():
    """Case 0 unanimous (stops after 2 passes), case 1 noisy (goes on)."""
    rng = np.random.RandomState(3)
    truth = np.zeros((9, 8, 7), np.int32)
    truth[2:7, 2:6, 1:5] = 1
    unanimous = np.stack([truth] * 4)
    noisy = np.stack([np.where(rng.rand(*truth.shape) < 0.05, 1 - truth, truth) for _ in range(3)]
                     + [np.roll(truth, 2, axis=1)])
    return np.stack([unanimous, noisy])


@pytest.mark.parametrize("epsilon", [1e-5, 1e-7])
def test_staple_batch_freezes_each_case_as_vmap(epsilon):
    """`staple_consensus_batch` against JAX's vmapped one: a case whose
    condition is false keeps its p, q and iteration count while another
    goes on; the host's check every 8 passes gives what a check after every
    pass gives."""
    from deep_staple_tpu.consensus.staple import staple_consensus_batch as jax_batch
    from deep_staple_torch.consensus import staple as port
    from deep_staple_torch.consensus.staple import staple_consensus_batch

    stacks = _freeze_stacks()
    got = staple_consensus_batch(torch.from_numpy(stacks), max_iterations=200, epsilon=epsilon)
    want = jax_batch(stacks, max_iterations=200, epsilon=epsilon)
    _assert_staple_close(got, want)
    assert got.consensus.shape == (2, 9, 8, 7)
    iters = got.iterations.tolist()
    assert iters[0] == int(want.iterations[0]) == 2 < iters[1]
    if epsilon > 1e-7:
        assert iters[1] == int(want.iterations[1])

    d = torch.from_numpy(stacks.reshape(2, 4, -1).astype(np.uint8))
    prior = torch.from_numpy(stacks.reshape(2, -1).mean(1).astype(np.float32))
    every = [port._em_loop(d, prior, 200, epsilon, k) for k in (1, 8)]
    for a, b in zip(*every):
        assert torch.equal(a, b)
    # The frozen case equals a run of its own.
    alone = port._em_loop(d[:1], prior[:1], 200, epsilon, 8)
    for a, b in zip(every[1], alone):
        assert torch.equal(a[:1], b)


# Published-equation golden of `tests/test_consensus.py:90-105`.
_GOLDEN_PATTERNS = [
    ((1, 1, 1), 25), ((1, 1, 0), 8), ((1, 0, 1), 5), ((0, 1, 1), 2),
    ((1, 0, 0), 4), ((0, 1, 0), 3), ((0, 0, 1), 6), ((0, 0, 0), 47),
]
_GOLDEN_SENS = [0.9415583898692108, 0.8493785025004894, 0.7667088709525609]
_GOLDEN_SPEC = [0.943281689878763, 0.9469367704427127, 0.8893547929810574]
_GOLDEN_POSTERIOR = {
    (1, 1, 1): 0.9991630561835669,
    (1, 1, 0): 0.9783514146562602,
    (1, 0, 1): 0.9222582863665588,
    (0, 1, 1): 0.8166988851485366,
    (1, 0, 0): 0.3099069927851911,
    (0, 1, 0): 0.14432199329965237,
    (0, 0, 1): 0.04239752548492065,
    (0, 0, 0): 0.0016732208343583882,
}


def test_staple_matches_published_equations_fixed_point():
    """The port against the exact-arithmetic fixed point of Warfield 2004's
    EM equations, at `tests/test_consensus.py:108-127`'s tolerances."""
    from deep_staple_torch.consensus.staple import staple_consensus

    voxels = []
    for pat, count in _GOLDEN_PATTERNS:
        voxels.extend([pat] * count)
    dec = np.array(voxels, np.float32).T  # (3 raters, 100 voxels)
    res = staple_consensus([dec[i].reshape(10, 10) for i in range(3)], max_iterations=500,
                           epsilon=1e-7, device="cpu")
    np.testing.assert_allclose(res.sensitivities.numpy(), _GOLDEN_SENS, atol=2e-4)
    np.testing.assert_allclose(res.specificities.numpy(), _GOLDEN_SPEC, atol=2e-4)
    probs = res.probabilities.numpy()
    cons = res.consensus.numpy().reshape(-1)
    for j, pat in enumerate(voxels):
        assert abs(probs[j] - _GOLDEN_POSTERIOR[pat]) < 5e-4, (pat, probs[j])
        assert cons[j] == int(_GOLDEN_POSTERIOR[pat] > 0.5)


def test_staple_matches_native_cpp():
    """The port against `ds_staple_em` (the C++ EM in double precision), at
    `tests/test_consensus.py:62-68`'s tolerances, through the port's own
    binding and the JAX test's."""
    from deep_staple_tpu.consensus.native_staple import staple_consensus_native as jax_native
    from deep_staple_tpu.data.native_io import _find_lib
    from deep_staple_torch.consensus import native_staple
    from deep_staple_torch.consensus.staple import staple_consensus

    _find_lib()  # the JAX package builds native/ when the library is missing
    if not native_staple.native_staple_available():
        pytest.skip("native library not built (native/build.sh)")
    raters = _consensus_raters(np.random.RandomState(0), n_good=3, n_bad=2)
    res = staple_consensus(raters, max_iterations=50, device="cpu")
    c_cons, c_p, c_q, c_iters = native_staple.staple_consensus_native(raters, max_iterations=50)
    np.testing.assert_array_equal(res.consensus.numpy(), c_cons)
    np.testing.assert_allclose(res.sensitivities.numpy(), c_p, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(res.specificities.numpy(), c_q, rtol=1e-3, atol=1e-4)
    j_cons, j_p, j_q, j_iters = jax_native(raters, max_iterations=50)
    assert c_iters == j_iters and np.array_equal(c_p, j_p) and np.array_equal(c_cons, j_cons)


def test_dp_consensus_matches_jax():
    from deep_staple_tpu.consensus.voting import calc_dp_consensus as jax_dp
    from deep_staple_tpu.consensus.voting import calc_dp_consensus_batch as jax_dp_batch
    from deep_staple_torch.consensus.voting import calc_dp_consensus, calc_dp_consensus_batch

    rng = np.random.RandomState(11)
    lbls = rng.randint(0, 2, size=(3, 7, 6, 5, 4)).astype(np.int32)
    dps = rng.randn(3, 7).astype(np.float32)
    got = calc_dp_consensus_batch(torch.from_numpy(lbls.astype(np.uint8)), torch.from_numpy(dps))
    want = np.asarray(jax_dp_batch(jnp.asarray(lbls).astype(jnp.float32), jnp.asarray(dps)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1
    one = calc_dp_consensus(torch.from_numpy(lbls[1]), dps[1].tolist())
    np.testing.assert_array_equal(one.numpy(), np.asarray(jax_dp(jnp.asarray(lbls[1]), jnp.asarray(dps[1]))))


@pytest.mark.parametrize("nan_for_unlabeled", [True, False])
def test_dice3d_matches_jax(nan_for_unlabeled):
    from deep_staple_tpu.ops.dice import dice3d as jax_dice3d
    from deep_staple_torch.ops.dice import dice3d

    rng = np.random.RandomState(12)
    pred = rng.randint(0, 3, (2, 6, 5, 4))
    tgt = rng.randint(0, 3, (2, 6, 5, 4))
    pred[1][pred[1] == 2] = 0
    tgt[1][tgt[1] == 2] = 0  # class 2 absent from sample 1: NaN (or 0) Dice
    eye = np.eye(3, dtype=np.int32)
    for style, (p, t) in ((True, (eye[pred], eye[tgt])),
                          (False, (np.moveaxis(eye[pred], -1, 1), np.moveaxis(eye[tgt], -1, 1)))):
        got = dice3d(torch.from_numpy(p), torch.from_numpy(t), style, nan_for_unlabeled)
        want = np.asarray(jax_dice3d(jnp.asarray(p), jnp.asarray(t), style, nan_for_unlabeled))
        assert got.dtype == torch.float32 and got.shape == (2, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert np.isnan(want).any() == nan_for_unlabeled
    with pytest.raises(ValueError):
        dice3d(torch.zeros(2, 3, 4, 5), torch.zeros(2, 3, 4, 5), True)
