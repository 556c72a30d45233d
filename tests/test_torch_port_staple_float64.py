"""The port's STAPLE on the CPU against a float64 EM in numpy.

The plain EM pass (`consensus/staple_fused.py::staple_em_iter_plain`) takes
the M-step's sums over the voxels in float64 and rounds them once. Float32
chains of 73,728 terms put the port's sensitivities 1e-4 from the float64
EM after five passes on `test_torch_port_snapshot.py`'s consensus, one of
them above 1; JAX's float32 sums were 4.7e-5 from it. The EM amplifies a
sum's error where a sensitivity nears 1, since 1 - p is then of its size.
"""

import numpy as np
import pytest
import torch

from deep_staple_torch.consensus import staple
from deep_staple_torch.consensus.staple_fused import staple_em_iter_plain, staple_posterior_plain

torch.set_num_threads(1)

SHAPE = (48, 48, 32)


def _raters(seed, count=4):
    """A box of truth each rater shifts by up to a voxel and flips at 0.2%."""
    rng = np.random.RandomState(seed)
    truth = np.zeros(SHAPE, np.uint8)
    truth[8:40, 10:36, 6:26] = 1
    raters = [np.roll(truth, rng.randint(-1, 2, 3), (0, 1, 2)) ^ (rng.rand(*SHAPE) < 0.002)
              for _ in range(count)]
    return np.stack(raters).reshape(1, count, -1).astype(np.uint8)


def em_float64(d, passes):
    """STAPLE's EM in float64 (`deep_staple_tpu/consensus/staple.py:51-103`):
    d (R, V) 0/1 -> sensitivities, specificities (R,)."""
    d = d.astype(np.float64)
    prior = np.clip(d.mean(), 1e-7, 1 - 1e-7)
    p = np.full(d.shape[0], 0.99999)
    q = np.full(d.shape[0], 0.99999)
    for _ in range(passes):
        log_a = np.log(prior) + np.log(p) @ d + np.log1p(-p) @ (1 - d)
        log_b = np.log1p(-prior) + np.log(q) @ (1 - d) + np.log1p(-q) @ d
        w = 1 / (1 + np.exp(log_b - log_a))
        p = d @ w / w.sum()
        q = (1 - d) @ (1 - w) / (1 - w).sum()
    return p, q


def test_em_pass_sums_are_float64_rounded_once():
    d = torch.from_numpy(_raters(0))
    coef = torch.tensor([[9.0, 8.0, 7.5, 9.5]])
    base = torch.tensor([-20.0])
    wd, ws = staple_em_iter_plain(d, coef, base)
    w = staple_posterior_plain(d, coef, base).double()
    assert wd.dtype == ws.dtype == torch.float32
    assert torch.equal(wd, (d[0].double() @ w[0]).float()[None])
    assert torch.equal(ws, w.sum(dim=1).float())


@pytest.mark.parametrize("seed", range(4))
def test_staple_matches_float64_em(seed):
    """Five passes: sensitivities and specificities within 1e-6 of the
    float64 EM (measured 2.1e-7 at most; with float32 sums, 7.7e-6)."""
    d = _raters(seed)
    want_p, want_q = em_float64(d[0], 5)
    t = torch.from_numpy(d)
    p, q, _, iters = staple._em_loop(t, staple.priors(t), 5, 1e-7, 1)
    assert int(iters[0]) == 5
    np.testing.assert_allclose(p[0].numpy(), want_p, rtol=0, atol=1e-6)
    np.testing.assert_allclose(q[0].numpy(), want_q, rtol=0, atol=1e-6)
    assert (p <= 1).all() and (q <= 1).all()
