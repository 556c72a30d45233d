"""Training over a space axis (`deep_staple_torch/parallel/spatial.py`,
`train/step.py`) on the CPU, against one process (against JAX's sharded
step: `test_torch_port_spatial_jax.py`; the driver:
`test_torch_port_spatial_driver.py`).

Eight gloo ranks (`torch_port_ranks.py space_train`, started with the
module) run, in float64, the adjoints of the exchanges on space groups of
2, 3 and 4 ranks and the model's gradients at space 4; then each step case
of `SPACE_STEP_CASES` on its grid of the 8 ranks: 2 steps at B 8,
16x16x12 x1.5 (H = 24: the stride-4 rows split 2, 2, 1, 1 over space 4),
augmentation and dropout on unless the case turns them off, both
optimizers warm, lr 1e-4 unless the case names its own. This process
computes one process's results meanwhile.
"""

import numpy as np
import pytest
import torch

import torch_port_ranks as R

torch.set_num_threads(1)

# JAX's gate (`tests/test_parallel.py:172-199`).
RTOL, ATOL, DICE_ATOL = 5e-4, 1e-5, 1e-3
JAX_GATED = ("sp-fused", "sp-remat-sep", "sp-int6", "sp-compose", "sp-2d", "sp-mind")
RANK_CASES = ["adjoints", "grads", *JAX_GATED, "sp-strict-async"]


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("space_train_ranks")
    procs = R.start_step_ranks(out, RANK_CASES, timeout=240, mode="space_train", world=8)
    yield procs, out
    procs.kill()


def _joined(ranks):
    procs, out = ranks
    procs.wait()
    return out


def _rank_results(ranks, case):
    out = _joined(ranks)
    return [dict(np.load(out / f"{case}_rank{r}.npz")) for r in range(8)]


@pytest.mark.parametrize("S", sorted(R.ADJ_H))
def test_exchange_adjoints_match_unsharded(ranks, S):
    """In float64: the gradient of the sum of every rank's weighted outputs
    of `halo_rows` (halos below, at and above a slab's height, up to the
    ASPP's rate 16 on one row a rank), `space_mean` and `resize_h` (extents
    by powers of two and not), w.r.t. each rank's slab, equals the slab's
    rows of the unsharded gradient within 1e-12; slabs of unequal size at
    S = 2 and 3."""
    from deep_staple_torch.parallel.spatial import even_bounds

    want = R.adjoint_reference(S)
    out = _joined(ranks)
    b = even_bounds(R.ADJ_H[S], S)
    for r in range(S):
        got = np.load(out / f"adj{S}_rank{r}.npz")
        assert set(got.files) == set(want)
        for tag, g in want.items():
            assert np.abs(g).max() > 0.01, tag
            np.testing.assert_allclose(got[tag], g[:, :, b[r]:b[r + 1]], rtol=0, atol=1e-12,
                                       err_msg=f"S {S} rank {r} {tag}")


@pytest.mark.parametrize("case", list(R.GRAD_CASES))
def test_model_gradients_at_space_4_match_unsharded(ranks, case):
    """The float64 model (exact and async BatchNorm, remat off and on,
    dropout on) in train mode on (2, 8, 24, 12) over space 4: every
    parameter's gradient summed over the ranks equals one process's within
    1e-10 (of its largest entry where that is above 1; a bias followed by
    exact BatchNorm has a gradient of rounding noise only), and the running
    statistics after the forward are one process's."""
    want = R.space_model_grads(case)
    out = _joined(ranks)
    got = [np.load(out / f"grads-{case}_rank{r}.npz") for r in range(4)]
    for k, v in want.items():
        if k.startswith("g_"):
            total = sum(g[k] for g in got)
            np.testing.assert_allclose(total, v, rtol=0, atol=1e-10 * max(np.abs(v).max(), 1.0),
                                       err_msg=f"{case}: {k}")
        else:
            for r, g in enumerate(got):
                np.testing.assert_allclose(g[k], v, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{case}: {k} rank {r}")
    assert sum(np.abs(want[k]).sum() > 0 for k in want if k.startswith("g_")) > 100


@pytest.mark.parametrize("case", JAX_GATED)
def test_space_step_matches_one_process(ranks, case):
    """The first step's CE and DP loss at rtol 5e-4 / atol 1e-5 and Dice at
    atol 1e-3 of one process (JAX's gate; the gap is printed), the Dice
    (B_global, 2); the batch's DP rows moved and no others (`tests/
    test_parallel.py:735-774` for 'fast-int6')."""
    want = R.run_step_case(case, steps=1)
    got = _rank_results(ranks, case)[0]
    for k in ("ce_loss", "dp_loss"):
        np.testing.assert_allclose(got[f"m_{k}"], want[f"m_{k}"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case}: {k}")
    np.testing.assert_allclose(got["m_dice"], want["m_dice"], atol=DICE_ATOL, equal_nan=True)
    assert got["m_dice"].shape == (R.GLOBAL_B, 2)
    print(f"{case}: ce {float(abs(got['m_ce_loss'] - want['m_ce_loss'])):.2e}, dp "
          f"{float(abs(got['m_dp_loss'] - want['m_dp_loss'])):.2e}, dice "
          f"{float(np.nanmax(np.abs(got['m_dice'] - want['m_dice']))):.2e} from one process")
    assert np.all(got["dp"][R.GLOBAL_B:] == 0) and np.all(got["dp"][:R.GLOBAL_B] != 0)


@pytest.mark.parametrize("case", JAX_GATED + ("sp-strict-async",))
def test_space_state_is_bitwise_equal_on_every_rank(ranks, case):
    """After 2 steps the metrics and the state (every parameter, buffer and
    count, the DP vector) are the same bits on all 8 ranks; with a model
    axis, every sharded leaf on the ranks of its model index."""
    from deep_staple_torch.parallel.tensor import shard_plan

    _, (D, S, M) = R.SPACE_STEP_CASES[case]
    plan = shard_plan(R.start_state(case)[1].state_dict(), M) if M > 1 else {}
    res = _rank_results(ranks, case)
    for k in res[0]:
        for r, other in enumerate(res):
            ref = res[r % M] if k[2:] in plan else res[0]
            np.testing.assert_array_equal(other[k], ref[k], err_msg=f"{case}: {k} rank {r}")


def test_fused_step_updates_match_one_process(ranks):
    """Data 2 x space 4, 2 steps with warm optimizers at lr 1e-4 and exact
    BatchNorm: every updated parameter and statistic within 2% of the
    largest parameter move of one process (measured: 1.0%), and the DP
    vector within 2% of its largest entry."""
    case = "sp-fused"
    want = R.run_step_case(case)
    start = {f"s_{k}": v.numpy() for k, v in R.start_state(case)[1].state_dict().items()}
    got = _rank_results(ranks, case)[0]
    keys = [k for k in got if k.startswith("s_") and got[k].dtype.kind == "f"]
    move = max(np.abs(want[k] - start[k]).max() for k in keys if ".BatchNorm_0." not in k)
    gap = max(np.abs(got[k] - want[k]).max() for k in keys if ".BatchNorm_0." not in k)
    print(f"parameters: largest move {move:.3e}, gap {gap:.3e} ({gap / move:.2%})")
    assert move > 1e-5 and gap <= 0.02 * move, (gap, move)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0.02 * move, err_msg=k)
    dp = np.abs(want["dp"]).max()
    np.testing.assert_allclose(got["dp"], want["dp"], rtol=0, atol=0.02 * dp)


def test_strict_async_step_within_reordering_spread(ranks):
    """Strict out-of-line with async BatchNorm on data 4 x space 2, dropout
    0: CE and Dice at JAX's gate; the DP loss follows the update, which
    float32 rounding moves, so it is held to twice the largest gap of four
    row permutations on one process, measured here (`ROADMAP.md` §3; here
    both are a few float32 ulps: lr 1e-4 barely moves the DP loss)."""
    case = "sp-strict-async"
    want = R.run_step_case(case, steps=1)
    got = _rank_results(ranks, case)[0]
    np.testing.assert_allclose(got["m_ce_loss"], want["m_ce_loss"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["m_dice"], want["m_dice"], atol=DICE_ATOL, equal_nan=True)
    spread = max(abs(float(R.run_step_case(case, steps=1, perm=p)["m_dp_loss"]
                           - want["m_dp_loss"]))
                 for p in (np.arange(8)[::-1].copy(), np.array([1, 0, 3, 2, 5, 4, 7, 6]),
                           np.roll(np.arange(8), 3), np.random.RandomState(1).permutation(8)))
    gap = abs(float(got["m_dp_loss"] - want["m_dp_loss"]))
    print(f"strict async DP loss: {gap:.3e} from one process, reordering spread {spread:.3e}")
    assert gap <= 2 * spread, (gap, spread)
